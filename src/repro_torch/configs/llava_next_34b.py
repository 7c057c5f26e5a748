"""llava_next_34b: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import LLAVA_NEXT_34B as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
