"""musicgen_medium: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import MUSICGEN_MEDIUM as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
