"""recurrentgemma_9b: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import RECURRENTGEMMA_9B as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
