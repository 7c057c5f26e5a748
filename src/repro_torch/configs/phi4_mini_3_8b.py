"""phi4_mini_3_8b: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import PHI4_MINI as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
