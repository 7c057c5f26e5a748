"""xlstm_350m: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import XLSTM_350M as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
