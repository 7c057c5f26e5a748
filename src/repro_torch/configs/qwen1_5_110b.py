"""qwen1_5_110b: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import QWEN15_110B as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
