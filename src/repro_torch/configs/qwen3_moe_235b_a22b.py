"""qwen3_moe_235b_a22b: the full config (``CONFIG``) and its CPU smoke variant."""
from repro_torch.configs.archs import QWEN3_MOE_235B as CONFIG
from repro_torch.configs.base import smoke_variant

SMOKE = smoke_variant(CONFIG)
