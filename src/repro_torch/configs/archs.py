"""The ten architectures of the LM scaffold, with the reference's exact
configs (``repro.configs.archs``), each a module-level ``ModelConfig`` and
an entry of ``ARCHS``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig

# -- MoE -----------------------------------------------------------------------

MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    pattern=("attn_local",), window_size=4096,          # SWA per assignment
    mlp="moe",
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=16384, partition="tp"),
)

QWEN3_MOE_235B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=64,
    pattern=("attn_global",),
    mlp="moe",
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536, partition="ep"),
    rope_theta=1_000_000.0,
)

# -- dense ----------------------------------------------------------------------

PHI4_MINI = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064, head_dim=128,
    pattern=("attn_global",), mlp="swiglu",
)

QWEN15_110B = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152_064, head_dim=128,
    pattern=("attn_global",), mlp="swiglu", qkv_bias=True,
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256_000, head_dim=256,
    pattern=("attn_local", "attn_global"), window_size=4096,
    mlp="geglu", attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_block_norm=True, tie_embeddings=True, embed_scale=True,
)

STABLELM_12B = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100_352, head_dim=160,
    pattern=("attn_global",), mlp="swiglu", norm="layernorm",
    parallel_block=True,
)

# -- ssm ------------------------------------------------------------------------

# xLSTM[7:1]: 7 mLSTM blocks per sLSTM block (paper's flagship ratio).
XLSTM_350M = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    pattern=("mlstm",) * 7 + ("slstm",), mlp="swiglu", rope=False,
)

# -- vlm / audio (backbone only; stub frontends) -----------------------------------

LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    pattern=("attn_global",), mlp="swiglu", frontend="patch",
)

MUSICGEN_MEDIUM = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    pattern=("attn_global",), mlp="gelu", norm="layernorm",
    frontend="codec",
)

# -- hybrid ----------------------------------------------------------------------

# Griffin 1:2 attn:recurrent.  38 layers isn't divisible by a (rec,rec,attn)
# period, so the scan group is one period of 19 = 6x(rec,rec,attn) + rec,
# giving 26 recurrent : 12 local-attn over 2 groups (ratio 2.17:1).
_RG_PERIOD = (("rglru", "rglru", "attn_local") * 6 + ("rglru",))

RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256_000, head_dim=256,
    pattern=_RG_PERIOD, window_size=2048,
    mlp="geglu", tie_embeddings=True, embed_scale=True,
    rglru_dim=4096,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        MIXTRAL_8X22B, QWEN3_MOE_235B, PHI4_MINI, QWEN15_110B, GEMMA2_9B,
        STABLELM_12B, XLSTM_350M, LLAVA_NEXT_34B, MUSICGEN_MEDIUM,
        RECURRENTGEMMA_9B,
    ]
}

# archs with sub-quadratic (or recurrent) sequence mixing: run long_500k.
LONG_CONTEXT_OK = {
    "mixtral-8x22b",        # SWA everywhere
    "gemma2-9b",            # half local; global layers use seq-sharded KV
    "xlstm-350m",           # recurrent state, O(1) decode
    "recurrentgemma-9b",    # RG-LRU + local attn
}
