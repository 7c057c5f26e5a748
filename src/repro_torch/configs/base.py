"""Model and run configuration of the LM scaffold — port of
``repro.configs.base`` (plain data, no JAX in either).

Every architecture is a ``ModelConfig`` (frozen, hashable) and every run
(arch x input shape) a ``RunConfig``.  Model code consumes them; the
registry in ``repro_torch.configs`` resolves them by name.  The fields,
defaults, ``param_count`` and ``smoke_variant`` are the reference's, so
one config drives both packages in a parity test.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds: each layer-group (scan unit) is a tuple of block kinds that is
# applied sequentially.  Uniform transformers use a period-1 pattern.
# ---------------------------------------------------------------------------
BlockKind = Literal[
    "attn_global",      # full (causal) attention
    "attn_local",       # sliding-window attention
    "mlstm",            # xLSTM matrix-memory block (parallelizable)
    "slstm",            # xLSTM scalar-memory block (scan)
    "rglru",            # RG-LRU gated linear recurrence (recurrentgemma)
]

MLPKind = Literal["swiglu", "geglu", "gelu", "moe"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # "ep": experts sharded over model axis (needs n_experts % model == 0)
    # "tp": expert d_ff sharded over model axis (few, fat experts: mixtral)
    partition: Literal["ep", "tp"] = "ep"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    # layer pattern: tuple of block kinds; layers = groups * len(pattern)
    pattern: Tuple[BlockKind, ...] = ("attn_global",)
    mlp: MLPKind = "swiglu"
    moe: Optional[MoEConfig] = None
    # attention details
    window_size: int = 0                   # sliding window for attn_local / SWA
    attn_logit_softcap: float = 0.0        # gemma2
    final_logit_softcap: float = 0.0       # gemma2
    qkv_bias: bool = False                 # qwen1.5
    rope_theta: float = 10_000.0
    rope: bool = True
    parallel_block: bool = False           # stablelm/gptj style attn+mlp in parallel
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-6
    post_block_norm: bool = False          # gemma2 uses pre+post norms
    tie_embeddings: bool = False
    embed_scale: bool = False              # gemma-style sqrt(d_model) embed scaling
    # modality frontend stub: if set, forward() accepts precomputed embeddings
    # (B, S, frontend_dim) in place of token ids for the first `frontend_len`
    # positions.  Backbone-only per assignment.
    frontend: Optional[str] = None         # "patch" (vlm) | "codec" (audio)
    # xLSTM specifics
    slstm_every: int = 0                   # 1 sLSTM block per `slstm_every` layers
    # RG-LRU specifics
    rglru_dim: int = 0                     # recurrence width (defaults d_model)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, h, kh, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        n_attn_like = 0
        n_rec = 0
        for kind in self.pattern:
            if kind in ("attn_global", "attn_local"):
                n_attn_like += 1
            else:
                n_rec += 1
        per_period = len(self.pattern)
        groups = self.n_groups
        attn_layers = n_attn_like * groups
        rec_layers = n_rec * groups
        attn_p = attn_layers * (d * h * hd + 2 * d * kh * hd + h * hd * d)
        if self.pattern.count("mlstm") or self.pattern.count("slstm"):
            # xlstm: qkv + gates + out per recurrent layer, roughly 4*d*d
            rec_p = rec_layers * 4 * d * d
        elif self.pattern.count("rglru"):
            rdim = self.rglru_dim or d
            rec_p = rec_layers * (2 * d * rdim + rdim * d + 3 * rdim)
        else:
            rec_p = 0
        if self.moe is not None:
            e = self.moe
            ff_p = self.n_layers * (
                e.n_experts * 3 * d * e.expert_d_ff
                + e.n_shared_experts * 3 * d * e.expert_d_ff
                + d * e.n_experts)
        else:
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            ff_p = self.n_layers * mult * d * self.d_ff
        embed_p = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return attn_p + rec_p + ff_p + embed_p

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        all_ff = self.n_layers * e.n_experts * 3 * self.d_model * e.expert_d_ff
        active_ff = self.n_layers * (e.top_k + e.n_shared_experts) * 3 * \
            self.d_model * e.expert_d_ff
        return total - all_ff + active_ff


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    # distribution knobs
    fsdp: bool = True                  # shard params over the data axis
    remat: Literal["none", "block", "full"] = "block"
    scan_layers: bool = True
    # decode: shard kv cache sequence over model axis when kv heads don't shard
    seq_shard_kv: bool = True
    # Megatron-style sequence-parallel residual stream (train/prefill)
    seq_parallel: bool = False
    microbatch: int = 0                # 0 = no gradient accumulation
    param_dtype: str = "bfloat16"
    # attention chunk sizes of the plain chunk-pair scan
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period = len(cfg.pattern)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), expert_d_ff=64)
    return dataclasses.replace(
        cfg,
        n_layers=2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        rglru_dim=64 if cfg.rglru_dim else 0,
    )
