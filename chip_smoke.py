#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one JSON line each:

  1. device   the card (nvidia-smi name + power limit), device count
  2. build    every CUDA kernel built from the checkout's sources (one nvcc
              per source, all started together), with ptxas's registers,
              shared memory and spills; fails without HGMMA in K4's SASS
              (wgmma emitted) or with a spill in any kernel
  3. kernel   each of the four kernels (K1 fused band, K2 banded dot, K3
              Jaccard band, K4 local attention: bf16 on wgmma, f32
              scalar) against its plain PyTorch version on the card, at
              full size and at edge cases; times with CUDA events
              (median), beside the bound; K1-K3's effective TB/s and row
              tile; K2 timed beside torch.bmm of each row against a
              strided view of its successors; K4 at the
              model shapes timed in turns with the library calls
              flex_attention and (no softcap)
              scaled_dot_product_attention, the faster one its
              ``library_ms``
  4. bands    the kernel entry point ``kernels.ops`` on the system's own
              data: the 1.4M-record corpus in r=8 shards, each sorted;
              K2 -> cosine equals ``window.band_scores``, K1 equals
              w_cos*cos(K2) + w_jac*K3, and K1 timed against K2 + K3
  5. attention  ``kernels.ops.local_attn`` at one sliding-window layer of
              Mixtral-8x22B and of Gemma-2-9B (8k prefill, bf16)
  6. parity   resolve() on the card == the sequential host oracle, for
              srp/repsn/jobsn x scan/pallas at n=50,000 (cut from
              200,000 to keep the script inside its time limit)
  7. main     the resolve main path at full size: the paper's 1.4M-record
              corpus, w=10, r=8, repsn hops=7, vmap runner, balanced
              partitioner, pallas band engine, emit="pairs", the paper's
              cascade, auto caps — blocked pairs, zero overflow, kernel
              launches, and the matched set equal to the scan engine's;
              through the executable cache (``repro_torch.perf``): the
              cold resolve captures its shard program as a CUDA graph, the
              steady one replays it (``PerfStats``: hits, no miss, no
              trace; K1 counted once), and a profiled replay's kernel list
              holds K1; one steady resolve traced (``ERConfig.trace``):
              its sets equal the untraced run's, and its plan,
              shard-program, collection and frozenset seconds come from
              its spans; then the same resolve once with
              ``jit_cache=False`` (eager): equal sets, its seconds and
              peak memory beside the cached run's
  8. planned  the profile planners at full size: phase 7's corpus and
              config under pairrange and blocksplit (blocked and matched
              sets equal phase 7's), and the skewed Zipfian corpus of
              BENCH_balance.json at 1.4M records under uniform, blocksplit
              and pairrange with the default cosine + Jaccard matcher
              (blocked sets equal the sequential oracle, matches agree);
              the planned shard shape, imbalance, cold resolve seconds,
              one traced steady resolve per corpus (main/pairrange,
              zipf/uniform) taken apart by its spans, its device program
              beside phase 7's, and K1 timed at each planned shard shape
  9. quality  the quality harness at full size: a 1.4M-record labeled
              corpus (BENCH_recall.json's shape) resolved at fixed w=8,
              adaptive windows 4..12 with and without evidence pruning
              (K1 at window 11), and two-pass blocking (key, alt) at w=8;
              PC / PQ / RR / F against the gold pairs, the adaptive and
              multi-pass blocked sets against their host oracles
 10. stream   out-of-core streaming (``stream.resolve_stream``) of phase
              7's corpus and config, arriving as 8 host chunks of 175,000
              rows and resolved in 4 native chunks of 350,000 (the 1:4
              chunk-to-corpus ratio of BENCH_stream.json): the blocked and
              matched unions equal phase 7's sets, zero overflow, the
              chunk sorts and shard programs on the card; then the same
              call checkpointed and killed between chunk 2's spool and its
              commit (``FaultPlan``), resumed with ``api.resume`` to the
              same sets; all three runs traced: seconds of ingest, sort
              runs, merge, chunk resolves (shard programs, collection),
              commits and the union from their spans, one shard program
              in each chunk span, K1 once per shard program and at each
              shard shape, steady (replayed) chunks; spooled bytes, peak
              memory
 11. serve    online serving (``api.serve``) on the card: a traced
              service bootstrapped with 350,000 records of phase 7's
              generator and config, then 24 micro-batches of 200 inserts
              with a delete of 50 after every 4th (the reference's
              serving mix), half of them through the futures API; every
              result is the served sets' difference, K1 launched by
              every delta call (one shard_program span each), the served
              sets equal a fresh resolve of the live corpus, a snapshot
              restored on the card serves the same sets under the same
              pair ids; K1 held against its plain version at every delta
              shape; a trace only where a batch brings a new shape bucket,
              steady (replayed) batches, the delta calls' shard-program
              ms; bootstrap s, p50/p95 ms, inserts/s, peak memory
 12. shard_map  the shard_map runner on a world-size-1 NCCL mesh on the
              card: srp/repsn/jobsn x scan/pallas at n=50,000, r=1, equal
              to the vmap runner and the sequential oracle, K1 on every
              pallas shard program, the second call a graph replay
 13. lm       the LM scaffold's serving path (``repro_torch.models``,
              ``train.steps``): Gemma-2-9B as configured (full width, all
              42 layers, random bf16 weights from a seeded generator),
              ``make_prefill_step`` on a batch of 2 prompts of 28,672
              tokens into a 32,768-token cache, then 32 greedy
              ``make_decode_step`` steps; the 21 local layers of every
              prefill through K4 (``flash_attention``'s route), the 21
              global ones through the plain f32 chunk-pair scan; the
              prefill traced by torch.profiler (CUDA activity: K4's time
              in it) with its attention and MLPs timed by CUDA events;
              one decode step profiled; K4 held against the plain scan at one real
              layer's q, k, v and timed there beside its bound, in turns
              with compiled flex_attention (softcap as score_mod);
              prefill + decode against one forward (LM_CHECK_TOL); every
              logit finite
 14. train    the LM scaffold's training path (``train.steps``,
              ``train.optim``, ``train.checkpoint``, ``train.loop``,
              ``launch.train``): Phi-4-mini's 100m preset in f32, two
              train steps on the card against the same two on the CPU;
              ``launch.train.main`` at --preset 100m --dedup on the card
              under deterministic algorithms, straight, with a fault
              injected, and killed then resumed (--resume), the three
              ending on one checkpoint bit for bit, the loss falling;
              Phi-4-mini at full width and depth (bf16, a 4,096-token
              sequence, remat="block"): cold step, timed steps, one split
              by CUDA events (forward + backward, optimizer), one
              profiled; finite losses, the first update lowering the
              repeated batch's loss, the step-0 loss against an f32
              forward on the same weights
              (TRAIN_BF16_LOSS_TOL); no kernel launched (K4 has no
              backward: training takes the plain scan)
 15. shard    the sharding rules on a world-size-1 NCCL (1, 1) mesh:
              Gemma-2-9B's one-period prefill with and without rules
              (K4 once per local layer), Qwen3-MoE-235B-A22B trained at
              full width on one layer through the capacity dispatch
 16. dryrun   the dry run (``repro_torch.launch.dryrun``): DRYRUN_CELLS
              traced on the production meshes (fake CUDA tensors on a
              512-rank fake group) by its CLI in background processes
              started after phase 1, each to status "ok" and Gemma-2's
              prefill_32k holding one K4 op per local layer; phase 15's
              two steps dry-run on the (1, 1) mesh and then run for real:
              op counts, dot and kernel FLOPs and argument bytes equal,
              K4 ops traced = K4 launched, the predicted peak within
              DRYRUN_MEM_RTOL of max_memory_allocated; the deprecated
              ``core.pipeline`` shims at N_PARITY equal to the resolve;
              then the process holds neither JAX nor the reference

Phases 4, 5 and 7-14 each set every launch count to 0 just before they
drive their path and read the counts just after; each raises if a kernel
of its path was not launched, phases 8 and 9 if K1 was not launched on
every resolve (every pass of a multi-pass one), phase 10 if it was not
launched on every chunk it resolved, phase 11 if it was not launched
on every delta call, phase 12 if not on every pallas shard program, and
phase 13 unless K4 ran 21 times in each of its K4-routed prefill calls,
and phase 14 if any kernel was launched; phases 15 and 16 count their
prefills' K4 launches (one per local layer).
A replayed CUDA graph launches without the host: the cache adds the
launches its capture recorded on every replay, so the counts hold for
replays too.  Phases 7-14 start from an empty executable cache and raise
if they reserved more than RESERVED_CAP bytes of device memory.  Then
come each phase's seconds, the kernel table ``{"kernels": [...]}``,
the card line, and the last line ``{"ok": true, "device": {...}}``.  Every
phase raises on failure, so the script exits non-zero and prints no result
line.  It exits non-zero without a CUDA card, and where ``src/repro_torch``
is not beside it.  Every gate reads a public pair set's packed uint64
form (its ``PairSet``'s own array, through ``pack_pair_set``) instead of
packing its tuples.

TF32 is switched off for matmuls and cuDNN (the cascade gate's slack is
GATE_EPS = 1e-5, K4's f32 tolerance 2e-5; the kernels use plain IEEE f32
FMAs).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, f32 (non-tensor) ops/s
# and bf16 tensor-core ops/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
BOUND_BASIS = ("H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32 "
               "non-tensor, 989 TFLOP/s bf16 dense tensor")

N_FULL = 1_400_000          # paper §5.1: 1.4M publication records
N_PARITY = 50_000          # cut from 200,000: the script's time limit
N_KEYS = 26 ** 3            # three-letter title-prefix keys
W, R, HOPS = 10, 8, 7
# BENCH_balance.json's skewed corpus (zipf_entities), at the paper's scale
ZIPF = dict(n_clusters=256, exponent=1.0, dup_frac=0.2)
# BENCH_recall.json's labeled corpus and windows, at the paper's scale
RECALL = dict(max_cluster=12, typo_rate=0.1)
W_BASE, W_FIXED, W_MAX, PRUNE = 4, 8, 12, 0.55
# phase planned: the one planner per corpus whose steady resolve is traced
# and profiled (_breakdown); the others run their cold resolve and gates
PLANNED_TRACED = {"main": "pairrange", "zipf": "uniform"}
# phase stream: input chunks in generator order, native chunk width
STREAM_INPUT, STREAM_CHUNK = 175_000, 350_000
# phase serve: base corpus (cut from 1.4M, see its ``reduced``) and the
# reference's serving mix (benchmarks/bench_sn.py::serve_body)
SERVE_BASE = 350_000
SERVE_OPS, SERVE_BATCH, SERVE_DELETE = 24, 200, 50
KERNEL_TOL = 1e-5           # tests/test_kernels.py's fused-band tolerance
# tests/test_kernels.py's (rtol, atol) for K2-K4, held at the edge cases
TOL = {"banded_sim/f32": (1e-5, 1e-4), "banded_sim/bf16": (2e-2, 2e-1),
       "jaccard_band": (1e-6, 1e-6),
       "local_attn/f32": (2e-5, 2e-5), "local_attn/bf16": (3e-2, 3e-2)}
# K4 bf16 at the model shapes (window 4096): outputs are ~0.03, so the
# edge cases' 3e-2 would pass an error the size of the value.  Kernel and
# plain version both accumulate in f32 and round once to bf16, so they
# differ by at most one bf16 ulp (<= 2**-7 of the value): rtol 1e-2, and
# atol 2e-3, twice the largest error read at these shapes (9.8e-4).
TOL_ATTN_MODEL = (1e-2, 2e-3)
# K4 at full size: one sliding-window layer's query heads at an 8k prefill
# (src/repro/configs/archs.py): (label, BH, S, D, window, softcap)
ATTN_SHAPES = (("mixtral-8x22b", 48, 8192, 128, 4096, 0.0),
               ("gemma2-9b", 16, 8192, 256, 4096, 50.0))
ATTN_HEADS_CHECKED = 4      # the plain K4 materializes (heads, S, S) f32
# cuda_ms's spin before each timed call: ~1 ms at the H100's 1.98 GHz
SPIN_CYCLES = 2_000_000
# no phase may reserve more device memory than this at its peak (the kept
# graphs' pools included): the card's 80 GB less headroom
RESERVED_CAP = 64e9
# phase lm: Gemma-2-9B as configured (full width, all 42 layers, bf16
# weights from a seeded generator), served at batch 2 (cut from
# prefill_32k's 32 and decode_32k's 128: one card holds the 18.5 GB model
# plus an 11.3 GB global KV cache at batch 2) with a prompt of 7 windows
# (28,672 tokens) into decode_32k's 32,768-token cache, then 32 greedy
# decode steps
LM_ARCH, LM_SEED = "gemma2-9b", 19
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 28_672, 32
# the cache-semantics check: a prefill of LM_CHECK_PROMPT tokens plus
# LM_CHECK_DECODE decode steps against one forward over all of them (both
# sides through K4), at batch 1 (the forward's f32 logits are 8.65 GB)
LM_CHECK_BATCH, LM_CHECK_PROMPT, LM_CHECK_DECODE = 1, 8_192, 256
# bound on |decode logits - forward logits| at bf16 through 42 layers:
# the logits are bf16 matmul outputs of magnitude ~1-5 (one bf16 ulp is
# 2**-6 at 2-4) and the two paths round attention differently (K4 / the
# f32 scan against the f32 decode attention); set above the drift read on
# the card (PERF.md §6) with room
LM_CHECK_TOL = 0.25
# phase train: Phi-4-mini (the train launcher's default arch), three parts.
# (1) card against CPU: the launcher's 100m preset in f32, 2 train steps
# on the launcher's batch shape, both devices from one seeded state
TRAIN_ARCH, TRAIN_SEED = "phi4-mini-3.8b", 20
TRAIN_BATCH, TRAIN_SEQ, TRAIN_PARITY_STEPS = 8, 256, 2
# card against CPU after 2 f32 steps: the loss and grad norm are sums of
# the same f32 products in another order (rel 1e-5 read as ~1e-6 on the
# CPU against XLA); a param moves by lr x an Adam step g / (|g| + eps),
# which differs by ~lr x (relative gradient error) except where |g| is
# within rounding of eps: there it may take any value up to the largest
# step, so TRAIN_FLIP_SHARE of the params may lie beyond TRAIN_PARAM_ATOL
# (but within 2.2 x the summed lr); the moments within TRAIN_MOMENT_RTOL
# of their leaf's largest entry
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL = 1e-5, 1e-4
TRAIN_PARAM_ATOL, TRAIN_FLIP_SHARE, TRAIN_MOMENT_RTOL = 1e-6, 1e-4, 1e-3
# (2) the launcher end to end at --preset 100m --dedup: 30 steps with a
# checkpoint every 10; once more with a fault injected at step 15; once
# killed after step 20 (its checkpoint written) and resumed with --resume
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT, TRAIN_KILL_AFTER = \
    30, 10, 15, 20
# (3) Phi-4-mini at full width and depth (src/repro/configs/archs.py,
# 4,450,418,688 parameters), bf16 weights from a seeded generator, on
# train_4k's sequence of 4,096 at batch 1 (cut from its global batch of
# 256); one cold step, then TRAIN_FULL_STEPS timed steps of one repeated
# batch and one profiled step
TRAIN_FULL_SEQ, TRAIN_FULL_BATCH, TRAIN_FULL_STEPS = 4096, 1, 4
# |bf16 step-0 loss - f32 forward loss| on the same weights and batch:
# below one bf16 ulp of the loss (~12.8 at random weights: 2**-4)
TRAIN_BF16_LOSS_TOL = 0.05
# phase shard: the LM scaffold's sharded half on a world-size-1 NCCL mesh
# (1, 1) ("data", "model") with Rules(mesh, fsdp=True), whose layouts are
# whole tensors: they stay plain tensors (no DTensor dispatch), and the
# rules' functions (the one-hot embedding, the MoE's capacity dispatch)
# run on them; the DTensor path is held on four CPU ranks by the tests
# (tests/test_torch_sharded.py).  (1) Gemma-2-9B at
# full width cut to one pattern period (one local and one global layer),
# bf16 weights from a seeded generator, an 8,192-token prefill at batch 1
# through make_prefill_step with the rules and without, on the same
# params: equal next tokens, the last position's logits within
# SHARD_LOGIT_TOL (the rules path embeds as one-hot @ table, exact in bf16
# with f32 accumulation, and runs the same local ops on the (1, 1) mesh:
# any gap is reduction-order noise, far below one bf16 ulp of the logits
# (2**-4 at |logit| in [8, 16), the final softcap bounding them by 30), and
# K4 once per local layer per prefill
SHARD_LM_ARCH, SHARD_SEED, SHARD_PROMPT = "gemma2-9b", 21, 8192
SHARD_LOGIT_TOL = 0.125
# (2) Qwen3-MoE-235B-A22B at full width (d_model 4,096, 64 heads, 4 KV
# heads, 128 experts, top-8, expert_d_ff 1,536, vocab 151,936 untied, EP
# partition) cut to one layer (its pattern period), bf16 weights from a
# seeded generator, on train_4k's sequence of 4,096 at batch 1.  The
# capacity dispatch at capacity_factor = n_experts / top_k (capacity = the
# token count: nothing drops) against the single-device oracle
# (rules=None): bf16 outputs of the same products, rounded in other
# places (einsum over capacity buffers against one matmul per expert, the
# weighted sum in another order): within SHARD_DISPATCH_RTOL of the
# oracle's largest entry (~5 bf16 ulps of it); two train steps with the
# rules, the step-0 loss against lm_loss(rules) on the same bf16 params
# before the update: the same forward, remat and grad mode aside, so
# within SHARD_LOSS_TOL (the f32 scatter-adds' atomics reorder sums).
# And the loss with the rules at the no-drop capacity factor against
# lm_loss(rules=None), the single-device path (a gather for the one-hot
# embedding, the oracle for the dispatch) on the same params: the two
# differ only by the MoE output's rounding (the dispatch gate above),
# which reaches the mean loss over 4,096 tokens through the residual,
# the final norm and the head as noise: within SHARD_ORACLE_LOSS_TOL
# (under 0.1% of the ~12.7 loss at random weights)
SHARD_MOE_ARCH, SHARD_MOE_SEQ = "qwen3-moe-235b-a22b", 4096
SHARD_DISPATCH_RTOL, SHARD_LOSS_TOL = 2e-2, 1e-3
SHARD_ORACLE_LOSS_TOL = 1e-2
# the delta calls' mean shard_program ms in phase serve of an earlier
# version of this script, when every program ran eagerly (PERF.md §5);
# a constant, printed beside this run's readings, never measured here
SERVE_PROGRAM_MS_EAGER_EARLIER = 12.6
# phase dryrun: (1) cells of the dry run (``repro_torch.launch.dryrun``)
# traced on the production meshes of a 512-rank fake process group with
# fake CUDA tensors: one of each kind on the single-pod mesh (Gemma-2's
# prefill puts K4's op in the trace) and one on the multi-pod mesh,
# chosen by their trace times (PERF.md §4)
DRYRUN_CELLS = (("gemma2-9b", "prefill_32k", "single"),
                ("phi4-mini-3.8b", "train_4k", "single"),
                ("gemma2-9b", "decode_32k", "single"),
                ("qwen3-moe-235b-a22b", "decode_32k", "multi"))
CARD_BYTES = 80e9           # the H100's device memory, for the cells' lines
DRYRUN_WAIT_S = 1000        # the cells' processes, from their start
# (2) phase shard's two full-width steps dry-run on the card's (1, 1) mesh
# and then run for real: the predicted peak (arguments + temporaries)
# within DRYRUN_MEM_RTOL of the measured max_memory_allocated less what
# was allocated before the step's inputs
DRYRUN_MEM_RTOL = 0.10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call).
    Each call is queued behind a spin of SPIN_CYCLES on the stream, so the
    start event is reached once the host has launched the call: without
    it an idle card stamps the start at once and the host's launch work
    (tens of microseconds, varying with the host) is counted."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall(fn):
    """(result, seconds) of host work that ends in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device():
    import numpy as np
    import torch
    smi = nvidia_smi()
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "numpy": np.__version__}
    emit(info)
    return info


def _spill_bytes(log: str) -> int:
    """Bytes of spill stores and loads over every kernel in a ptxas -v
    log ("N bytes spill stores, M bytes spill loads")."""
    import re
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))


def _sass_count(lib, opcode) -> int:
    """How often ``opcode`` appears in the SASS of a built library
    (cuobjdump from the toolkit beside nvcc)."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sass.count(opcode)


def phase_build():
    """Every kernel built; raises unless K4's SASS holds HGMMA (wgmma was
    emitted) and no instantiation of any kernel spills."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    total = time.perf_counter() - t0
    spills = {name: _spill_bytes(b.log) for name, b in built.items()}
    hgmma = _sass_count(built["local_attn"].path, "HGMMA")
    emit({"phase": "build", "seconds": round(total, 3),
          "local_attn_sass_hgmma": hgmma, "spill_bytes": spills,
          "kernels": {name: {"seconds": round(b.seconds, 3),
                             "ptxas": [ln.strip() for ln in b.log.splitlines()
                                       if "registers" in ln or "smem" in ln
                                       or "spill" in ln
                                       or "Compiling entry" in ln]}
                      for name, b in built.items()}})
    if not hgmma:
        raise AssertionError("local_attn: no HGMMA in the SASS")
    if any(spills.values()):
        raise AssertionError(f"kernels spill registers: {spills}")


def _band_inputs(s, m, f, words, seed, *, zero_sig=False):
    """Random unit feature rows and signatures with planted near-duplicate
    neighbours (so both halves of the score reach high values)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    feat = torch.randn((s, m, f), generator=g, device="cuda")
    feat /= feat.norm(dim=-1, keepdim=True) + 1e-9
    sig = torch.randint(-2**31, 2**31 - 1, (s, m, words), generator=g,
                        device="cuda", dtype=torch.int32)
    dup = torch.randint(0, m - 1, (m // 10,), generator=g, device="cuda")
    feat[:, dup + 1] = feat[:, dup]
    sig[:, dup + 1] = sig[:, dup]
    if zero_sig:
        sig.zero_()
    return feat.contiguous(), sig.contiguous()


def _check_band(feat, sig, window, w_cos, w_jac, label):
    from repro_torch.kernels import ops
    kw = dict(window=window, w_cos=w_cos, w_jac=w_jac)
    return _hold("fused_band", ops.fused_cheap_band(feat, sig, **kw),
                 ops.fused_cheap_band_ref(feat, sig, **kw), (0.0, KERNEL_TOL),
                 label)


def _kernel_fused_band(feat, sig):
    """K1 against its plain version at the main path's shapes and at edge
    cases; times at the main shape."""
    from repro_torch.kernels import ops
    s, m, f = feat.shape
    words, window = sig.shape[2], W - 1
    errs = {"main": _check_band(feat, sig, window, 0.25, 0.25, "main")}
    edge = [  # (label, S, M, F, W, window, w_cos, w_jac, zero_sig)
        ("m_not_tile_multiple", 3, 1000, 32, 8, 9, 0.5, 0.5, False),
        ("cos_only_sig_dummy", 2, 777, 32, 1, 9, 1.0, 0.0, False),
        ("jac_only_feat_dummy", 2, 777, 1, 8, 9, 0.0, 2.0, False),
        ("all_zero_signatures", 2, 513, 32, 8, 9, 0.5, 0.5, True),
        ("window_eq_band_block", 2, 700, 32, 8, 256, 0.5, 0.5, False),
        ("m_below_window", 1, 5, 32, 8, 9, 0.5, 0.5, False),
        # spans not 16-byte aligned (4-byte loads, scalar store head/tail)
        ("f33_w3_unaligned", 2, 1001, 33, 3, 9, 0.5, 0.5, False),
        ("window7", 2, 1000, 32, 8, 7, 0.5, 0.5, False),
        # rows wider than the registers hold (read from shared memory)
        ("f64_w16_wide_rows", 2, 999, 64, 16, 9, 0.5, 0.5, False),
        # phase quality's adaptive band (window_max 12) on planned shards
        ("adaptive_window11", R, 178_000, 32, 8, W_MAX - 1, 0.5, 0.5,
         False),
    ]
    for label, es, em, ef, ew, ewin, wc, wj, zs in edge:
        ef_, es_ = _band_inputs(es, em, max(ef, 2), max(ew, 1), 1,
                                zero_sig=zs)
        ef_ = ef_[..., :ef].contiguous()
        es_ = es_[..., :ew].contiguous()
        errs[label] = _check_band(ef_, es_, ewin, wc, wj, label)

    run = lambda: ops.fused_cheap_band(feat, sig, window=window,
                                       w_cos=0.25, w_jac=0.25)
    plain = lambda: ops.fused_cheap_band_ref(feat, sig, window=window,
                                             w_cos=0.25, w_jac=0.25)
    kernel_ms = cuda_ms(run, reps=50)
    plain_ms = cuda_ms(plain, reps=5, warm=1)
    n_bytes = feat.numel() * 4 + sig.numel() * 4 + s * m * window * 4
    rec = {"phase": "kernel", "name": "fused_band",
           "shape": {"S": s, "M": m, "F": f, "W": words, "window": window},
           "rows": ops._band_rows("fused_band", window, (f, words), (1, 1)),
           "max_abs_err": errs, "tol": KERNEL_TOL,
           "ms": kernel_ms, "plain_ms": plain_ms,
           "effective_tb_per_s": n_bytes / kernel_ms / 1e9,
           **_bound(n_bytes,
                    _band_pairs(s, m, window) * (2 * f + 6 * words),
                    F32_OPS_PER_S),
           "library_ms": None}
    emit(rec)
    return rec


def _hold(name, got, want, tol, label) -> float:
    """Max abs error of a kernel's result against its plain version; raises
    where |got - want| > atol + rtol*|want|, on a non-finite value, or on a
    shape or dtype mismatch."""
    import torch
    torch.cuda.synchronize()
    rtol, atol = tol
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {label}: {tuple(got.shape)} "
                             f"{got.dtype} vs plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not got.numel():
        return 0.0
    g, w = got.float(), want.float()
    err = (g - w).abs()
    worst = float(err.max())
    if not bool(torch.isfinite(g).all()) or \
            bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name} {label}: max abs err {worst} beyond "
                             f"rtol {rtol}, atol {atol}")
    return worst


def _randn(shape, seed, dtype=None):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda")
    return x if dtype is None else x.to(dtype)


def _bound(n_bytes, n_ops, ops_per_s) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate for their type."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return {"bytes": n_bytes, "ops": n_ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_basis": BOUND_BASIS}


def _band_pairs(s, m, window) -> int:
    return s * (m * window - window * (window + 1) // 2)


def _bmm_band(feat, window):
    """K2's library yardstick: one ``torch.bmm`` of each row of the
    flattened (S*M, F) rows against an ``as_strided`` view of its
    ``window`` successors (batch stride F, no copy of the view), never on
    a path of the port.  Outside the timed call the rows are laid out with
    ``window`` zero rows after them, so the last rows have successors too,
    and the band zeroes the slots whose partner lies in the next shard.
    Returns (call, band of its result)."""
    import torch
    s, m, f = feat.shape
    x = torch.cat([feat.reshape(s * m, f),
                   feat.new_zeros((window, f))])
    succ = x.as_strided((s * m, window, f), (f, f, 1), f)
    own = x[:s * m].unsqueeze(-1)
    call = lambda: torch.bmm(succ, own)

    def band(out):
        i = torch.arange(m, device=feat.device)[:, None]
        d = torch.arange(window, device=feat.device)
        return torch.where(i + 1 + d < m, out.reshape(s, m, window), 0.0)
    return call, band


def _library_bmm(feat, window, kernel_out):
    """(ms, record) of K2's ``torch.bmm`` yardstick at the main shape:
    whether PyTorch copied the strided view (the call's peak memory over
    its output), and its band's max abs error against the kernel's."""
    import torch
    try:
        call, band = _bmm_band(feat, window)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - \
            out.numel() * out.element_size()
        err = float((band(out) - kernel_out).abs().max())
        del out
        ms = cuda_ms(call, reps=20)
    except RuntimeError as e:        # the call cannot run at this shape
        torch.cuda.empty_cache()
        return None, {"call": "torch.bmm", "error": str(e)[:200]}
    view_bytes = feat.numel() * feat.element_size() * window
    return ms, {"call": "torch.bmm over an as_strided view of the "
                        "successors", "ms": ms,
                "extra_bytes_allocated": extra,
                "copied_view": extra >= view_bytes // 2,
                "max_abs_err_vs_kernel": err}


def _kernel_banded_sim(feat):
    """K2 against its plain version at the main shape (f32) and at the edge
    cases of tests/test_kernels.py (bf16 among them) and of its staged
    loads (a span not 16-byte aligned, rows wider than the registers);
    times at the main shape, beside its torch.bmm yardstick."""
    import torch
    from repro_torch.kernels import ops, ref
    s, m, f = feat.shape
    window = W - 1
    k2 = ops.banded_dot_band(feat, window=window)
    errs = {"main": _hold("banded_sim", k2,
                          ref.banded_sim_ref(feat, window=window),
                          TOL["banded_sim/f32"], "main")}
    edge = [  # (label, S, M, F, window, dtype)
        ("m_not_tile_multiple", 3, 1000, 32, 9, torch.float32),
        ("window_eq_band_block", 1, 700, 32, 256, torch.float32),
        ("m_below_window", 1, 8, 16, 16, torch.float32),
        ("f256_window200", 1, 1024, 256, 200, torch.float32),
        ("bf16", 8, 1000, 32, 9, torch.bfloat16),
        ("bf16_f128_window200", 1, 1024, 128, 200, torch.bfloat16),
        # span not 16-byte aligned (element loads, scalar store head/tail)
        ("f33_unaligned", 2, 1001, 33, 9, torch.float32),
        # rows wider than the registers hold (read from shared memory)
        ("f64_wide_rows", 2, 999, 64, 9, torch.float32),
    ]
    for label, es, em, ef, ewin, dt in edge:
        x = _randn((es, em, ef), 4, dt)
        tol = TOL["banded_sim/bf16" if dt == torch.bfloat16
                  else "banded_sim/f32"]
        errs[label] = _hold("banded_sim", ops.banded_dot_band(x, window=ewin),
                            ref.banded_sim_ref(x, window=ewin), tol, label)
    ms = cuda_ms(lambda: ops.banded_dot_band(feat, window=window), reps=50)
    plain_ms = cuda_ms(lambda: ref.banded_sim_ref(feat, window=window),
                       reps=5, warm=1)
    library_ms, library = _library_bmm(feat, window, k2)
    del k2
    n_bytes = feat.numel() * 4 + s * m * window * 4
    rec = {"phase": "kernel", "name": "banded_sim",
           "shape": {"S": s, "M": m, "F": f, "window": window,
                     "dtype": "float32"},
           "rows": ops._band_rows("banded_sim", window, (f,)),
           "max_abs_err": errs, "tol": {k: v for k, v in TOL.items()
                                        if k.startswith("banded_sim")},
           "ms": ms, "plain_ms": plain_ms,
           "effective_tb_per_s": n_bytes / ms / 1e9,
           **_bound(n_bytes, _band_pairs(s, m, window) * 2 * f,
                    F32_OPS_PER_S),
           "library_ms": library_ms, "library": library}
    emit(rec)
    return rec


def _kernel_jaccard_band(sig):
    """K3 against its plain version at the main shape (bit for bit: integer
    counts and one IEEE division) and at edge cases (all-zero signatures
    give 0.0; a span not 16-byte aligned); times at the main shape."""
    import torch
    from repro_torch.kernels import ops, ref
    s, m, words = sig.shape
    window = W - 1
    tol = TOL["jaccard_band"]
    k3 = ops.jaccard_band(sig, window=window)
    want = ref.jaccard_band_ref(sig, window=window)
    errs = {"main": _hold("jaccard_band", k3, want, tol, "main")}
    if not torch.equal(k3, want):
        raise AssertionError("jaccard_band: main shape not bit-equal to its "
                             "plain version")
    del k3, want
    edge = [  # (label, S, M, W, window, all-zero signatures)
        ("m130_words2", 1, 130, 2, 8, False),
        ("words16", 1, 192, 16, 32, False),
        ("m_below_window", 1, 8, 4, 16, False),
        ("window_eq_band_block", 1, 700, 8, 256, False),
        ("all_zero_signatures", 2, 513, 8, 9, True),
        # span not 16-byte aligned (4-byte loads, scalar store head/tail)
        ("words3_unaligned", 2, 1001, 3, 9, False),
    ]
    for label, es, em, ew, ewin, zero in edge:
        _, x = _band_inputs(es, max(em, 2), 2, ew, 5, zero_sig=zero)
        x = x[:, :em].contiguous()
        got = ops.jaccard_band(x, window=ewin)
        errs[label] = _hold("jaccard_band", got,
                            ref.jaccard_band_ref(x, window=ewin), tol, label)
        if zero and bool(got.any()):
            raise AssertionError("jaccard_band: empty vs empty is not 0.0")
    ms = cuda_ms(lambda: ops.jaccard_band(sig, window=window), reps=50)
    plain_ms = cuda_ms(lambda: ref.jaccard_band_ref(sig, window=window),
                       reps=5, warm=1)
    n_bytes = sig.numel() * 4 + s * m * window * 4
    # per word-pair: and, popcount, add (the union comes by inclusion-
    # exclusion from each row's count; int32, counted at the f32
    # non-tensor rate)
    rec = {"phase": "kernel", "name": "jaccard_band",
           "shape": {"S": s, "M": m, "W": words, "window": window},
           "rows": ops._band_rows("jaccard_band", window, (words,)),
           "max_abs_err": errs, "tol": tol,
           "ms": ms, "plain_ms": plain_ms,
           "effective_tb_per_s": n_bytes / ms / 1e9,
           **_bound(n_bytes, _band_pairs(s, m, window) * 3 * words,
                    F32_OPS_PER_S),
           "library_ms": None}
    emit(rec)
    return rec


def _kept_pairs(bh, s, window) -> int:
    """(query, key) pairs the window keeps: sum over qp of min(qp+1, w)."""
    w = min(window, s)
    return bh * (w * (w + 1) // 2 + (s - w) * w)


def _attn_plain(q, k, v, window, softcap):
    """The plain K4 over all heads, ATTN_HEADS_CHECKED heads at a time (its
    (heads, S, S) scores would not fit the card at once)."""
    import torch
    from repro_torch.kernels import ref
    h = ATTN_HEADS_CHECKED
    return torch.cat([ref.local_attention_ref(
        q[i:i + h], k[i:i + h], v[i:i + h], window=window, softcap=softcap)
        for i in range(0, q.shape[0], h)])


def _sdpa(q, k, v, window):
    """The library yardstick: scaled_dot_product_attention with the boolean
    band mask (never on a path of the port)."""
    import torch
    import torch.nn.functional as F
    s = q.shape[1]
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                  attn_mask=mask)[0]


def _flex(q, k, v, window, softcap):
    """The library yardstick that also takes the softcap: flex_attention,
    compiled, with the band as a block mask and the cap as a score_mod
    (never on a path of the port).  None where this torch has none."""
    import torch
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
    except ImportError:
        return None
    s = q.shape[1]
    band = create_block_mask(
        lambda b, h, qi, ki: (ki <= qi) & (qi - ki < window),
        B=None, H=None, Q_LEN=s, KV_LEN=s, device=q.device)
    cap = (lambda score, b, h, qi, ki:
           softcap * torch.tanh(score / softcap)) if softcap else None
    fn = torch.compile(flex_attention, dynamic=False)
    q4, k4, v4 = (x.unsqueeze(0) for x in (q, k, v))
    return lambda: fn(q4, k4, v4, score_mod=cap, block_mask=band)[0]


def _library_err(run, out, h):
    """Max abs error of a library yardstick ``run`` against the kernel's
    first h heads; None where there is no such call."""
    if run is None:
        return None
    return float((run()[:h].float() - out[:h].float()).abs().max())


def _in_turns(fns, reps=20):
    """Median ms of each named call, timed in turns: each in order, then
    each in reverse (kernel, library, library, kernel), so that a drift of
    the card's clock falls on both.  {name: [ms, ms]}."""
    order = list(fns) + list(reversed(fns))
    out = {name: [] for name, _ in fns}
    for name, fn in order:
        out[name].append(cuda_ms(fn, reps=reps))
    return out


def _must_reject(name, got, wrong, tol, label) -> float:
    """Max abs error of ``got`` against a deliberately wrong plain result;
    raises unless ``tol`` rejects it, so a tolerance shown to pass the
    kernel is also shown to fail a kernel with that fault."""
    rtol, atol = tol
    g, w = got.float(), wrong.float()
    err = (g - w).abs()
    if not bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name} {label}: tolerance {tol} does not "
                             f"reject the faulty plain result (max abs err "
                             f"{float(err.max())})")
    return float(err.max())


def _kernel_local_attn():
    """K4 against its plain version at the edge cases of
    tests/test_kernels.py and the tensor-core kernel's corners (f32 through
    the scalar kernel, bf16 through the wgmma kernel) and at the two model
    shapes (bf16; the first ATTN_HEADS_CHECKED heads compared, heads being
    independent, at TOL_ATTN_MODEL, which must also reject the plain
    version with its window one key short).  At the model shapes K4 is
    timed in turns with flex_attention and (no softcap) SDPA; the faster
    of them is its ``library_ms``."""
    import torch
    from repro_torch.kernels import ops, ref
    errs = {}
    edge = [  # (label, BH, S, D, window, softcap)
        ("bh4_w128", 4, 512, 64, 128, 0.0),
        ("d128_w256", 2, 1024, 128, 256, 0.0),
        ("window_not_block_multiple", 2, 512, 64, 100, 0.0),
        ("window_eq_s", 1, 256, 128, 256, 0.0),
        ("bh3_w384", 3, 768, 64, 384, 0.0),
        ("softcap", 2, 256, 64, 128, 20.0),
        ("window_over_s_ragged_tile", 1, 100, 64, 1000, 0.0),
        ("d256_softcap", 2, 512, 256, 300, 50.0),
        ("window_1", 2, 256, 128, 1, 0.0),
        ("d256_s200_softcap", 2, 200, 256, 150, 30.0),
    ]
    for label, bh, s, d, window, cap in edge:
        for dt, key in ((torch.float32, "local_attn/f32"),
                        (torch.bfloat16, "local_attn/bf16")):
            q, k, v = (_randn((bh, s, d), 6 + j, dt) for j in range(3))
            errs[f"{label}/{key.split('/')[1]}"] = _hold(
                "local_attn",
                ops.local_attn(q, k, v, window=window, softcap=cap),
                ref.local_attention_ref(q, k, v, window=window,
                                        softcap=cap), TOL[key], label)
    shapes = []
    h = ATTN_HEADS_CHECKED
    for label, bh, s, d, window, cap in ATTN_SHAPES:
        q, k, v = (_randn((bh, s, d), 9 + j, torch.bfloat16)
                   for j in range(3))
        run = lambda: ops.local_attn(q, k, v, window=window, softcap=cap)
        out = run()
        want = ref.local_attention_ref(q[:h], k[:h], v[:h], window=window,
                                       softcap=cap)
        errs[label] = _hold("local_attn", out[:h], want, TOL_ATTN_MODEL,
                            label)
        short_err = _must_reject(
            "local_attn", out[:h], ref.local_attention_ref(
                q[:h], k[:h], v[:h], window=window - 1, softcap=cap),
            TOL_ATTN_MODEL, f"{label} against window - 1")
        plain_ms = cuda_ms(lambda: _attn_plain(q, k, v, window, cap),
                           reps=3, warm=1)
        flex = _flex(q, k, v, window, cap)
        sdpa = None if cap else _sdpa(q, k, v, window)
        flex_err = _library_err(flex, out, h)
        sdpa_err = _library_err(sdpa, out, h)
        fns = [("kernel", run)] + [(n, fn) for n, fn in
                                   (("flex_attention", flex), ("sdpa", sdpa))
                                   if fn is not None]
        turns = _in_turns(fns)
        ms = statistics.mean(turns["kernel"])
        flex_ms = statistics.mean(turns["flex_attention"]) \
            if flex is not None else None
        sdpa_ms = statistics.mean(turns["sdpa"]) if sdpa is not None \
            else None
        # the library yardstick is the faster of the calls timed
        libs = [(t, n) for t, n in
                ((flex_ms, "flex_attention (compiled)"),
                 (sdpa_ms, "scaled_dot_product_attention (bool band mask)"))
                if t is not None]
        library_ms, library = min(libs) if libs else (None, None)
        shapes.append({
            "model": label, "shape": {"BH": bh, "S": s, "D": d,
                                      "window": window, "softcap": cap,
                                      "dtype": "bfloat16"},
            "kept_pairs": _kept_pairs(bh, s, window),
            "ms": ms, "plain_ms": plain_ms, "turns_ms": turns,
            **_bound(4 * bh * s * d * 2, _kept_pairs(bh, s, window) * 4 * d,
                     BF16_OPS_PER_S),
            "library_ms": library_ms, "library": library,
            "sdpa_ms": sdpa_ms, "sdpa_vs_kernel_max_abs_err": sdpa_err,
            "flex_attention_ms": flex_ms,
            "flex_vs_kernel_max_abs_err": flex_err,
            "window_minus_1_max_abs_err": short_err})
        del q, k, v, out, want
        torch.cuda.empty_cache()
    rec = {"phase": "kernel", "name": "local_attn", "max_abs_err": errs,
           "design": {"bfloat16": "wgmma", "float32": "scalar"},
           # P.V takes P as two bf16 parts (local_attn.cu)
           "p_split": True,
           "tol": {**{k: v for k, v in TOL.items()
                      if k.startswith("local_attn")},
                   "local_attn/bf16 at model shapes": TOL_ATTN_MODEL},
           "heads_compared_at_model_shapes": h, "shapes": shapes,
           **{k: shapes[0][k] for k in ("ms", "plain_ms", "bytes", "ops",
                                        "bound_ms", "bound_by",
                                        "library_ms")}}
    emit(rec)
    return rec


def phase_kernel():
    """Every kernel against its plain version; K1-K3 share the main path's
    shard tensors (8 shards of 1,400,009 rows, window 9)."""
    import torch
    feat, sig = _band_inputs(R, N_FULL + W - 1, 32, 8, 0)
    recs = {"fused_band": _kernel_fused_band(feat, sig),
            "banded_sim": _kernel_banded_sim(feat),
            "jaccard_band": _kernel_jaccard_band(sig)}
    del feat, sig
    torch.cuda.empty_cache()
    recs["local_attn"] = _kernel_local_attn()
    torch.cuda.empty_cache()
    return recs


def phase_bands(kernel_recs):
    """The kernel entry point on the system's own data: the 1.4M-record
    corpus split into R shards, each sorted by (key, eid), as the band
    engines see them."""
    import numpy as np
    import torch
    from repro_torch.core import entities as E
    from repro_torch.core import window as WIN
    from repro_torch.core.match import CascadeMatcher, Matcher
    from repro_torch.kernels import ops
    ents = E.synth_entities(np.random.default_rng(2), N_FULL, n_keys=N_KEYS,
                            dup_frac=0.2, device="cuda")
    shards = E.sort_entities(E.map_fields(
        ents, lambda a: a.reshape((R, -1) + tuple(a.shape[1:]))))
    feat = shards["payload"]["feat"].contiguous()
    sig = shards["payload"]["sig"].contiguous()
    window, w_cos, w_jac = W - 1, 0.25, 0.25

    ops.reset_launch_counts()
    k2 = ops.banded_dot_band(feat, window=window)
    k3 = ops.jaccard_band(sig, window=window)
    k1 = ops.fused_cheap_band(feat, sig, window=window, w_cos=w_cos,
                              w_jac=w_jac)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if min(launches[n] for n in ("fused_band", "banded_sim",
                                 "jaccard_band")) <= 0:
        raise AssertionError(f"bands launched no kernel: {launches}")

    cosine = CascadeMatcher(matchers=(
        Matcher(field="feat", kind="cosine", weight=1.0),), threshold=0.75)
    scores, mask = WIN.band_scores(shards, W, cosine)      # (R, w-1, M)
    cos = torch.clamp(0.5 * (k2 + 1.0), 0.0, 1.0)
    err_cos = float(torch.where(mask, (scores - cos.transpose(-1, -2))
                                .abs(), 0.0).max())
    if not err_cos <= KERNEL_TOL:
        raise AssertionError(f"bands: clip(0.5*(K2+1)) vs band_scores max "
                             f"abs err {err_cos} > {KERNEL_TOL}")
    m = feat.shape[1]
    d = torch.arange(window, device=feat.device)
    inb = (torch.arange(m, device=feat.device)[:, None] + 1 + d) < m
    nonempty = (sig != 0).any(dim=-1)
    ok = inb & nonempty[..., None]
    err_fused = float(torch.where(ok, (k1 - (w_cos * cos + w_jac * k3))
                                  .abs(), 0.0).max())
    if not err_fused <= KERNEL_TOL:
        raise AssertionError(f"bands: K1 vs w_cos*cos(K2) + w_jac*K3 max "
                             f"abs err {err_fused} > {KERNEL_TOL}")

    fused = lambda: ops.fused_cheap_band(feat, sig, window=window,
                                         w_cos=w_cos, w_jac=w_jac)
    separate = lambda: (ops.banded_dot_band(feat, window=window),
                        ops.jaccard_band(sig, window=window))
    turns = [cuda_ms(fused, 50), cuda_ms(separate, 50),
             cuda_ms(separate, 50), cuda_ms(fused, 50)]
    full = {n: kernel_recs[n]["ms"] for n in ("fused_band", "banded_sim",
                                              "jaccard_band")}
    rec = {"phase": "bands", "shards": R, "rows_per_shard": m,
           "window": window, "launches": launches,
           "pairs_compared": int(mask.sum()),
           "rows_with_empty_signature": int((~nonempty).sum()),
           "cos_vs_band_scores_max_abs_err": err_cos,
           "fused_vs_halves_max_abs_err": err_fused, "tol": KERNEL_TOL,
           "fused_ms": [turns[0], turns[3]],
           "separate_ms": [turns[1], turns[2]],
           "fusion_saves_ms": (turns[1] + turns[2] - turns[0] - turns[3]) / 2,
           "main_shape": {**full, "separate_ms": full["banded_sim"]
                          + full["jaccard_band"],
                          "fusion_saves_ms": full["banded_sim"]
                          + full["jaccard_band"] - full["fused_band"]}}
    emit(rec)
    return rec


def phase_attention():
    """``kernels.ops.local_attn`` at one sliding-window layer of each model
    shape: finite output of q's shape and dtype, the first head equal to
    the plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    inputs = [(label, [_randn((bh, s, d), 20 + j, torch.bfloat16)
                       for j in range(3)], window, cap)
              for label, bh, s, d, window, cap in ATTN_SHAPES]
    ops.reset_launch_counts()
    outs = [ops.local_attn(*qkv, window=window, softcap=cap)
            for _, qkv, window, cap in inputs]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["local_attn"] <= 0:
        raise AssertionError(f"attention launched no kernel: {launches}")
    rows = []
    for (label, (q, k, v), window, cap), out in zip(inputs, outs):
        if out.shape != q.shape or out.dtype != q.dtype or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention {label}: {tuple(out.shape)} "
                                 f"{out.dtype}, or non-finite")
        err = _hold("local_attn", out[:1], ref.local_attention_ref(
            q[:1], k[:1], v[:1], window=window, softcap=cap),
            TOL_ATTN_MODEL, label)
        rows.append({"model": label, "shape": list(q.shape),
                     "window": window, "softcap": cap,
                     "head0_max_abs_err": err})
    emit({"phase": "attention", "launches": launches, "runs": rows})
    del inputs, outs
    torch.cuda.empty_cache()
    return {"launches": launches}


def _cfg_kw(**kw):
    from repro_torch.core.match import paper_cascade
    base = dict(window=W, num_shards=R, hops=HOPS, emit="pairs",
                matcher=paper_cascade())
    base.update(kw)
    return base


def _zero_overflow(res, label):
    b = res.blocking
    if b.overflow or b.cand_overflow or b.pair_overflow:
        raise AssertionError(f"{label}: overflow={b.overflow} cand_overflow="
                             f"{b.cand_overflow} pair_overflow="
                             f"{b.pair_overflow}")


def phase_parity():
    import numpy as np
    from repro_torch import api
    from repro_torch.core import entities as E
    ents = E.synth_entities(np.random.default_rng(1), N_PARITY,
                            n_keys=N_KEYS, dup_frac=0.2, text_len=16)
    rows = []
    for variant in ("srp", "repsn", "jobsn"):
        seq, seq_s = wall(lambda: api.resolve(
            ents, api.ERConfig(**_cfg_kw(variant=variant,
                                         runner="sequential")),
            device="cuda"))
        for engine in ("scan", "pallas"):
            res, secs = wall(lambda: api.resolve(
                ents, api.ERConfig(**_cfg_kw(variant=variant, runner="vmap",
                                             band_engine=engine)),
                device="cuda"))
            label = f"parity {variant}/{engine}"
            _zero_overflow(res, label)
            if not _same_sets(res, seq):
                raise AssertionError(
                    f"{label}: blocked {len(res.blocking.pairs)} vs "
                    f"{len(seq.blocking.pairs)}, matched {len(res.matches)} "
                    f"vs {len(seq.matches)}")
            rows.append({"variant": variant, "engine": engine,
                         "blocked": len(res.blocking.pairs),
                         "matched": len(res.matches),
                         "resolve_s": round(secs, 3),
                         "sequential_s": round(seq_s, 3)})
    emit({"phase": "parity", "n": N_PARITY, "equal": True, "runs": rows,
          "reduced": ["n 200,000 -> 50,000: the script's time limit"]})


def _device_busy(fn):
    """(seconds of CUDA kernel time, top kernels, {kernel name: calls}) of
    ``fn`` under torch.profiler; (None, [], {}) when the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return None, [], {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy_us / 1e6, [[e.key[:80], e.count, e.self_device_time_total
                            / 1e6] for e in top], \
        {e.key: e.count for e in kernels}


def _span_seconds(report):
    """{span name: total seconds} and {span name: self seconds} of a
    ``TraceReport``."""
    return ({k: v["total_s"] for k, v in report.span_totals().items()},
            dict(report.self_times()))


def _breakdown(ents, cfg):
    """One steady resolve taken apart by its trace (``cfg.trace``): the
    ``plan`` span (profile, plan, auto caps), the ``shard_program`` span
    (fenced by a synchronize), the ``collect`` span (host collection into
    packed pairs) and the ``frozensets`` spans (the public frozensets,
    ``PackedOutcome.to_outcome``, with the collector's passes inside them);
    plus the device's busy time
    over one more shard program (torch.profiler), which must be a replay
    of the resolve's cached graph (one hit, no miss, no trace) whose
    kernel list holds K1 once.  Returns (record, the traced result)."""
    from repro_torch import api
    from repro_torch.perf import executable_cache
    from repro_torch.resilience.retry import autosize_caps
    res, traced_s = wall(lambda: api.resolve(ents, cfg.with_(trace=True),
                                             device="cuda"))
    total, own = _span_seconds(res.trace)
    runner = api.VmapRunner(R, device="cuda")
    plan = api.plan_shards(ents, cfg, R)
    run_cfg, _ = autosize_caps(cfg, plan=plan)
    before = _k1_launches()
    stats = executable_cache().stats
    since = stats.snapshot()
    busy_s, top, counts = _device_busy(
        lambda: runner.run_raw(ents, plan, run_cfg))
    if stats.delta(since) != (1, 0, 0):
        raise AssertionError("the profiled shard program was no replay: "
                             f"(hits, misses, traces) {stats.delta(since)}")
    if _k1_launches() - before != 1:
        raise AssertionError("the profiled shard program launched K1 "
                             f"{_k1_launches() - before} times")
    k1_profiled = sum(n for k, n in counts.items() if "fused_band" in k)
    return {"traced_s": traced_s, "plan_s": total["plan"],
            "device_program_s": total["shard_program"],
            "host_collect_packed_s": total["collect"],
            "frozensets_s": total["frozensets"],
            "resolve_self_s": own["resolve"],
            "span_coverage": res.trace.coverage(),
            "device_kernel_busy_s": busy_s, "top_kernels_s": top,
            "replay_fused_band_kernels": k1_profiled}, res


def _dedup_times(blocked):
    """Seconds of the dedup the host collection runs (``unique_packed``) on
    the shuffled blocked pairs.  ``np.unique`` on the same pairs is no
    longer read: PERF.md §5 holds its 13.87 s against 0.205 s."""
    import numpy as np
    from repro_torch.api.results import unique_packed
    shuffled = np.random.default_rng(0).permutation(blocked)
    t0 = time.perf_counter()
    unique_packed(shuffled)
    return {"dedup_unique_packed_s": time.perf_counter() - t0}


class _Laps:
    """Host seconds of a phase's steps: ``lap(name)`` adds the time since
    the previous lap (or the start) to ``name``."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t
        self.t = now


def _gb_cap(label):
    """Raise when the phase's peak reserved device memory passed
    RESERVED_CAP; returns (max_memory_allocated, max_memory_reserved)."""
    import torch
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    if peak[1] > RESERVED_CAP:
        raise AssertionError(f"{label}: {peak[1]} bytes reserved at peak, "
                             f"above {RESERVED_CAP}")
    return peak


def _fresh_cache():
    """The executable cache emptied (its graphs' pool returned to the
    card) and the peak memory statistics reset: a phase's start."""
    import torch
    from repro_torch.perf import executable_cache
    executable_cache().clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _perf(res):
    p = res.perf
    return {"cache_hits": p.cache_hits, "cache_misses": p.cache_misses,
            "traces": p.traces, "cache_entries": p.cache_entries,
            "steady_state": p.steady_state}


def phase_main():
    """The main path at full size through the executable cache: a cold
    resolve (its shard program run, then captured as a CUDA graph), a
    steady one (the graph replayed: hits, no trace), one traced; then the
    same resolve with ``jit_cache=False`` (eager, cache emptied first):
    equal sets, its seconds and memory beside the cached run's."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import entities as E
    from repro_torch.core import sn
    from repro_torch.kernels import ops

    lap = _Laps()
    ents = E.synth_entities(np.random.default_rng(0), N_FULL, n_keys=N_KEYS,
                            dup_frac=0.2, text_len=16, device="cuda")
    cfg = api.ERConfig(**_cfg_kw(variant="repsn", runner="vmap",
                                 partitioner="balanced",
                                 band_engine="pallas"))
    run = lambda c=cfg: api.resolve(ents, c, device="cuda")
    lap("corpus")

    _fresh_cache()
    ops.reset_launch_counts()
    res, cold_s = wall(run)
    launches = ops.launch_counts()
    if launches["fused_band"] <= 0:
        raise AssertionError(f"main path launched no kernel: {launches}")
    cold_perf = _perf(res)
    if (cold_perf["cache_misses"], cold_perf["traces"]) != (1, 1):
        raise AssertionError(f"main cold resolve: {cold_perf}")

    expected = sn.expected_pair_count(N_FULL, W)
    _zero_overflow(res, "main")
    if len(res.blocking.pairs) != expected:
        raise AssertionError(f"blocked {len(res.blocking.pairs)} != "
                             f"{expected}")
    if not res.matches:
        raise AssertionError("main path matched nothing")

    lap("cold")
    before = ops.launch_counts()["fused_band"]
    steady, steady_s = wall(run)
    steady_perf = _perf(steady)
    replay_launches = ops.launch_counts()["fused_band"] - before
    if not steady_perf["steady_state"] or steady_perf["cache_hits"] < 1 or \
            replay_launches != 1:
        raise AssertionError(f"main steady resolve: {steady_perf}, K1 "
                             f"launched {replay_launches} times")
    if not _same_sets(steady, res):
        raise AssertionError("main: the replayed resolve's sets differ")
    del steady
    cached_peak = _gb_cap("main (cached)")
    lap("steady")
    breakdown, traced = _breakdown(ents, cfg)
    # invariant 12: the traced resolve gives the untraced sets
    if not _same_sets(traced, res):
        raise AssertionError(
            f"traced resolve: blocked {len(traced.blocking.pairs)} vs "
            f"{len(res.blocking.pairs)}, matched {len(traced.matches)} vs "
            f"{len(res.matches)}")
    if not _perf(traced)["steady_state"]:
        raise AssertionError(f"main traced resolve: {_perf(traced)}")
    if breakdown["replay_fused_band_kernels"] != 1:
        raise AssertionError(f"main: {breakdown['replay_fused_band_kernels']}"
                             f" fused_band kernels in the profiled replay: "
                             f"{breakdown['top_kernels_s']}")
    del traced
    lap("traced")
    sets = _packed_sets(res)
    lap("pack")
    breakdown.update(_dedup_times(sets[0]))
    lap("dedup")
    launches["fused_band"] += replay_launches

    # the same resolve eagerly, once, from an empty cache
    _fresh_cache()
    eager_cfg = cfg.with_(jit_cache=False)
    eager, eager_s = wall(lambda: run(eager_cfg))
    eager_peak = _gb_cap("main (jit_cache=False)")
    if not _same_sets(eager, res):
        raise AssertionError("main: the eager resolve's sets differ from "
                             "the cached one's")
    eager_perf = _perf(eager)
    del eager
    lap("eager")

    scan, scan_s = wall(lambda: run(eager_cfg.with_(band_engine="scan")))
    if not _same_sets(scan, res):
        raise AssertionError(
            f"scan vs pallas: matched {len(scan.matches)} vs "
            f"{len(res.matches)}, blocked {len(scan.blocking.pairs)} vs "
            f"{len(res.blocking.pairs)}")
    del scan
    lap("scan")
    rec = {"phase": "main", "n": N_FULL, "n_keys": N_KEYS, "w": W, "r": R,
           "hops": HOPS, "variant": "repsn", "band_engine": "pallas",
           "emit": "pairs",
           "reduced": ["one jit_cache=False resolve, not two (cold and "
                       "steady eager differ only by the host's spread)",
                       "np.unique of the blocked pairs no longer timed "
                       "(PERF.md §5: 13.87 s against 0.205 s)"],
           "rows_per_shard": R * int(np.ceil(N_FULL / R)) + W - 1,
           "cand_cap": res.resilience.cand_cap,
           "pair_cap": res.resilience.pair_cap,
           "blocked": len(res.blocking.pairs), "expected_blocked": expected,
           "matched": len(res.matches),
           "cand_count": list(res.blocking.cand_count),
           "overflow": [res.blocking.overflow, res.blocking.cand_overflow,
                        res.blocking.pair_overflow],
           "kernel_launches": launches,
           "cold_s": cold_s, "steady_s": steady_s,
           "traced_steady_s": breakdown["traced_s"],
           "traced_equals_untraced": True, "breakdown": breakdown,
           "blocked_pairs_per_s": len(res.blocking.pairs) / steady_s,
           "cache": {"cold_perf": cold_perf, "steady_perf": steady_perf,
                     "replay_k1_launches": replay_launches,
                     "max_memory_allocated": cached_peak[0],
                     "max_memory_reserved": cached_peak[1]},
           "eager": {"jit_cache": False, "s": eager_s, "perf": eager_perf,
                     "sets_equal_cached": True,
                     "max_memory_allocated": eager_peak[0],
                     "max_memory_reserved": eager_peak[1]},
           "max_memory_allocated": cached_peak[0],
           "scan_s": scan_s, "scan_matched_equal": True,
           "scan_jit_cache": False, "laps_s": lap.seconds}
    emit(rec)
    return rec, ents, sets


def _k1_launches() -> int:
    from repro_torch.kernels import ops
    return ops.launch_counts()["fused_band"]


def _counted_resolve(ents, cfg, label, passes=1):
    """(result, seconds) of one ``api.resolve`` on the card; raises unless
    K1 was launched at least once for each of its ``passes``."""
    from repro_torch import api
    before = _k1_launches()
    res, secs = wall(lambda: api.resolve(ents, cfg, device="cuda"))
    if _k1_launches() - before < passes:
        raise AssertionError(f"{label}: K1 launched {_k1_launches() - before}"
                             f" times over {passes} pass(es)")
    return res, secs


def _packed_sets(res):
    """(blocked, matched) of a result as sorted packed uint64 arrays."""
    from repro_torch.api.results import pack_pair_set
    return pack_pair_set(res.blocking.pairs), pack_pair_set(res.matches)


def _same_sets(a, b) -> bool:
    """Whether two results hold equal blocked and equal matched sets."""
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(_packed_sets(a),
                                                    _packed_sets(b)))


def _oracle_packed(keys, eids, window=None, weff=None):
    """The sequential SN oracle (``weff``: the adaptive one) as a sorted
    packed pair array.  Runs in a worker process: the oracles are Python
    loops over millions of pairs, so they overlap the resolves."""
    from repro_torch.api.results import pack_pair_set
    from repro_torch.core import sn
    if weff is None:
        return pack_pair_set(sn.sequential_sn_pairs(keys, eids, window))
    return pack_pair_set(sn.adaptive_sn_pairs(keys, eids, weff))


def _oracle_pool(workers):
    """A pool of spawned processes for ``_oracle_packed`` (spawn: this
    process holds CUDA and threads)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=multiprocessing.get_context("spawn"))


def _planned_run(ents, cfg, label, breakdown):
    """One corpus resolved under one profile planner, in the cache the
    phase's earlier runs left (its graph budget evicts their graphs before
    this run's warm-up): the plan first (its shard shape), then a cold
    resolve (captured); with ``breakdown``, a steady one (replayed),
    traced and taken apart by its spans (``_breakdown``).  Returns
    (record, packed blocked, packed matched)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.perf import executable_cache
    lap = _Laps()
    plan = api.plan_shards(ents, cfg, R)
    lap("plan")
    res, cold_s = _counted_resolve(ents, cfg, label)
    graph_bytes = executable_cache().graph_bytes("cuda")
    _zero_overflow(res, label)
    lap("cold")
    blocked, matched = _packed_sets(res)
    bal = res.balance
    del res
    lap("pack")
    rec = {"label": label, "partitioner": cfg.partitioner,
           "cap_link": plan.cap_link,
           "rows_per_shard": R * plan.cap_link + cfg.window - 1,
           "dest_routing": plan.dest is not None,
           "rank_granular": plan.rank_granular,
           "planned_load_max": int(np.max(plan.planned_load)),
           "imbalance_planned": bal.imbalance_planned,
           "imbalance_realized": bal.imbalance_realized,
           "blocked": int(blocked.size), "matched": int(matched.size),
           "cold_s": cold_s, "graph_bytes": graph_bytes}
    if breakdown:
        before = _k1_launches()
        parts = _breakdown(ents, cfg)[0]
        if _k1_launches() - before < 2:   # the resolve + the profiled run
            raise AssertionError(
                f"{label}: K1 launched {_k1_launches() - before} times over "
                f"the traced steady resolve and its profiled shard program")
        rec.update(traced_steady_s=parts["traced_s"],
                   device_program_s=parts["device_program_s"],
                   device_kernel_busy_s=parts["device_kernel_busy_s"],
                   breakdown=parts)
        lap("traced")
    rec["laps_s"] = lap.seconds
    return rec, blocked, matched


def _k1_at(rows, label, shards=R, f=32, words=8, window=W - 1):
    """K1 at one shard shape the path gave it (``shards`` shards of
    ``rows`` rows, ``f`` features, ``words`` signature words): held
    against its plain version and timed."""
    import torch
    from repro_torch.kernels import ops
    feat, sig = _band_inputs(shards, rows, f, words, 3)
    err = _check_band(feat, sig, window, 0.5, 0.5, label)
    ms = cuda_ms(lambda: ops.fused_cheap_band(feat, sig, window=window,
                                              w_cos=0.5, w_jac=0.5), reps=50)
    n_bytes = (feat.numel() + sig.numel() + shards * rows * window) * 4
    del feat, sig
    torch.cuda.empty_cache()
    return {"shards": shards, "rows": rows, "window": window, "ms": ms,
            "max_abs_err": err,
            **_bound(n_bytes, _band_pairs(shards, rows, window)
                     * (2 * f + 6 * words), F32_OPS_PER_S)}


class _Recorded:
    """While entered, records the (shards, rows, features, words, window)
    of every ``ops.fused_cheap_band`` call and the device of every
    ``entities.sort_chunk`` call (the stream's chunk sorts); both are
    restored on exit."""

    def __enter__(self):
        from repro_torch.core import entities as E
        from repro_torch.kernels import ops
        self.k1_shapes, self.sort_devices = set(), []
        self.saved = band, sort = ops.fused_cheap_band, E.sort_chunk

        def fused_cheap_band(feat, sig, *, window, **kw):
            lead = (1,) * (3 - feat.dim())   # an unbatched call: 1 shard
            self.k1_shapes.add((*lead, *feat.shape, sig.shape[-1], window))
            return band(feat, sig, window=window, **kw)

        def sort_chunk(ents, key=None):
            self.sort_devices.append(ents["key"].device.type)
            return sort(ents, key=key)

        ops.fused_cheap_band, E.sort_chunk = fused_cheap_band, sort_chunk
        return self

    def __exit__(self, *exc):
        from repro_torch.core import entities as E
        from repro_torch.kernels import ops
        ops.fused_cheap_band, E.sort_chunk = self.saved


def _assert_equal(label, got, want):
    import numpy as np
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: {got.size} vs {want.size} pairs, "
                             f"{np.setdiff1d(got, want).size} only in the "
                             f"first, {np.setdiff1d(want, got).size} only "
                             f"in the second")


def _planned_main(main_ents, main_sets):
    """Phase main's corpus and config under pairrange and blocksplit: the
    blocked and matched sets must equal phase main's."""
    from repro_torch import api
    main_cfg = api.ERConfig(**_cfg_kw(variant="repsn", runner="vmap",
                                      band_engine="pallas"))
    runs = []
    for planner in ("pairrange", "blocksplit"):
        rec, blocked, matched = _planned_run(
            main_ents, main_cfg.with_(partitioner=planner),
            f"planned main/{planner}",
            breakdown=planner == PLANNED_TRACED["main"])
        _assert_equal(f"planned main/{planner} blocked", blocked,
                      main_sets[0])
        _assert_equal(f"planned main/{planner} matched", matched,
                      main_sets[1])
        runs.append(dict(rec, corpus="main"))
    return runs


def phase_planned(main_rec, main_ents, main_sets):
    """M6 at full size: (a) phase main's corpus and config under pairrange
    and blocksplit; (b) the skewed Zipfian corpus under uniform, blocksplit
    and pairrange with the default matcher."""
    import torch
    from repro_torch import api
    from repro_torch.core import sn
    from repro_torch.data import zipf_entities
    from repro_torch.kernels import ops
    from repro_torch.perf import executable_cache

    _fresh_cache()
    evictions = executable_cache().stats.evictions
    ops.reset_launch_counts()
    zipf, zipf_s = wall(lambda: zipf_entities(0, N_FULL, **ZIPF,
                                              device="cuda"))
    with _oracle_pool(1) as pool:
        job = pool.submit(_oracle_packed, zipf["key"].cpu().numpy(),
                          zipf["eid"].cpu().numpy(), W)
        runs = _planned_main(main_ents, main_sets)
        oracle, oracle_wait_s = wall(job.result)
    expected = sn.expected_pair_count(N_FULL, W)
    if oracle.size != expected:
        raise AssertionError(f"zipf oracle {oracle.size} != {expected}")
    zipf_cfg = api.ERConfig(window=W, num_shards=R, hops=HOPS,
                            variant="repsn", runner="vmap",
                            band_engine="pallas", emit="pairs")
    zipf_matched = None
    for planner in ("uniform", "blocksplit", "pairrange"):
        label = f"planned zipf/{planner}"
        rec, blocked, matched = _planned_run(
            zipf, zipf_cfg.with_(partitioner=planner), label,
            breakdown=planner == PLANNED_TRACED["zipf"])
        _assert_equal(f"{label} blocked vs sequential oracle", blocked,
                      oracle)
        if zipf_matched is None:
            zipf_matched = matched
        _assert_equal(f"{label} matched vs uniform", matched, zipf_matched)
        if planner == "blocksplit" and not rec["dest_routing"]:
            raise AssertionError(f"{label}: the hot block was not split")
        runs.append(dict(rec, corpus="zipf"))
        del blocked, matched
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = _gb_cap("planned")
    evictions = executable_cache().stats.evictions - evictions
    del zipf, oracle
    _fresh_cache()

    # K1 at each planned shard shape (after the counts were read)
    k1 = {}
    for run in runs:
        rows = run["rows_per_shard"]
        if rows not in k1:
            k1[rows] = _k1_at(rows, f"planned shape {rows}")
        run["k1_ms_at_shard_shape"] = k1[rows]["ms"]
    rec = {"phase": "planned", "n": N_FULL, "w": W, "r": R, "hops": HOPS,
           "reduced": ["the traced, profiled steady resolve (_breakdown) "
                       "for one run per corpus (main/pairrange, "
                       "zipf/uniform), not all five: the script's time "
                       "limit; every run keeps its cold resolve and set "
                       "gates"],
           "traced": PLANNED_TRACED,
           "zipf": dict(ZIPF, seed=0),
           "zipf_make_s": zipf_s, "zipf_oracle_wait_s": oracle_wait_s,
           "expected_blocked": expected, "launches": launches,
           "cache_evictions": evictions,
           "max_memory_allocated": peak[0], "max_memory_reserved": peak[1],
           "main": {k: main_rec[k] for k in ("rows_per_shard", "cold_s",
                                             "steady_s")}
           | {k: main_rec["breakdown"][k] for k in ("device_program_s",
                                                    "device_kernel_busy_s")},
           "runs": runs, "k1_at_shard_shapes": list(k1.values())}
    emit(rec)
    return rec


def phase_quality():
    """M7 at full size: a labeled corpus with typos resolved at fixed w=8,
    with adaptive windows (with and without evidence pruning) and with two
    passes (key, alt); quality against the gold pairs, blocked sets against
    the host oracles (computed in worker processes during the resolves)."""
    import numpy as np
    import torch
    from repro_torch import api, quality
    from repro_torch.api.results import pack_pair_set, union_sorted
    from repro_torch.balance import profile_keys
    from repro_torch.core import keys as K
    from repro_torch.data import labeled_corpus
    from repro_torch.kernels import ops

    _fresh_cache()
    lap = _Laps()
    tc, make_s = wall(lambda: labeled_corpus(1, N_FULL, **RECALL,
                                             device="cuda"))
    lap("corpus")
    base = api.ERConfig(window=W_FIXED, num_shards=R, hops=HOPS,
                        variant="repsn", runner="vmap", band_engine="pallas",
                        emit="pairs", partitioner="pairrange")
    adaptive = base.with_(window=W_BASE, window_policy="adaptive",
                          window_max=W_MAX)
    passes = (api.SortKeySpec(name="key"),
              api.SortKeySpec(name="alt", source="alt"))
    configs = [("fixed8", base, 1), ("adaptive", adaptive, 1),
               ("adaptive_pruned", adaptive.with_(
                   prune_policy="evidence", prune_threshold=PRUNE), 1),
               ("multipass8", base.with_(passes=passes), len(passes))]
    keys = tc.ents["key"].cpu().numpy()
    eids = tc.ents["eid"].cpu().numpy()
    weff = quality.weff_for_keys(keys, profile_keys(keys, window=W_BASE),
                                 W_BASE, W_MAX)
    runs, q, blocked = {}, {}, {}
    lap("weff")
    with _oracle_pool(len(passes) + 1) as pool:
        jobs = [pool.submit(_oracle_packed, keys, eids, weff=weff)] + [
            pool.submit(_oracle_packed,
                        K.derive_sort_key(tc.ents, spec).cpu().numpy(),
                        eids, W_FIXED) for spec in passes]
        ops.reset_launch_counts()
        for label, cfg, n_passes in configs:
            lap("oracle_jobs")
            res, secs = _counted_resolve(tc.ents, cfg, f"quality {label}",
                                         n_passes)
            lap("resolve")
            for part in getattr(res, "passes", (res,)):
                _zero_overflow(part, f"quality {label}")
            blocked[label] = pack_pair_set(res.blocking.pairs)
            if label == "multipass8":
                blocked["passes"] = [pack_pair_set(p.blocking.pairs)
                                     for p in res.passes]
            q[label] = quality.evaluate(blocked[label], tc)
            runs[label] = {"resolve_s": secs,
                           "pc": q[label].pairs_completeness,
                           "pq": q[label].pairs_quality,
                           "rr": q[label].reduction_ratio,
                           "f": q[label].f_measure,
                           "blocked": q[label].blocked_pairs,
                           "true_positives": q[label].true_positives,
                           "pruned": res.blocking.pruned,
                           "matched": len(res.matches)}
            del res
            lap("pack_evaluate")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak = _gb_cap("quality")
        oracles, oracle_wait_s = wall(lambda: [j.result() for j in jobs])
    lap("oracle_wait")

    _assert_equal("quality adaptive vs adaptive_sn_pairs",
                  blocked["adaptive"], oracles[0])
    # the port's sorted union: numpy 2.3's union1d hashes (~10 s a call
    # at these sizes)
    _assert_equal("quality multipass union vs its passes",
                  blocked["multipass8"], union_sorted(*blocked["passes"]))
    _assert_equal("quality multipass union vs the per-pass oracles",
                  blocked["multipass8"], union_sorted(*oracles[1:]))
    fixed, adapt = q["fixed8"], q["adaptive"]
    if not (adapt.pairs_completeness >= fixed.pairs_completeness and
            adapt.reduction_ratio >= fixed.reduction_ratio):
        raise AssertionError(f"quality: adaptive PC {adapt.pairs_completeness}"
                             f" RR {adapt.reduction_ratio} vs fixed-8 PC "
                             f"{fixed.pairs_completeness} RR "
                             f"{fixed.reduction_ratio}")
    if runs["adaptive_pruned"]["pruned"] <= 0:
        raise AssertionError("quality: evidence pruning pruned nothing")
    lap("gates")
    rec = {"phase": "quality", "n": N_FULL, "r": R, "hops": HOPS,
           "partitioner": "pairrange", "reduced": [],
           "corpus": dict(RECALL, seed=1, n_units=tc.n_units,
                          gold_pairs=int(tc.gold_packed.size),
                          n_typos=tc.n_typos, max_block=tc.max_block),
           "windows": {"fixed": W_FIXED, "base": W_BASE, "max": W_MAX,
                       "prune_threshold": PRUNE},
           "corpus_make_s": make_s, "oracle_wait_s": oracle_wait_s,
           "launches": launches, "runs": runs, "laps_s": lap.seconds,
           "max_memory_allocated": peak[0], "max_memory_reserved": peak[1]}
    emit(rec)
    del tc
    _fresh_cache()
    return rec


def _traced(fn, root, raises=None):
    """Run ``fn`` under a tracer of its own, inside a root span named
    ``root`` (how a run that raises, or a resume, which attaches no
    report, is traced).  Returns (result or None, its ``TraceReport``);
    ``raises``: the exception ``fn`` must raise."""
    from repro_torch import obs
    tracer = obs.Tracer()
    out = None
    with obs.activate(tracer), obs.span(root):
        try:
            out = fn()
        except raises or ():
            pass
        else:
            if raises is not None:
                raise AssertionError(f"{root}: no {raises.__name__}")
    return out, obs.TraceReport.from_tracer(tracer)


def _stream_stages(label, report, launches, n_chunks, seen, sorts):
    """Stage seconds of one streamed run from its trace, and its per-chunk
    checks: ``n_chunks`` ``chunk`` spans, each holding one
    ``shard_program`` span, and K1 launched once for each of those (K1
    counts only launches on the card, so every chunk program ran there);
    ``seen`` (a ``_Recorded``) saw ``sorts`` chunk sorts, all on the
    card.  Returns the record."""
    spans = report.spans
    by_index = {s.index: s for s in spans}

    def chunk_of(s):
        while s.parent >= 0:
            s = by_index[s.parent]
            if s.name == "chunk":
                return s.index
        return None

    chunks = [s.index for s in spans if s.name == "chunk"]
    programs = [s for s in spans if s.name == "shard_program"]
    per_chunk = [sum(chunk_of(p) == c for p in programs) for c in chunks]
    if len(chunks) != n_chunks or per_chunk != [1] * n_chunks or \
            launches != len(programs):
        raise AssertionError(f"{label}: {len(chunks)} chunk spans (want "
                             f"{n_chunks}), shard programs per chunk "
                             f"{per_chunk}, K1 launches {launches}")
    if seen.sort_devices != ["cuda"] * sorts:
        raise AssertionError(f"{label}: chunk sorts on {seen.sort_devices}"
                             f" (want {sorts} on the card)")
    total, own = _span_seconds(report)
    seconds = {k: total.get(k, 0.0) for k in (
        "ingest", "sort_runs", "merge", "chunk", "shard_program", "collect",
        "checkpoint_commit")}
    # the union's dedup and frozensets run in the pass span's own time
    seconds["pass_self"] = own.get("pass", 0.0)
    return {"seconds": seconds, "k1_launches": launches,
            "chunk_sorts": len(seen.sort_devices),
            "rows_per_shard": sorted({p.attrs["rows_per_shard"]
                                      for p in programs}),
            "k1_shapes": sorted(seen.k1_shapes),
            "span_coverage": report.coverage()}


def _stream_gates(label, res, main_sets, n_chunks):
    """The stream's union against phase main's sets, zero overflow, and its
    chunk accounting: 8 runs, (chunks - 1) seams of w - 1 carried rows,
    no degenerate chunk, a chunk's device bytes below the corpus's."""
    _zero_overflow(res, label)
    blocked, matched = _packed_sets(res)
    _assert_equal(f"{label} blocked vs main", blocked, main_sets[0])
    _assert_equal(f"{label} matched vs main", matched, main_sets[1])
    st = res.stream
    want = {"chunks": n_chunks, "runs": N_FULL // STREAM_INPUT,
            "carry_entities": (n_chunks - 1) * (W - 1),
            "degenerate_chunks": 0, "entities": N_FULL}
    got = {k: getattr(st, k) for k in want}
    if got != want or not st.chunk_device_bytes < st.corpus_bytes:
        raise AssertionError(f"{label}: stream stats {st}, want {want}")


def phase_stream(main_rec, main_sets):
    """M8 at full size: phase main's corpus, streamed in host chunks and
    resolved chunk by chunk with the seam carry; then the same run
    checkpointed, killed mid-commit and resumed.  All three runs are
    traced (``ERConfig.trace``): the stage seconds and the per-chunk
    checks come from their spans; K1's shapes and the chunk sorts'
    device from a ``_Recorded``."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch import api, stream
    from repro_torch.core import entities as E
    from repro_torch.kernels import ops

    host = E.synth_arrays(np.random.default_rng(0), N_FULL, n_keys=N_KEYS,
                          dup_frac=0.2, text_len=16)
    chunks = lambda: (E.host_take(host, slice(s, s + STREAM_INPUT))
                      for s in range(0, N_FULL, STREAM_INPUT))
    cfg = api.ERConfig(**_cfg_kw(variant="repsn", runner="vmap",
                                 partitioner="balanced",
                                 band_engine="pallas", trace=True))
    n_chunks = -(-N_FULL // STREAM_CHUNK)
    run = lambda **kw: stream.resolve_stream(
        chunks(), cfg, chunk_size=STREAM_CHUNK, device="cuda", **kw)

    _fresh_cache()
    n_runs = N_FULL // STREAM_INPUT
    ops.reset_launch_counts()
    with _Recorded() as seen:
        res, stream_s = wall(run)
    launches = ops.launch_counts()
    peak, peak_reserved = _gb_cap("stream")
    if not res.stream.steady_chunks > 0:
        raise AssertionError(f"stream: {res.stream.steady_chunks} steady "
                             f"chunks of {n_chunks}")
    stages = _stream_stages("stream", res.trace, launches["fused_band"],
                            n_chunks, seen, n_runs)
    shapes = seen.k1_shapes
    _stream_gates("stream", res, main_sets, n_chunks)
    stats = dataclasses.asdict(res.stream)
    resilience = res.resilience._asdict()
    del res

    ckpt = ROOT / "build" / "stream_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    kill = api.FaultPlan(crash_before_commit=2)
    # the killed run starts from an empty cache, as the stream did, so the
    # resumed run's cache counters equal the stream's
    _fresh_cache()
    ops.reset_launch_counts()
    with _Recorded() as killed_seen:
        (_, killed), killed_s = wall(lambda: _traced(
            lambda: run(checkpoint_dir=str(ckpt), fault_plan=kill),
            "killed", raises=api.InjectedFault))
    killed_launches = ops.launch_counts()["fused_band"]
    killed_stages = _stream_stages(
        "stream killed", killed, killed_launches,
        kill.crash_before_commit + 1, killed_seen, n_runs)
    ops.reset_launch_counts()
    with _Recorded() as resume_seen:
        (resumed, resumed_tr), resume_s = wall(lambda: _traced(
            lambda: api.resume(str(ckpt), cfg=cfg, device="cuda"),
            "resume"))
    resume_launches = ops.launch_counts()["fused_band"]
    peak_reserved = max(peak_reserved, _gb_cap("stream checkpointed")[1])
    # the resume redoes the torn chunk and the ones after it; its sorted
    # runs were committed before the kill
    resume_stages = _stream_stages(
        "stream resumed", resumed_tr, resume_launches,
        n_chunks - kill.crash_before_commit, resume_seen, 0)
    _stream_gates("stream resumed", resumed, main_sets, n_chunks)
    spooled = resumed.stream.spooled_bytes
    resumed_stats = dataclasses.asdict(resumed.stream)
    del resumed
    shutil.rmtree(ckpt)
    if {k: v for k, v in resumed_stats.items() if k != "spooled_bytes"} \
            != {k: v for k, v in stats.items() if k != "spooled_bytes"}:
        raise AssertionError(f"stream resumed stats {resumed_stats} vs "
                             f"{stats}")

    # K1 at each shard shape the three runs' shard programs gave it (after
    # the counts were read)
    k1 = [_k1_at(m, f"stream chunk shape {(s, m, f, words, window)}",
                 shards=s, f=f, words=words, window=window)
          for s, m, f, words, window in sorted(
              shapes | killed_seen.k1_shapes | resume_seen.k1_shapes)]

    rec = {"phase": "stream", "n": N_FULL, "input_chunk": STREAM_INPUT,
           "chunk_size": STREAM_CHUNK, "w": W, "r": R, "hops": HOPS,
           "variant": "repsn", "band_engine": "pallas", "emit": "pairs",
           "trace": True, "reduced": [], "blocked": int(main_sets[0].size),
           "matched": int(main_sets[1].size), "stream_stats": stats,
           "resilience": resilience, "launches": launches,
           "stream_s": stream_s, "main_steady_s": main_rec["steady_s"],
           "stages": stages, "k1_at_chunk_shapes": k1,
           "max_memory_allocated": peak,
           "max_memory_reserved": peak_reserved,
           "main_max_memory_allocated": main_rec["max_memory_allocated"],
           "checkpoint": {"kill": "crash_before_commit=2",
                          "killed_s": killed_s, "resume_s": resume_s,
                          "spooled_bytes": spooled,
                          "launches": {"fused_band": killed_launches
                                       + resume_launches},
                          "killed_stages": killed_stages,
                          "resume_stages": resume_stages}}
    emit(rec)
    _fresh_cache()
    return rec


def _check_edit(label, svc, res, prev):
    """Raise unless ``res`` (an ``IncrementalResult``) is the difference
    between the served sets ``prev`` = (blocked, matched) before it and
    the service's served sets now: prev - retired + new == now, with new
    disjoint from prev and retired inside it, and a pair id for every new
    pair.  Returns the served sets now."""
    import numpy as np
    from repro_torch.api.results import (pack_pair_set, setdiff_sorted,
                                         union_sorted)
    now = (svc.packed_pairs, svc.packed_matches)
    for (new, gone), before, after, what in (
            ((res.new_pairs, res.retired_pairs), prev[0], now[0], "pairs"),
            ((res.new_matches, res.retired_matches), prev[1], now[1],
             "matches")):
        new, gone = pack_pair_set(new), pack_pair_set(gone)
        if setdiff_sorted(gone, before).size or \
                setdiff_sorted(new, before).size != new.size or \
                not np.array_equal(union_sorted(setdiff_sorted(before, gone),
                                                new), after):
            raise AssertionError(f"{label}: the result's {what} edits are "
                                 f"not the served sets' difference")
    if set(res.pair_ids) != set(res.new_pairs):
        raise AssertionError(f"{label}: pair ids for {len(res.pair_ids)} "
                             f"of {len(res.new_pairs)} new pairs")
    return now


def phase_serve(main_rec):
    """M9 + M10 on the card: phase main's generator and config at a base
    corpus of SERVE_BASE records, bootstrapped into a traced
    ``ResolutionService`` on the card (its worker thread started), then
    SERVE_OPS micro-batches of SERVE_BATCH fresh inserts with a delete of
    SERVE_DELETE random live entities after every 4th (the reference's
    serving mix, ``benchmarks/bench_sn.py::serve_body``), every other op
    through the futures API.  Gates: every result is the served sets'
    difference, every delta call launched K1 (one ``shard_program`` span a
    call), the served sets equal a fresh resolve of the live corpus on the
    card, and a snapshot restored on the card serves the same sets under
    the same pair ids; K1 is then held against its plain version at every
    shape the delta calls gave it."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import entities as E
    from repro_torch.kernels import ops

    n_all = SERVE_BASE + SERVE_OPS * SERVE_BATCH
    host = E.synth_arrays(np.random.default_rng(0), n_all, n_keys=N_KEYS,
                          dup_frac=0.2, text_len=16)
    cfg = api.ERConfig(**_cfg_kw(variant="repsn", runner="vmap",
                                 partitioner="balanced",
                                 band_engine="pallas", trace=True))
    _fresh_cache()
    ops.reset_launch_counts()
    with _Recorded() as seen:
        svc, bootstrap_s = wall(lambda: api.serve(
            cfg, initial=E.host_take(host, slice(0, SERVE_BASE)),
            device="cuda"))
        try:
            live = np.arange(n_all) < SERVE_BASE
            rng = np.random.default_rng(1)
            prev = (svc.packed_pairs, svc.packed_matches)
            op_s = {"insert": [], "delete": []}
            n_ops = 0
            # (traces, distinct delta shapes) after every batch: a trace
            # only where a batch brought a shape bucket not seen before
            growth = [(svc.stats().traces, len(svc.stats().shapes))]

            def apply(kind, arg):
                nonlocal prev, n_ops
                via_future = n_ops % 2 == 1
                t0 = time.perf_counter()
                if kind == "insert":
                    res = svc.submit_insert(arg).result(timeout=600) \
                        if via_future else svc.resolve_incremental(arg)
                else:
                    res = svc.submit_delete(arg).result(timeout=600) \
                        if via_future else svc.delete(arg)
                op_s[kind].append(time.perf_counter() - t0)
                prev = _check_edit(f"serve op {n_ops} ({kind})", svc, res,
                                   prev)
                growth.append((res.stats.traces, len(res.stats.shapes)))
                n_ops += 1

            for op in range(SERVE_OPS):
                lo = SERVE_BASE + op * SERVE_BATCH
                apply("insert",
                      E.host_take(host, slice(lo, lo + SERVE_BATCH)))
                live[lo:lo + SERVE_BATCH] = True
                if op % 4 == 3:
                    gone = rng.choice(np.flatnonzero(live), SERVE_DELETE,
                                      replace=False)
                    apply("delete", host["eid"][gone])
                    live[gone] = False
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            peak, peak_reserved = _gb_cap("serve")
            st = svc.stats()
            report = svc.trace_report()
        finally:
            svc.close(timeout=600)
    programs = [s for s in report.spans if s.name == "shard_program"]
    if not st.device_calls == len(programs) == launches["fused_band"]:
        raise AssertionError(f"serve: {st.device_calls} delta calls, "
                             f"{len(programs)} shard_program spans, K1 "
                             f"launched {launches['fused_band']} times")
    if st.batches != n_ops + 1 or st.failure is not None or \
            st.degraded_batches or st.live_entities != int(live.sum()):
        raise AssertionError(f"serve: stats {st}")
    if any(t != k for t, k in growth) or st.traces != st.cache_misses or \
            not st.steady_batches > 0 or not st.cache_hits > 0:
        raise AssertionError(f"serve: (traces, shapes) after each batch "
                             f"{growth}; stats {st}")
    # the delta calls' shard programs (the bootstrap's first call aside),
    # each a graph replay once its shape was captured
    delta_ms = [p.dur * 1e3 for p in programs[1:]]

    # the served sets against a fresh resolve of the live corpus
    alive = E.host_take(host, np.flatnonzero(live))
    fresh, fresh_s = wall(lambda: api.resolve(
        E.make_entities(alive["key"], alive["eid"], payload=alive["payload"],
                        device="cuda"), cfg.with_(trace=False),
        device="cuda"))
    fresh_sets = _packed_sets(fresh)
    del fresh
    _assert_equal("serve blocked vs a fresh resolve", svc.packed_pairs,
                  fresh_sets[0])
    _assert_equal("serve matched vs a fresh resolve", svc.packed_matches,
                  fresh_sets[1])

    # a snapshot restored on the card: same sets, same pair ids
    snap = ROOT / "build" / "serve_snapshot"
    shutil.rmtree(snap, ignore_errors=True)
    snapshot_s = wall(lambda: svc.snapshot(str(snap)))[1]
    back, restore_s = wall(lambda: api.ResolutionService.restore(
        str(snap), cfg, start=False, device="cuda"))
    shutil.rmtree(snap)
    _assert_equal("serve restored blocked", back.packed_pairs,
                  svc.packed_pairs)
    _assert_equal("serve restored matched", back.packed_matches,
                  svc.packed_matches)
    if back._pair_ids != svc._pair_ids or back.device.type != "cuda":
        raise AssertionError("serve: the restored service's pair ids or "
                             "device differ")
    del back

    # K1 at every shape the delta calls gave it (after the counts were
    # read), the bootstrap's included
    k1 = [_k1_at(m, f"serve delta shape {(r, m, f, words, window)}",
                 shards=r, f=f, words=words, window=window)
          for r, m, f, words, window in sorted(seen.k1_shapes)]
    inserted = SERVE_OPS * SERVE_BATCH
    rec = {"phase": "serve", "n_base": SERVE_BASE, "w": W, "r": R,
           "hops": HOPS, "variant": "repsn", "band_engine": "pallas",
           "trace": True, "ops": SERVE_OPS, "batch": SERVE_BATCH,
           "delete_every_4th": SERVE_DELETE,
           "shard_buckets": [2, 4, 8], "cap_floor": 64,
           "reduced": ["base corpus 1.4M -> 350,000: at 1.4M the "
                       "bootstrap's one region pads to 2 x 2,097,152 rows "
                       "and its edit-DP buffer to 2 x 18.9M slots, three "
                       "times phase main's; and the script's time limit"],
           "bootstrap_s": bootstrap_s, "p50_ms": st.p50_ms,
           "p95_ms": st.p95_ms,
           "insert_op_s": op_s["insert"], "delete_op_s": op_s["delete"],
           "inserts_per_s": inserted / sum(op_s["insert"]),
           "max_memory_allocated": peak,
           "max_memory_reserved": peak_reserved,
           "main_max_memory_allocated": main_rec["max_memory_allocated"],
           "launches": launches, "device_calls": st.device_calls,
           "cache": {"steady_batches": st.steady_batches,
                     "cache_hits": st.cache_hits,
                     "cache_misses": st.cache_misses, "traces": st.traces,
                     "traces_and_shapes_per_batch": growth},
           "delta_program_ms": {
               "mean": statistics.mean(delta_ms),
               "median": statistics.median(delta_ms),
               "calls": len(delta_ms),
               "eager_mean_earlier_run": SERVE_PROGRAM_MS_EAGER_EARLIER},
           "shapes": [list(x) for x in st.shapes],
           "rows_per_shard": sorted({p.attrs["rows_per_shard"]
                                        for p in programs}),
           "k1_at_serve_shapes": k1,
           "batches": st.batches, "compactions": st.compactions,
           "live_entities": st.live_entities, "pairs": st.pairs,
           "matches": st.matches,
           "span_coverage": report.coverage(),
           "span_totals": _span_seconds(report)[0],
           "fresh_resolve_s": fresh_s, "snapshot_s": snapshot_s,
           "restore_s": restore_s, "fresh_equal": True,
           "restored_equal": True}
    emit(rec)
    _fresh_cache()
    return rec


def phase_shard_map():
    """The shard_map runner on the card: a world-size-1 NCCL mesh (a
    process group on an in-process store), every variant x band engine at
    phase parity's n with r = 1 — blocked and matched sets equal to
    ``VmapRunner(1)``'s and to the sequential oracle's, zero overflow, K1
    launched on every pallas shard program, and a second call that is a
    cache hit (its graph, NCCL collectives inside, replayed); the group is
    destroyed at the end."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import entities as E
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh_compat
    from repro_torch.perf import executable_cache

    ents = E.synth_entities(np.random.default_rng(1), N_PARITY,
                            n_keys=N_KEYS, dup_frac=0.2, text_len=16)
    seq, seq_s = wall(lambda: api.resolve(
        ents, api.ERConfig(**_cfg_kw(variant="repsn", runner="sequential",
                                     num_shards=1, hops=1)),
        device="cuda"))
    oracle = _packed_sets(seq)
    del seq
    _fresh_cache()
    mesh = make_mesh_compat((1,), ("data",), device="cuda")
    rows, launches = [], 0
    try:
        backend = dist.get_backend(mesh.group)
        if backend != "nccl":
            raise AssertionError(f"shard_map: a {backend} group on the card")
        for variant in ("srp", "repsn", "jobsn"):
            for engine in ("scan", "pallas"):
                label = f"shard_map {variant}/{engine}"
                cfg = api.ERConfig(**_cfg_kw(
                    variant=variant, runner="shard_map", num_shards=1,
                    hops=1, band_engine=engine))
                vm = _packed_sets(api.resolve(
                    ents, cfg.with_(runner="vmap"), device="cuda"))
                calls = []
                for _ in range(2):
                    before = _k1_launches()
                    res, secs = wall(lambda: api.resolve(
                        ents, cfg, mesh=mesh, device="cuda"))
                    calls.append((res, secs, _k1_launches() - before))
                for res, _, k1 in calls:
                    _zero_overflow(res, label)
                    got = _packed_sets(res)
                    for what, want in (("vmap", vm), ("oracle", oracle)):
                        _assert_equal(f"{label} blocked vs {what}", got[0],
                                      want[0])
                    for what, want in (("vmap", vm), ("oracle", oracle)):
                        _assert_equal(f"{label} matched vs {what}", got[1],
                                      want[1])
                    if engine == "pallas" and k1 < 1:
                        raise AssertionError(f"{label}: K1 launched {k1} "
                                             f"times")
                    launches += k1
                cold, hot = (_perf(c[0]) for c in calls)
                if (cold["cache_misses"], cold["traces"]) != (1, 1) or \
                        not hot["steady_state"]:
                    raise AssertionError(f"{label}: cold {cold}, second "
                                         f"{hot}")
                rows.append({"variant": variant, "engine": engine,
                             "blocked": int(got[0].size),
                             "matched": int(got[1].size),
                             "cold_s": calls[0][1], "steady_s": calls[1][1],
                             "k1_launches": [c[2] for c in calls],
                             "cold_perf": cold, "steady_perf": hot})
                del calls, res
        peak = _gb_cap("shard_map")
    finally:
        executable_cache().clear()
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("shard_map: the process group outlived the "
                             "phase")
    rec = {"phase": "shard_map", "n": N_PARITY, "world_size": 1,
           "backend": backend, "mesh": mesh.shape, "w": W,
           "reduced": ["n 1.4M -> 50,000 (phase parity's corpus): the "
                       "script's time limit"],
           "sequential_s": seq_s, "runs": rows,
           "launches": {"fused_band": launches},
           "equal": True, "graph_replayed_with_nccl": True,
           "max_memory_allocated": peak[0], "max_memory_reserved": peak[1]}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def _kernel_us(prof):
    """{name: (launches, device us)} of the device events of a finished
    ``torch.profiler`` run, read from its raw kineto events: a prefill
    records ~600k, which ``key_averages`` parses into Python objects in
    about a minute."""
    import torch
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            n, us = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return out


class _LMRecorded:
    """While entered, wraps the LM path's ``attention.flash_attention``
    (counts the calls that take K4's route, keeps the q, k, v of the first
    such call) and ``lm.forward`` (ANDs whether every logit it returned
    is finite into the device flag ``finite``, so no sync); with
    ``timing`` set, CUDA events around each local and global attention
    call and each MLP (``blocks.mlp_apply``).  All restored on exit."""

    def __enter__(self):
        import torch
        from repro_torch.models import attention as A
        from repro_torch.models import blocks, lm
        self.k4_calls, self.qkv, self.timing = 0, None, False
        self.events = {"attn_local": [], "attn_global": [], "mlp": []}
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")
        self.saved = A.flash_attention, lm.forward, blocks.mlp_apply
        flash, forward, mlp = self.saved

        def timed(name, fn):
            if not self.timing:
                return fn()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            self.events[name].append((a, b))
            return out

        def flash_attention(q, k, v, **kw):
            if q.device.type == "cuda" and A.local_attn_route(
                    q.shape, k.shape, causal=kw.get("causal", True),
                    window=kw.get("window", 0),
                    q_offset=kw.get("q_offset", 0)):
                self.k4_calls += 1
                if self.qkv is None:
                    self.qkv = (q, k, v, dict(kw))
            name = "attn_local" if kw.get("window") else "attn_global"
            return timed(name, lambda: flash(q, k, v, **kw))

        def forward_(*args, **kw):
            out = forward(*args, **kw)
            self.finite &= torch.isfinite(out[0]).all()
            return out

        def mlp_apply(*args, **kw):
            return timed("mlp", lambda: mlp(*args, **kw))

        A.flash_attention, lm.forward, blocks.mlp_apply = \
            flash_attention, forward_, mlp_apply
        return self

    def event_ms(self):
        """{name: summed ms} of the timed calls (after a synchronize)."""
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.models import blocks, lm
        A.flash_attention, lm.forward, blocks.mlp_apply = self.saved


def _lm_k4_at_model_shape(qkv):
    """K4 at the LM's own shape: one local layer's q, k, v from the real
    prefill through ``flash_attention``'s K4 route and through the plain
    chunk-pair scan (TOL_ATTN_MODEL, which must also reject the scan with
    the window one key short); K4 timed on the (B*H, S, D) operands the
    route hands it, in turns with compiled flex_attention there, beside
    its bound and the scan's time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    q, k, v, kw = qkv
    b, s, h, d = q.shape
    g = h // k.shape[2]
    window, cap = kw["window"], kw["logit_softcap"]
    plain = dict(causal=True, window=window, logit_softcap=cap)
    got = A.flash_attention(q, k, v, **plain)
    want = A.flash_attention_scan(q, k, v, **plain)
    err = _hold("local_attn", got, want, TOL_ATTN_MODEL, "lm layer")
    short_err = _must_reject(
        "local_attn", got, A.flash_attention_scan(
            q, k, v, **dict(plain, window=window - 1)),
        TOL_ATTN_MODEL, "lm layer against window - 1")
    del got, want
    heads = lambda x: x.transpose(1, 2).reshape(b * h, s, d).contiguous()
    qh, kh, vh = heads(q), heads(k.repeat_interleave(g, dim=2)), \
        heads(v.repeat_interleave(g, dim=2))
    k4 = lambda: ops.local_attn(qh, kh, vh, window=window, softcap=cap)
    # the library yardstick at this shape: compiled flex_attention with
    # the band as a block mask and the softcap as a score_mod, in turns
    # with K4
    flex = _flex(qh, kh, vh, window, cap)
    flex_err = _library_err(flex, k4(), ATTN_HEADS_CHECKED)
    turns = _in_turns([("kernel", k4)] + ([("flex_attention", flex)]
                                           if flex is not None else []),
                      reps=10)
    plain_ms = cuda_ms(lambda: A.flash_attention_scan(q, k, v, **plain),
                       reps=2, warm=1)
    bh = b * h
    rec = {"shape": {"BH": bh, "S": s, "D": d, "window": window,
                     "softcap": cap, "dtype": str(q.dtype).split(".")[1],
                     "q_heads": h, "kv_heads": k.shape[2]},
           "max_abs_err": err, "tol": TOL_ATTN_MODEL,
           "window_minus_1_max_abs_err": short_err,
           "kept_pairs": _kept_pairs(bh, s, window),
           "ms": statistics.mean(turns["kernel"]),
           "flex_attention_ms": statistics.mean(turns["flex_attention"])
           if flex is not None else None,
           "flex_vs_kernel_max_abs_err": flex_err, "turns_ms": turns,
           "plain_scan_ms": plain_ms,
           **_bound(4 * bh * s * d * q.element_size(),
                    _kept_pairs(bh, s, window) * 4 * d, BF16_OPS_PER_S)}
    del qh, kh, vh, flex
    return rec


def _lm_cache_check(params, cfg, gen):
    """Cache semantics on the card: a prefill of LM_CHECK_PROMPT tokens
    plus LM_CHECK_DECODE decode steps give the logits of one forward over
    the same tokens, within LM_CHECK_TOL (both sides' attention through
    K4 on the local layers); every logit finite.  Returns the record."""
    import torch
    from repro_torch.models import lm
    n = LM_CHECK_PROMPT + LM_CHECK_DECODE
    toks = torch.randint(0, cfg.vocab_size, (LM_CHECK_BATCH, n),
                         generator=gen, device="cuda", dtype=torch.int32)
    cache = lm.cache_init(cfg, LM_CHECK_BATCH, n, torch.bfloat16,
                          device="cuda")
    pre, cache, _ = lm.forward(params, cfg, tokens=toks[:, :LM_CHECK_PROMPT],
                               cache=cache, logits_last_only=True,
                               device="cuda")
    steps = [pre[:, -1]]
    for t in range(LM_CHECK_PROMPT, n):
        out, cache, _ = lm.forward(params, cfg, tokens=toks[:, t:t + 1],
                                   cache=cache, cache_pos=t + 1,
                                   device="cuda")
        steps.append(out[:, -1])
    del cache
    got = torch.stack(steps, dim=1)               # positions P-1 .. n-1
    full = lm.forward(params, cfg, tokens=toks, device="cuda")[0][
        :, LM_CHECK_PROMPT - 1:n]
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(got).all()) and
            bool(torch.isfinite(full).all())):
        raise AssertionError("lm cache check: non-finite logits")
    err = (got - full).abs()
    worst = float(err.max())
    rec = {"batch": LM_CHECK_BATCH, "prompt": LM_CHECK_PROMPT,
           "decode_steps": LM_CHECK_DECODE, "forward_tokens": n,
           "max_abs_err": worst, "mean_abs_err": float(err.mean()),
           "logit_abs_max": float(full.abs().max()), "tol": LM_CHECK_TOL,
           "argmax_agree": float((got.argmax(-1) == full.argmax(-1))
                                 .float().mean())}
    if not worst <= LM_CHECK_TOL:
        raise AssertionError(f"lm cache check: prefill + decode vs forward "
                             f"max abs err {worst} > {LM_CHECK_TOL}")
    return rec


def phase_lm():
    """The LM scaffold's serving path on the card: Gemma-2-9B at full
    width and depth (random bf16 weights from a seeded generator) through
    ``train.steps.make_prefill_step`` then ``make_decode_step``; the
    prefill's 21 local layers through K4 (``flash_attention``'s route),
    its 21 global layers through the plain f32 chunk-pair scan.  Gates:
    K4's launches = 21 x the K4-routed prefill calls, K4 against the
    plain scan at one real layer's q, k, v, prefill + decode against one
    forward, every logit finite, reserved memory <= RESERVED_CAP."""
    import statistics as st

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.modules import param_bytes, param_count
    from repro_torch.train import steps

    _fresh_cache()
    lap = _Laps()
    cfg = get_config(LM_ARCH)
    max_len = SHAPES["decode_32k"].seq_len
    n_local = cfg.pattern.count("attn_local") * cfg.n_groups
    run = RunConfig(model=cfg, shape=ShapeConfig("lm", max_len, LM_BATCH,
                                                 "decode"))
    gen = torch.Generator("cuda").manual_seed(LM_SEED)
    params, init_s = wall(lambda: lm.lm_init(gen, cfg, torch.bfloat16,
                                             device="cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    cache = lm.cache_init(cfg, LM_BATCH, max_len, torch.bfloat16,
                          device="cuda")
    cache_bytes = param_bytes(cache)
    prefill = steps.make_prefill_step(cfg, run)
    decode = steps.make_decode_step(cfg, run)
    lap("init")

    ops.reset_launch_counts()
    with _LMRecorded() as seen:
        # the prefill, traced by the profiler (CUDA activity only: the
        # kernels' device time; no measurable cost, PERF.md §6) with its
        # attention and MLPs timed by CUDA events
        seen.timing = True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (tok, cache), prefill_s = wall(
                lambda: prefill(params, {"tokens": prompt}, cache))
        seen.timing = False
        lap("prefill")
        parts_ms = seen.event_ms()
        kernels = _kernel_us(prof)
        del prof
        busy_us = sum(us for _, us in kernels.values())
        k4_us = sum(us for k, (_, us) in kernels.items() if "local_attn" in k)
        k4_in_profile = sum(n for k, (n, _) in kernels.items()
                            if "local_attn" in k)
        top = [[k[:80], n, us / 1e3] for k, (n, us) in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])[:8]]
        lap("profile_read")
        generated, decode_ms = [tok], []
        for i in range(LM_DECODE):
            (tok, cache), secs = wall(lambda: decode(
                params, tok[:, None], cache, LM_PROMPT + i + 1))
            generated.append(tok)
            decode_ms.append(secs * 1e3)
        lap("decode")
        # one more decode step (the last token again), profiled: the
        # device's share of a step (its result is not used)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, step_s = wall(lambda: decode(
                params, tok[:, None], cache, LM_PROMPT + LM_DECODE + 1))
        step_kernels = _kernel_us(prof)
        del prof
        step_busy_us = sum(us for _, us in step_kernels.values())
        step_top = [[k[:80], n, us / 1e3] for k, (n, us) in sorted(
            step_kernels.items(), key=lambda kv: -kv[1][1])[:6]]
        lap("decode_profile")
        del cache
        serve_peak = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
        emit({"phase": "lm/serve", "init_s": init_s, "prefill_s": prefill_s,
              "decode_ms_median": st.median(decode_ms),
              "k4_in_one_prefill_ms": k4_us / 1e3,
              "max_memory_allocated": serve_peak[0],
              "max_memory_reserved": serve_peak[1]})
        torch.cuda.empty_cache()
        check = _lm_cache_check(params, cfg, gen)
        torch.cuda.synchronize()
        lap("cache_check")
        launches = ops.launch_counts()
        routed_layers, qkv, finite = seen.k4_calls, seen.qkv, \
            bool(seen.finite)
    routed_calls = 3      # the prefill, the check's prefill and forward
    if launches["local_attn"] != n_local * routed_calls or \
            routed_layers != n_local * routed_calls or k4_in_profile != n_local:
        raise AssertionError(
            f"lm: K4 launched {launches['local_attn']} times, routed "
            f"{routed_layers} layer calls, {k4_in_profile} in the profiled "
            f"prefill; want {n_local} x {routed_calls} prefill calls")
    if not finite:
        raise AssertionError("lm: a forward returned non-finite logits")
    toks = torch.stack(generated, dim=1)
    if toks.shape != (LM_BATCH, LM_DECODE + 1) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"lm: generated tokens {toks.tolist()}")
    torch.cuda.empty_cache()
    k4 = _lm_k4_at_model_shape(qkv)
    lap("k4_gate")
    del qkv, seen
    peak = _gb_cap("lm")
    rec = {"phase": "lm", "arch": LM_ARCH, "seed": LM_SEED,
           "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                      "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                      "vocab_size": cfg.vocab_size,
                      "window_size": cfg.window_size,
                      "pattern": list(cfg.pattern)},
           "batch": LM_BATCH, "prompt_tokens": LM_PROMPT,
           "cache_tokens": max_len, "decode_steps": LM_DECODE,
           "reduced": ["batch 32 (prefill_32k) and 128 (decode_32k) -> 2: "
                       "one card's memory holds the model plus an 11.3 GB "
                       "global KV cache at batch 2"],
           "params": param_count(params), "param_bytes": param_bytes(params),
           "cache_bytes": cache_bytes, "init_s": init_s,
           "prefill_s": prefill_s,
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
           "prefill_parts_ms": parts_ms,
           "prefill_kernel_busy_ms": busy_us / 1e3,
           "prefill_idle_share": 1.0 - busy_us / 1e6 / prefill_s,
           "k4_in_one_prefill_ms": k4_us / 1e3,
           "k4_in_one_prefill_launches": k4_in_profile,
           "prefill_top_kernels_ms": top,
           "decode_ms_median": st.median(decode_ms),
           "decode_ms": decode_ms,
           "decode_tokens_per_s": LM_BATCH * 1e3 / st.median(decode_ms),
           "decode_profiled_step_ms": step_s * 1e3,
           "decode_step_kernel_busy_ms": step_busy_us / 1e3,
           "decode_step_top_kernels_ms": step_top,
           "generated": toks[:, :8].tolist(),
           "launches": launches, "k4_routed_prefill_calls": routed_calls,
           "k4_at_model_shape": k4, "cache_check": check,
           "logits_finite": finite,
           "serve_max_memory_allocated": serve_peak[0],
           "serve_max_memory_reserved": serve_peak[1],
           "max_memory_allocated": peak[0], "max_memory_reserved": peak[1],
           "laps_s": lap.seconds}
    emit(rec)
    del params
    _fresh_cache()
    return rec


class _Killed(BaseException):
    """A kill of the train launcher's process, simulated: no handler of
    the loop catches it."""


def _train_launch(args, *, fault_at=None, kill_after=None):
    """``launch.train.main(args)``, its output captured; ``fault_at``: the
    loop's ``inject_fault_at``; ``kill_after``: the loop is killed when
    it asks for step ``kill_after + 1`` (its pending checkpoint write
    finished first).  Returns (stats or None, the printed lines)."""
    import contextlib
    import io

    from repro_torch.launch import train as launch
    loop = launch.train_loop

    def train_loop(train_step, state, batcher, ckpt, cfg, **kw):
        calls = [0]

        def step(st, batch):
            calls[0] += 1
            if kill_after is not None and calls[0] > kill_after:
                raise _Killed()
            return train_step(st, batch)
        try:
            return loop(step, state, batcher, ckpt, cfg,
                        inject_fault_at=fault_at, **kw)
        finally:
            ckpt.wait()

    out = io.StringIO()
    launch.train_loop = train_loop
    try:
        with contextlib.redirect_stdout(out):
            stats = launch.main(args)
    except _Killed:
        stats = None
    finally:
        launch.train_loop = loop
    return stats, out.getvalue().splitlines()


def _same_checkpoints(a, b) -> int:
    """Raise unless two checkpoint files hold the same arrays bit for bit;
    returns the number of arrays."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            raise AssertionError(f"{a} and {b} hold other leaves")
        for k in x.files:
            if x[k].dtype != y[k].dtype or x[k].tobytes() != y[k].tobytes():
                raise AssertionError(f"{a} and {b} differ at {k}")
        return len(x.files)


def _train_parity():
    """Part 1: two train steps of the launcher's 100m preset in f32, on the
    card and on the CPU from one seeded state and the launcher's batches:
    loss, grad norm, lr and every leaf of the state within the stated
    tolerances."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.corpus import TokenBatcher, synth_corpus
    from repro_torch.launch.train import hundred_m_variant
    from repro_torch.models.modules import tree_items, tree_map
    from repro_torch.train import optim, steps

    cfg = hundred_m_variant(get_config(TRAIN_ARCH))
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "100m", TRAIN_SEQ, TRAIN_BATCH, "train"), remat="block")
    oc = optim.OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    cpu = steps.train_state_init(TRAIN_SEED, cfg, torch.float32,
                                 device="cpu")
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    docs = synth_corpus(0, n_docs=4096, doc_len=TRAIN_SEQ,
                        vocab=cfg.vocab_size, dup_frac=0.25)
    batcher = TokenBatcher(docs, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    step = steps.make_train_step(cfg, run, None, oc)
    rows, lr_sum = [], 0.0
    for i in range(TRAIN_PARITY_STEPS):
        batch = batcher.batch(i)
        (_, got), card_s = wall(lambda: step(card, batch))
        t0 = time.perf_counter()
        _, want = step(cpu, batch)
        cpu_s = time.perf_counter() - t0
        got = {k: float(v) for k, v in got.items()}
        want = {k: float(v) for k, v in want.items()}
        if not (abs(got["loss"] - want["loss"]) <= TRAIN_LOSS_RTOL
                * abs(want["loss"]) and abs(got["grad_norm"] -
                                            want["grad_norm"])
                <= TRAIN_NORM_RTOL * want["grad_norm"]
                and abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"]):
            raise AssertionError(f"train parity step {i}: card {got}, cpu "
                                 f"{want}")
        lr_sum += want["lr"]
        rows.append({"step": i, "card": got, "cpu": want, "card_s": card_s,
                     "cpu_s": cpu_s})
    worst = {"param_max_abs_err": 0.0, "moment_rel_err": 0.0}
    far = total = 0
    want_items = dict(tree_items(cpu))
    for k, t in tree_items(card):
        g, w = t.cpu().double().numpy(), want_items[k].double().numpy()
        d = np.abs(g - w)
        if k.startswith("['params']"):
            far += int((d > TRAIN_PARAM_ATOL).sum())
            total += d.size
            worst["param_max_abs_err"] = max(worst["param_max_abs_err"],
                                             float(d.max()))
            if d.max() > 2.2 * lr_sum:
                raise AssertionError(f"train parity {k}: max abs err "
                                     f"{d.max()} > 2.2 x lr {lr_sum}")
        elif k.startswith("['opt']['step']"):
            if not np.array_equal(g, w):
                raise AssertionError(f"train parity {k}: {g} vs {w}")
        else:
            rel = float(d.max()) / max(float(np.abs(w).max()), 1e-30)
            worst["moment_rel_err"] = max(worst["moment_rel_err"], rel)
            if rel > TRAIN_MOMENT_RTOL:
                raise AssertionError(f"train parity {k}: {rel} of its "
                                     f"largest entry")
    if far > TRAIN_FLIP_SHARE * total:
        raise AssertionError(f"train parity: {far} of {total} params beyond "
                             f"{TRAIN_PARAM_ATOL}")
    return {"arch": TRAIN_ARCH, "preset": "100m", "dtype": "float32",
            "params": total, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "remat": "block", "steps": rows, **worst,
            "params_beyond_atol": far,
            "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                    "grad_norm_rtol": TRAIN_NORM_RTOL,
                    "param_atol": TRAIN_PARAM_ATOL,
                    "param_far_share": TRAIN_FLIP_SHARE,
                    "moment_rtol": TRAIN_MOMENT_RTOL}}


def _train_launcher(root):
    """Part 2: ``launch.train.main`` at --preset 100m --dedup on the card,
    under deterministic algorithms (the embedding's backward scatters with
    atomics otherwise): a straight run, a run with a fault injected, and a
    run killed after step TRAIN_KILL_AFTER then resumed with --resume.
    Gates: the loss falls, one restore after the fault, and the faulted
    and the resumed runs end on the straight run's checkpoint bit for
    bit."""
    import shutil

    import numpy as np
    import torch
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--preset", "100m", "--dedup",
            "--steps", str(TRAIN_STEPS), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--seq-len", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--device", "cuda"]
    final = f"step_{TRAIN_STEPS}.npz"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (straight, lines), straight_s = wall(lambda: _train_launch(
            args + ["--ckpt-dir", str(root / "straight")]))
        (faulted, _), faulted_s = wall(lambda: _train_launch(
            args + ["--ckpt-dir", str(root / "faulted")],
            fault_at=TRAIN_FAULT_AT))
        (killed, _), killed_s = wall(lambda: _train_launch(
            args + ["--ckpt-dir", str(root / "resumed")],
            kill_after=TRAIN_KILL_AFTER))
        (resumed, _), resumed_s = wall(lambda: _train_launch(
            args + ["--ckpt-dir", str(root / "resumed"), "--resume"]))
    finally:
        torch.use_deterministic_algorithms(False)
    first, last = np.mean(straight.losses[:5]), np.mean(straight.losses[-5:])
    if straight.steps != TRAIN_STEPS or not last < first:
        raise AssertionError(f"train launcher: {straight.steps} steps, mean "
                             f"loss {first} over the first 5, {last} over "
                             f"the last 5")
    if faulted.restores != 1 or killed is not None or \
            resumed.steps != TRAIN_STEPS - TRAIN_KILL_AFTER:
        raise AssertionError(f"train launcher: {faulted.restores} restores "
                             f"after the fault, resumed {resumed.steps} "
                             f"steps")
    leaves = _same_checkpoints(root / "straight" / final,
                               root / "faulted" / final)
    _same_checkpoints(root / "straight" / final, root / "resumed" / final)
    ckpt_bytes = (root / "straight" / final).stat().st_size
    rec = {"args": args, "dedup": next(x for x in lines
                                       if x.startswith("[dedup]")),
           "losses": straight.losses, "first5_mean": float(first),
           "last5_mean": float(last),
           "step_ms_median": statistics.median(straight.step_times) * 1e3,
           "straight_s": straight_s, "faulted_s": faulted_s,
           "faulted_restores": faulted.restores, "fault_at": TRAIN_FAULT_AT,
           "killed_after": TRAIN_KILL_AFTER, "killed_s": killed_s,
           "resumed_s": resumed_s, "resumed_steps": resumed.steps,
           "checkpoint_bytes": ckpt_bytes, "checkpoint_leaves": leaves,
           "faulted_equals_straight": True, "resumed_equals_straight": True}
    shutil.rmtree(root, ignore_errors=True)
    return rec


def _fingerprint(params) -> list:
    """A per-leaf fingerprint of a param tree: f64 sums, a slice of 2**24
    elements at a time (an f64 copy of Phi-4-mini's largest leaf would be
    6.4 GB)."""
    from repro_torch.models.modules import tree_items
    return [sum(float(s.double().sum()) for s in t.reshape(-1).split(1 << 24))
            for _, t in tree_items(params)]


def _train_full():
    """Part 3: Phi-4-mini at full width and depth, bf16 weights from a
    seeded generator: a cold step, TRAIN_FULL_STEPS timed steps and one
    profiled step on one repeated batch of train_4k's sequence; one step
    split by CUDA events into forward + backward and the optimizer; then,
    the train state freed, the same weights drawn again, in f32, and their
    loss on the batch under no_grad against the step-0 bf16 loss.  Gates:
    every loss finite, the first update lowering the batch's loss (a
    single repeated sequence at lr 3e-4 oscillates after it), the f32
    loss within TRAIN_BF16_LOSS_TOL, reserved memory <= RESERVED_CAP."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import lm
    from repro_torch.models.modules import param_bytes, param_count, tree_map
    from repro_torch.train import optim, steps

    lap = _Laps()
    cfg = get_config(TRAIN_ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train_4k", TRAIN_FULL_SEQ, TRAIN_FULL_BATCH, "train"), remat="block")
    oc = optim.OptConfig(lr=3e-4, warmup_steps=2)
    gen = torch.Generator("cuda").manual_seed(TRAIN_SEED)
    state, init_s = wall(lambda: steps.train_state_init(
        gen, cfg, torch.bfloat16, device="cuda"))
    n_params = param_count(state["params"])
    state_bytes = param_bytes(state)
    weights0 = _fingerprint(state["params"])
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_FULL_BATCH,
                                             TRAIN_FULL_SEQ),
                         generator=gen, device="cuda", dtype=torch.int32)
    labels = torch.cat([toks[:, 1:], torch.full(
        (TRAIN_FULL_BATCH, 1), -1, dtype=torch.int32, device="cuda")], 1)
    batch = {"tokens": toks, "labels": labels}
    step = steps.make_train_step(cfg, run, None, oc)
    lap("init")
    # the step updates ``state`` in place and returns it: keep no second
    # reference, so that freeing ``state`` frees the 44.5 GB
    m, cold_s = wall(lambda: step(state, batch)[1])
    losses, lrs = [float(m["loss"])], [float(m["lr"])]
    lap("cold")
    step_s = []
    for _ in range(TRAIN_FULL_STEPS):
        m, secs = wall(lambda: step(state, batch)[1])
        step_s.append(secs)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    lap("timed")
    # one step split by CUDA events around the optimizer update
    update = optim.adamw_update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def timed_update(*a, **kw):
        ev[1].record()
        out = update(*a, **kw)
        ev[2].record()
        return out
    optim.adamw_update = timed_update
    try:
        ev[0].record()
        m, split_s = wall(lambda: step(state, batch)[1])
    finally:
        optim.adamw_update = update
    fwd_bwd_ms, opt_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    losses.append(float(m["loss"]))
    lap("split")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m, prof_s = wall(lambda: step(state, batch)[1])
    kernels = _kernel_us(prof)
    del prof
    losses.append(float(m["loss"]))
    busy_us = sum(us for _, us in kernels.values())
    top = [[k[:80], n, us / 1e3] for k, (n, us) in sorted(
        kernels.items(), key=lambda kv: -kv[1][1])[:10]]
    lap("profile")
    peak = _gb_cap("train/full")
    del state, m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the step-0 loss again, in f32, on the same weights (drawn again from
    # the seed), the optimizer state freed
    gen = torch.Generator("cuda").manual_seed(TRAIN_SEED)
    params = lm.lm_init(gen, cfg, torch.bfloat16, device="cuda")
    if _fingerprint(params) != weights0:
        raise AssertionError("train full: the weights drawn again differ")
    params = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        f32_loss, _ = lm.lm_loss(params, cfg, batch, remat="none",
                                 device="cuda")
    f32_loss = float(f32_loss)
    del params
    check_peak = _gb_cap("train/full f32 check")
    torch.cuda.empty_cache()
    lap("f32_check")
    if not all(math.isfinite(x) for x in losses + [f32_loss]):
        raise AssertionError(f"train full: losses {losses}, f32 {f32_loss}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"train full: the first update raised the "
                             f"repeated batch's loss {losses[0]} -> "
                             f"{losses[1]}")
    if not abs(losses[0] - f32_loss) <= TRAIN_BF16_LOSS_TOL:
        raise AssertionError(f"train full: step-0 bf16 loss {losses[0]} vs "
                             f"f32 {f32_loss} > {TRAIN_BF16_LOSS_TOL}")
    med = statistics.median(step_s)
    tokens = TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    return {"arch": TRAIN_ARCH, "seed": TRAIN_SEED, "params": n_params,
            "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                       "vocab_size": cfg.vocab_size,
                       "tie_embeddings": cfg.tie_embeddings},
            "batch": TRAIN_FULL_BATCH, "seq": TRAIN_FULL_SEQ,
            "remat": "block", "opt": {"lr": oc.lr,
                                      "warmup_steps": oc.warmup_steps},
            "reduced": ["train_4k's global batch 256 -> 1: one card holds "
                        "the 53.4 GB of bf16 params, f32 moments and bf16 "
                        "grads plus one sequence's activations and f32 "
                        "logits", "no checkpoint (the state is 44.5 GB)"],
            "state_bytes": state_bytes, "init_s": init_s, "cold_s": cold_s,
            "step_s": step_s, "step_s_median": med,
            "tokens_per_s": tokens / med,
            "model_flops_per_s": 6 * n_params * tokens / med,
            "model_flops_share_of_bf16_peak":
                6 * n_params * tokens / med / BF16_OPS_PER_S,
            "split_step_s": split_s, "fwd_bwd_ms": fwd_bwd_ms,
            "optimizer_ms": opt_ms, "profiled_step_s": prof_s,
            "kernel_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / prof_s,
            "top_kernels_ms": top, "losses": losses, "lrs": lrs,
            "f32_step0_loss": f32_loss,
            "bf16_vs_f32_loss_err": abs(losses[0] - f32_loss),
            "bf16_loss_tol": TRAIN_BF16_LOSS_TOL,
            "max_memory_allocated": peak[0],
            "max_memory_reserved": peak[1],
            "f32_check_max_memory_reserved": check_peak[1],
            "laps_s": lap.seconds}


def phase_train():
    """The LM scaffold's training path on the card (M12b, one device): the
    100m preset against the CPU, the train launcher end to end with its
    fault and resume paths, and Phi-4-mini training at full width.  No
    kernel of the four is on it (K4 has no backward): every launch count
    stays 0, which the phase checks."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.perf import executable_cache

    _fresh_cache()
    lap = _Laps()
    ops.reset_launch_counts()
    parity = _train_parity()
    reserved = {"parity": _gb_cap("train/parity")[1]}
    emit(dict({"phase": "train/parity"}, **parity,
              max_memory_reserved=reserved["parity"]))
    lap("parity")
    torch.cuda.reset_peak_memory_stats()
    launcher = _train_launcher(ROOT / "build" / "train_ckpt")
    reserved["launcher"] = _gb_cap("train/launcher")[1]
    emit(dict({"phase": "train/launcher"}, **launcher,
              max_memory_reserved=reserved["launcher"]))
    executable_cache().clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("launcher")
    full = _train_full()
    emit(dict({"phase": "train/full"}, **full))
    lap("full")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched {launches}")
    rec = {"phase": "train", "launches": launches,
           "step_s_median": full["step_s_median"],
           "tokens_per_s": full["tokens_per_s"],
           "max_memory_reserved_by_part": dict(
               reserved, full=full["max_memory_reserved"],
               full_f32_check=full["f32_check_max_memory_reserved"]),
           "laps_s": lap.seconds}
    emit(rec)
    _fresh_cache()
    return rec

def _whole(t):
    """A DTensor gathered whole; a plain tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _local(t):
    """A DTensor's local tensor; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _shard_prefill(rules):
    """Part 1 of phase shard: Gemma-2-9B (one pattern period) prefilled
    through ``make_prefill_step`` with ``rules`` and without, on the same
    bf16 params; the step's own last-position logits recorded from its
    forward.  Gates: equal next tokens, logits within SHARD_LOGIT_TOL, K4
    launched once per local layer in each prefill."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train import steps

    base = get_config(SHARD_LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=len(base.pattern))
    n_local = sum(k == "attn_local" for k in cfg.pattern)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "prefill_8k", SHARD_PROMPT, 1, "prefill"))
    gen = torch.Generator("cuda").manual_seed(SHARD_SEED)
    params = lm.lm_init(gen, cfg, torch.bfloat16, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, SHARD_PROMPT), generator=gen,
                         device="cuda", dtype=torch.int32)
    seen = {}
    forward = lm.forward

    def recording(*a, **kw):
        out = forward(*a, **kw)
        seen["logits"] = out[0]
        return out

    def prefill(r, p):
        cache = lm.cache_init(cfg, 1, SHARD_PROMPT, torch.bfloat16,
                              device="cuda")
        if r is not None:
            cache = steps.place_tree(cache, steps.resolve_shardings(
                r, lm.cache_specs(cfg), cache))
        step = steps.make_prefill_step(cfg, run, r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lm.forward = recording
        try:
            (tok, cache), secs = wall(lambda: step(p, {"tokens": toks},
                                                   cache))
            torch.cuda.synchronize()
        finally:
            lm.forward = forward
        logits = _whole(seen.pop("logits"))
        return tok, logits[:, -1].float(), ops.launch_counts(), secs

    prefill(None, params)                       # warm: K4's build, cuBLAS
    plain_tok, plain_logits, plain_launches, plain_s = prefill(None, params)
    sparams = steps.place_tree(params, steps.resolve_shardings(
        rules, lm.lm_specs(cfg), params))
    tok, logits, launches, secs = prefill(rules, sparams)
    err = float((logits - plain_logits).abs().max())
    if not torch.equal(tok, plain_tok) or not err <= SHARD_LOGIT_TOL or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"shard prefill: tokens {tok.tolist()} vs "
                             f"{plain_tok.tolist()}, logits err {err}")
    if launches["local_attn"] != n_local or \
            plain_launches["local_attn"] != n_local:
        raise AssertionError(f"shard prefill: K4 launched "
                             f"{launches['local_attn']} (rules), "
                             f"{plain_launches['local_attn']} (none) times, "
                             f"want {n_local} (one per local layer)")
    return {"arch": SHARD_LM_ARCH, "seed": SHARD_SEED,
            "layers": list(cfg.pattern), "d_model": cfg.d_model,
            "prompt": SHARD_PROMPT, "batch": 1,
            "reduced": [f"{base.n_layers} layers -> {cfg.n_layers} (one "
                        f"pattern period: one local, one global)"],
            "next_token": tok.tolist(), "plain_next_token": plain_tok.tolist(),
            "logits_max_abs_err": err, "logit_tol": SHARD_LOGIT_TOL,
            "prefill_s": secs, "plain_prefill_s": plain_s,
            "launches": launches, "plain_launches": plain_launches}


def _shard_moe_train(rules):
    """Part 2 of phase shard: Qwen3-MoE-235B-A22B at full width, one layer,
    trained with ``rules`` (the capacity dispatch of ``models.moe``).
    Gates: the dispatch at capacity_factor = E / k against the
    single-device oracle (no drops, within SHARD_DISPATCH_RTOL), the
    config's own drop fraction in [0, 1), the loss with the rules at
    capacity_factor = E / k against ``lm_loss(rules=None)``
    (SHARD_ORACLE_LOSS_TOL), two train steps with finite loss and grad
    norm, the step-0 loss against ``lm_loss(rules)`` before the update
    (SHARD_LOSS_TOL), the params moved; reserved memory <=
    RESERVED_CAP."""
    import dataclasses
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import lm, moe
    from repro_torch.models.modules import (norm_apply, param_bytes,
                                            param_count, tree_map)
    from repro_torch.train import optim, steps

    lap = _Laps()
    base = get_config(SHARD_MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=len(base.pattern))
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train_4k", SHARD_MOE_SEQ, 1, "train"), remat="block")
    gen = torch.Generator("cuda").manual_seed(SHARD_SEED + 1)
    state = steps.train_state_init(gen, cfg, torch.bfloat16, device="cuda")
    n_params, state_bytes = param_count(state["params"]), param_bytes(state)
    state = steps.place_tree(state, steps.resolve_shardings(
        rules, steps.train_state_specs(cfg), state))
    toks = torch.randint(0, cfg.vocab_size, (1, SHARD_MOE_SEQ),
                         generator=gen, device="cuda", dtype=torch.int32)
    labels = torch.cat([toks[:, 1:], torch.full(
        (1, 1), -1, dtype=torch.int32, device="cuda")], 1)
    batch = {"tokens": toks, "labels": labels}
    lap("init")

    # the dispatch on the layer's input: the tokens' embeddings through
    # the MoE's own pre-norm
    layer = tree_map(lambda t: t[0], state["params"]["groups"])["b0"]
    whole = lambda tree: tree_map(_whole, tree)
    with torch.no_grad():
        x = norm_apply(whole(layer["norm2"]),
                       _whole(state["params"]["embed"]["table"])[toks],
                       kind=cfg.norm, eps=cfg.norm_eps)
        xd = rules.shard_input(x, ("batch", None, None))
        e = cfg.moe
        nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
            e, capacity_factor=e.n_experts / e.top_k))
        torch.cuda.synchronize()
        (y, aux, drop), dispatch_s = wall(lambda: moe.moe_apply(
            layer["mlp"], xd, nodrop, rules=rules))
        (y_o, aux_o, _), oracle_s = wall(lambda: moe.moe_apply(
            whole(layer["mlp"]), x, cfg))
        (_, _, drop_cf), _ = wall(lambda: moe.moe_apply(
            layer["mlp"], xd, cfg, rules=rules))
        torch.cuda.synchronize()
        y, drop, drop_cf = _whole(y), float(_whole(drop)), \
            float(_whole(drop_cf))
        scale = float(y_o.float().abs().max())
        d_err = float((y.float() - y_o.float()).abs().max())
        aux_err = abs(float(_whole(aux)) - float(aux_o))
        del x, xd, y, y_o
    if drop != 0.0 or not d_err <= SHARD_DISPATCH_RTOL * scale or \
            not 0.0 <= drop_cf < 1.0:
        raise AssertionError(f"shard moe dispatch: drop {drop} at "
                             f"capacity = tokens, max err {d_err} of "
                             f"{scale}; drop {drop_cf} at cf "
                             f"{e.capacity_factor}")
    lap("dispatch")

    with torch.no_grad():
        ref_loss = float(lm.lm_loss(state["params"], cfg, batch,
                                    rules=rules, remat="none",
                                    device="cuda")[0])
        nodrop_loss = float(lm.lm_loss(state["params"], nodrop, batch,
                                       rules=rules, remat="none",
                                       device="cuda")[0])
        oracle_loss = float(lm.lm_loss(whole(state["params"]), cfg, batch,
                                       rules=None, remat="none",
                                       device="cuda")[0])
    if not abs(nodrop_loss - oracle_loss) <= SHARD_ORACLE_LOSS_TOL:
        raise AssertionError(f"shard moe loss: {nodrop_loss} with the rules "
                             f"at capacity = tokens vs {oracle_loss} on "
                             f"the single-device path")
    lap("ref_loss")
    watch = {"head": state["params"]["head"]["w"],
             "experts": layer["mlp"]["w_gate"]}
    before = {k: float(_local(t).float().sum()) for k, t in watch.items()}
    step = steps.make_train_step(cfg, run, rules, optim.OptConfig(
        lr=3e-4, warmup_steps=2))
    m, cold_s = wall(lambda: step(state, batch)[1])
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    lap("cold")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m, step_s = wall(lambda: step(state, batch)[1])
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    kernels = _kernel_us(prof)
    del prof
    busy_us = sum(us for _, us in kernels.values())
    top = [[k[:80], n, us / 1e3] for k, (n, us) in sorted(
        kernels.items(), key=lambda kv: -kv[1][1])[:10]]
    lap("profiled")
    after = {k: float(_local(t).float().sum()) for k, t in watch.items()}
    peak = _gb_cap("shard/moe")
    del state, layer, watch, m
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"shard moe train: losses {losses}, grad "
                             f"norms {norms}")
    if not abs(losses[0] - ref_loss) <= SHARD_LOSS_TOL:
        raise AssertionError(f"shard moe train: step-0 loss {losses[0]} vs "
                             f"lm_loss {ref_loss}")
    if any(before[k] == after[k] for k in before):
        raise AssertionError(f"shard moe train: params did not move "
                             f"{before} -> {after}")
    tokens = SHARD_MOE_SEQ
    return {"arch": SHARD_MOE_ARCH, "seed": SHARD_SEED + 1,
            "params": n_params, "state_bytes": state_bytes,
            "config": {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv_heads": cfg.n_kv_heads,
                       "n_experts": e.n_experts, "top_k": e.top_k,
                       "expert_d_ff": e.expert_d_ff,
                       "vocab_size": cfg.vocab_size,
                       "partition": e.partition,
                       "capacity_factor": e.capacity_factor},
            "seq": SHARD_MOE_SEQ, "batch": 1, "remat": "block",
            "reduced": [f"{base.n_layers} layers -> 1 (its pattern period)",
                        "train_4k's global batch 256 -> 1"],
            "dispatch_max_abs_err": d_err, "dispatch_scale": scale,
            "dispatch_rtol": SHARD_DISPATCH_RTOL, "dispatch_aux_err": aux_err,
            "dispatch_s": dispatch_s, "oracle_s": oracle_s,
            "drop_frac_nodrop": drop, "drop_frac": drop_cf,
            "ref_loss": ref_loss, "nodrop_loss": nodrop_loss,
            "oracle_loss": oracle_loss,
            "oracle_loss_err": abs(nodrop_loss - oracle_loss),
            "oracle_loss_tol": SHARD_ORACLE_LOSS_TOL,
            "losses": losses, "grad_norms": norms,
            "step0_loss_err": abs(losses[0] - ref_loss),
            "loss_tol": SHARD_LOSS_TOL, "cold_s": cold_s,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "kernel_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e6 / step_s,
            "top_kernels_ms": top, "params_sum_before": before,
            "params_sum_after": after,
            "max_memory_allocated": peak[0],
            "max_memory_reserved": peak[1], "laps_s": lap.seconds}


def phase_shard():
    """The LM scaffold's sharded half (M12b-2) on the card: a world-size-1
    NCCL mesh (1, 1) ("data", "model") with ``Rules(mesh, fsdp=True)``,
    whose layouts keep the tensors plain; Gemma-2-9B's prefill with the
    rules through K4, then Qwen3-MoE-235B-A22B
    training at full width through the capacity dispatch.  Its launch
    counts are the sharded prefill's (set to 0 just before it, read just
    after); the training part launches no kernel (K4 has no backward),
    which the phase checks.  The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import Rules

    _fresh_cache()
    lap = _Laps()
    started = not dist.is_initialized()
    rules = Rules(make_host_mesh(device="cuda"), fsdp=True)
    try:
        prefill = _shard_prefill(rules)
        reserved = {"prefill": _gb_cap("shard/prefill")[1]}
        emit(dict({"phase": "shard/prefill"}, **prefill,
                  max_memory_reserved=reserved["prefill"],
                  nvidia_smi=nvidia_smi()))
        lap("prefill")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        train = _shard_moe_train(rules)
        train_launches = ops.launch_counts()
        reserved["moe_train"] = train["max_memory_reserved"]
        emit(dict({"phase": "shard/moe_train"}, **train,
                  nvidia_smi=nvidia_smi()))
        lap("moe_train")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if any(train_launches.values()):
        raise AssertionError(f"shard moe train: kernels launched "
                             f"{train_launches}")
    rec = {"phase": "shard", "launches": prefill["launches"],
           "moe_step_s": train["step_s"],
           "moe_idle_share": train["idle_share"],
           "max_memory_reserved_by_part": reserved, "laps_s": lap.seconds}
    emit(rec)
    _fresh_cache()
    return rec


def _start_dry_cells():
    """Part 1 of phase dryrun, started early: each of DRYRUN_CELLS traced
    by the dry run's own CLI (``python -m repro_torch.launch.dryrun --arch
    A --shape S --mesh M --tag chip``, fake CUDA tensors on a fake world
    of 512 ranks) in a process of its own, in the background: a cell's
    trace is host work (a prefill_32k unrolls ~10^6 ops), so the cells
    run beside the earlier phases.  Returns {cell: (process, log)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    (ROOT / "build").mkdir(exist_ok=True)
    from repro_torch.launch.dryrun import ART_DIR
    procs = {}
    for arch, shape, mk in DRYRUN_CELLS:
        (ART_DIR / f"{arch}_{shape}_{mk}_chip.json").unlink(missing_ok=True)
        log = open(ROOT / "build" / f"dryrun_{arch}_{shape}_{mk}.log", "w")
        procs[(arch, shape, mk)] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mk, "--tag", "chip"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log)
    return procs


def _stop(procs) -> None:
    for p, log in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _dry_cells(procs, started):
    """Part 1 of phase dryrun, collected: each cell's record (its
    artifact under experiments/dryrun_torch/) to status "ok", the Gemma-2
    prefill holding one K4 op per local layer; a line per cell."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    out = []
    for (arch, shape, mk), (p, log) in procs.items():
        try:
            p.wait(timeout=max(1.0, DRYRUN_WAIT_S - (time.perf_counter()
                                                     - started)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dryrun {arch} x {shape} x {mk}: not done "
                                 f"{DRYRUN_WAIT_S} s after its start")
        path = D.ART_DIR / f"{arch}_{shape}_{mk}_chip.json"
        rec = json.loads(path.read_text()) if path.exists() else {
            "status": "missing", "error": f"rc {p.returncode}",
            "traceback": Path(log.name).read_text()[-3000:]}
        if p.returncode != 0 or rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} x {shape} x {mk}: "
                                 f"{rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
        an, ma = rec["analysis"], rec["memory_analysis"]
        k4 = rec["ops"].get("repro_torch.local_attn.default", 0)
        cfg = get_config(arch)
        n_local = cfg.n_groups * cfg.pattern.count("attn_local")
        if shape.startswith("prefill") and k4 != n_local:
            raise AssertionError(f"dryrun {arch} x {shape}: {k4} K4 ops "
                                 f"traced, want {n_local}")
        peak = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        line = {"arch": arch, "shape": shape, "mesh": mk,
                "devices": rec["devices"], "dot_flops": an["dot_flops"],
                "kernel_flops": an["kernel_flops"], "flops": rec["flops"],
                "collective_bytes": an["collective_bytes"],
                "collectives": {k: [v["count"], v["bytes"]] for k, v in
                                an["collectives"].items() if v["count"]},
                "memory_analysis": ma, "predicted_peak_bytes": peak,
                "predicted_share_of_card": peak / CARD_BYTES,
                "k4_ops": k4, "ops": an["n_computations"],
                "build_s": rec["build_s"], "trace_s": rec["trace_s"],
                "total_s": rec["total_s"]}
        emit(dict({"phase": "dryrun/cell"}, **line))
        out.append(line)
    return out


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree of tensors."""
    import torch
    seen = {}
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _dry_vs_real(label, step, fake_args, mode, make_args):
    """Dry-run ``step`` on ``fake_args`` (of ``mode``), then run it for real
    on ``make_args()`` recorded the same way.  Gates: op counts by name,
    dot and kernel FLOPs equal; the traced K4 ops equal K4's launches;
    the predicted argument bytes equal the real inputs' bytes; the
    predicted peak within DRYRUN_MEM_RTOL of the measured one."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.perf import trace_analysis as T
    dry, dry_s = wall(lambda: D.trace(step, fake_args, mode))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    args = make_args()
    arg_bytes = _storage_bytes(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    real, real_s = wall(lambda: D.trace(step, args))
    launches = ops.launch_counts()
    measured = torch.cuda.max_memory_allocated() - before
    del args
    da, ra = T.analyze(dry), T.analyze(real)
    dm = T.memory_analysis(dry)
    predicted = dm["argument_size_in_bytes"] + dm["temp_size_in_bytes"]
    k4 = dry.ops.get("repro_torch.local_attn.default", 0)
    rec = {"label": label, "ops_equal": dry.ops == real.ops,
           "n_ops": ra["n_computations"],
           "dot_flops": [da["dot_flops"], ra["dot_flops"]],
           "kernel_flops": [da["kernel_flops"], ra["kernel_flops"]],
           "k4_traced": k4, "launches": launches,
           "argument_bytes": [dm["argument_size_in_bytes"], arg_bytes],
           "predicted_peak_bytes": predicted,
           "measured_peak_bytes": measured,
           "peak_rel_err": predicted / measured - 1.0,
           "mem_rtol": DRYRUN_MEM_RTOL, "dry_s": dry_s, "real_s": real_s}
    if not rec["ops_equal"]:
        diff = {k: (dry.ops.get(k, 0), real.ops.get(k, 0))
                for k in set(dry.ops) | set(real.ops)
                if dry.ops.get(k, 0) != real.ops.get(k, 0)}
        raise AssertionError(f"dryrun {label}: op counts differ {diff}")
    if da["dot_flops"] != ra["dot_flops"] or \
            da["kernel_flops"] != ra["kernel_flops"]:
        raise AssertionError(f"dryrun {label}: FLOPs {rec['dot_flops']} "
                             f"{rec['kernel_flops']} (dry, real)")
    if k4 != launches["local_attn"]:
        raise AssertionError(f"dryrun {label}: {k4} K4 ops traced, "
                             f"{launches['local_attn']} launched")
    if dm["argument_size_in_bytes"] != arg_bytes:
        raise AssertionError(f"dryrun {label}: argument bytes "
                             f"{rec['argument_bytes']} (dry, real)")
    if not abs(predicted - measured) <= DRYRUN_MEM_RTOL * measured:
        raise AssertionError(f"dryrun {label}: predicted peak {predicted} "
                             f"vs measured {measured}")
    return rec


def _dry_prefill(rules):
    """Phase shard's Gemma-2-9B one-period prefill of SHARD_PROMPT tokens
    at batch 1, dry and real."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.models import lm
    from repro_torch.train import steps
    from torch._subclasses.fake_tensor import FakeTensorMode

    base = get_config(SHARD_LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=len(base.pattern))
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "prefill_8k", SHARD_PROMPT, 1, "prefill"))
    step = steps.make_prefill_step(cfg, run, rules)
    dev = torch.device("cuda")
    mode = FakeTensorMode()
    trees = ((D.shapes_of(lm.lm_init, 0, cfg, torch.bfloat16, device=dev),
              lm.lm_specs(cfg)),
             (steps.serve_batch_shapes(cfg, run, decode=False),
              steps.serve_batch_spec(cfg, decode=False)),
             (steps.cache_shapes(cfg, run), lm.cache_specs(cfg)))
    fake = tuple(D.fake_shards(mode, sh, steps.resolve_shardings(
        rules, spec, sh), dev) for sh, spec in trees)

    def make_args():
        gen = torch.Generator("cuda").manual_seed(SHARD_SEED)
        params = lm.lm_init(gen, cfg, torch.bfloat16, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (1, SHARD_PROMPT),
                             generator=gen, device="cuda", dtype=torch.int32)
        cache = lm.cache_init(cfg, 1, SHARD_PROMPT, torch.bfloat16,
                              device="cuda")
        return params, {"tokens": toks}, cache

    return _dry_vs_real(f"{SHARD_LM_ARCH} prefill {SHARD_PROMPT} (1 period)",
                        step, fake, mode, make_args)


def _dry_moe_train(rules):
    """Phase shard's Qwen3-MoE-235B-A22B one-layer train step on a
    SHARD_MOE_SEQ-token sequence at batch 1, dry and real."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.train import optim, steps
    from torch._subclasses.fake_tensor import FakeTensorMode

    base = get_config(SHARD_MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=len(base.pattern))
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "train_4k", SHARD_MOE_SEQ, 1, "train"), remat="block")
    step = steps.make_train_step(cfg, run, rules, optim.OptConfig(
        lr=3e-4, warmup_steps=2))
    dev = torch.device("cuda")
    mode = FakeTensorMode()
    trees = ((D.shapes_of(steps.train_state_init, 0, cfg, torch.bfloat16,
                          device=dev), steps.train_state_specs(cfg)),
             (steps.train_batch_shapes(cfg, run),
              steps.train_batch_spec(cfg, run)))
    fake = tuple(D.fake_shards(mode, sh, steps.resolve_shardings(
        rules, spec, sh), dev) for sh, spec in trees)

    def make_args():
        gen = torch.Generator("cuda").manual_seed(SHARD_SEED + 1)
        state = steps.train_state_init(gen, cfg, torch.bfloat16,
                                       device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (1, SHARD_MOE_SEQ),
                             generator=gen, device="cuda", dtype=torch.int32)
        return state, {"tokens": toks, "labels": toks.clone()}

    return _dry_vs_real(f"{SHARD_MOE_ARCH} train {SHARD_MOE_SEQ} (1 layer)",
                        step, fake, mode, make_args)


def _shims():
    """Part 3 of phase dryrun: the deprecated ``core.pipeline`` shims on the
    card at N_PARITY: ``run_vmap`` with ``SNConfig(variant="jobsn")`` gives
    ``api.resolve``'s (vmap runner, scan engine) packed blocked and matched
    sets."""
    import warnings

    import numpy as np
    from repro_torch import api
    from repro_torch.api.results import pack_pair_set
    from repro_torch.core import entities as E
    from repro_torch.core import pipeline as PL
    from repro_torch.core.match import paper_cascade
    from repro_torch.core.partition import balanced_partition
    ents = E.synth_entities(np.random.default_rng(1), N_PARITY,
                            n_keys=N_KEYS, dup_frac=0.2, text_len=16)
    bounds = balanced_partition(np.asarray(ents["key"].cpu()), R)
    res, res_s = wall(lambda: api.resolve(ents, api.ERConfig(**_cfg_kw(
        variant="jobsn", runner="vmap", band_engine="scan")), bounds=bounds,
        device="cuda"))
    cfg = PL.SNConfig(window=W, variant="jobsn", hops=HOPS,
                      matcher=paper_cascade())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out, shim_s = wall(lambda: PL.run_vmap(ents, R, bounds, cfg))
        got = (np.sort(pack_pair_set(PL.blocked_pairs(out))),
               np.sort(pack_pair_set(PL.result_pairs(out))))
    want = _packed_sets(res)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"dryrun shims: blocked {got[0].size} vs "
                             f"{want[0].size}, matched {got[1].size} vs "
                             f"{want[1].size}")
    return {"n": N_PARITY, "variant": "jobsn", "blocked": int(got[0].size),
            "matched": int(got[1].size), "shim_s": shim_s,
            "resolve_s": res_s}


def phase_dryrun(procs, started):
    """The dry-run tooling (M12c) on the card: (1) DRYRUN_CELLS traced on
    the production meshes with fake CUDA tensors (nothing allocated,
    nothing launched), in background processes started before phase
    kernel (``_start_dry_cells``) and collected here; (2) phase shard's
    two full-width steps dry-run on the card's (1, 1) NCCL mesh and run
    for real, the trace against the real step's record (its launch counts
    are set to 0 just before the real steps and read just after: K4 once,
    in the prefill); (3) the ``core.pipeline`` shims at N_PARITY.  The
    group is destroyed."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import make_host_mesh
    from repro_torch.sharding import Rules

    _fresh_cache()
    lap = _Laps()
    cells = _dry_cells(procs, started)
    lap("cells")
    rules = Rules(make_host_mesh(device="cuda"), fsdp=True)
    try:
        prefill = _dry_prefill(rules)
        emit(dict({"phase": "dryrun/prefill"}, **prefill))
        lap("prefill")
        torch.cuda.empty_cache()
        train = _dry_moe_train(rules)
        emit(dict({"phase": "dryrun/moe_train"}, **train))
        lap("moe_train")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    shims = _shims()
    lap("shims")
    launches = {k: prefill["launches"][k] + train["launches"][k]
                for k in prefill["launches"]}
    rec = {"phase": "dryrun", "cells": len(cells), "launches": launches,
           "cells_wall_s": time.perf_counter() - started,
           "peak_rel_err": {"prefill": prefill["peak_rel_err"],
                            "moe_train": train["peak_rel_err"]},
           "shims": shims, "nvidia_smi": nvidia_smi(),
           "laps_s": lap.seconds}
    emit(rec)
    _fresh_cache()
    return rec


def _isolation() -> None:
    """After every phase (the dry run and the shims included) the process
    holds neither JAX nor the reference package."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "repro"))
    if bad:
        raise AssertionError(f"the port loaded {bad[:5]}")


def main() -> int:
    # the flex_attention yardstick compiles; keep its caches in build/
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    # phase train runs cuBLAS under deterministic algorithms, which needs
    # this set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    dev = timed("device", phase_device)
    dry_started = time.perf_counter()
    dry_procs = _start_dry_cells()
    try:
        return _run_phases(dev, dry_procs, dry_started, timed, seconds)
    finally:
        _stop(dry_procs)


def _run_phases(dev, dry_procs, dry_started, timed, seconds) -> int:
    timed("build", phase_build)
    recs = timed("kernel", phase_kernel)
    bands = timed("bands", phase_bands, recs)
    attention = timed("attention", phase_attention)
    timed("parity", phase_parity)
    main_rec, main_ents, main_sets = timed("main", phase_main)
    planned = timed("planned", phase_planned, main_rec, main_ents,
                    main_sets)
    del main_ents
    quality = timed("quality", phase_quality)
    streamed = timed("stream", phase_stream, main_rec, main_sets)
    del main_sets
    served = timed("serve", phase_serve, main_rec)
    sharded = timed("shard_map", phase_shard_map)
    served_lm = timed("lm", phase_lm)
    trained = timed("train", phase_train)
    shard = timed("shard", phase_shard)
    dry = timed("dryrun", phase_dryrun, dry_procs, dry_started)
    _isolation()
    emit({"phase_seconds": seconds})
    # launches on each kernel's path: K1 on the resolve paths (main,
    # planned, quality, stream and its checkpointed run, serve's delta
    # calls, the shard_map runner), replays of cached shard programs
    # included; K2 and K3 on the entry point's bands, K4 on its attention
    # and on the LM prefill's local layers (phase lm's and phase shard's
    # sharded prefill)
    launches = {"fused_band": sum(rec[k]["fused_band"] for rec, k in (
                    (main_rec, "kernel_launches"), (planned, "launches"),
                    (quality, "launches"), (streamed, "launches"),
                    (streamed["checkpoint"], "launches"),
                    (served, "launches"), (sharded, "launches"))),
                "banded_sim": bands["launches"]["banded_sim"],
                "jaccard_band": bands["launches"]["jaccard_band"],
                "local_attn": attention["launches"]["local_attn"]
                + served_lm["launches"]["local_attn"]
                + shard["launches"]["local_attn"]
                + dry["launches"]["local_attn"]}
    # phase train launches none of them (checked there): its 0s counted
    launches = {k: n + trained["launches"][k] for k, n in launches.items()}
    replaces = {"fused_band": "src/repro/kernels/fused_band.py:33",
                "banded_sim": "src/repro/kernels/banded_sim.py:27",
                "jaccard_band": "src/repro/kernels/jaccard_band.py:22",
                "local_attn": "src/repro/kernels/local_attn.py:28"}
    emit({"kernels": [{
        "name": name, "route": "cuda", "status": "ported",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": max(rec["max_abs_err"].values()),
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"]} for name, rec in recs.items()]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
