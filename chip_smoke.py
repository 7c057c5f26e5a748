#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, one JSON line each:

  1. device   the card (nvidia-smi name + power limit), device count
  2. build    every CUDA kernel built from the checkout's sources (one nvcc
              per source, all started together), with ptxas's registers
              and shared memory
  3. kernel   each kernel against its plain PyTorch version on the card, at
              the main path's shapes and at edge cases; times with CUDA
              events
  4. parity   resolve() on the card == the sequential host oracle, for
              srp/repsn/jobsn x scan/pallas at n=200,000
  5. main     the main path at full size: the paper's 1.4M-record corpus,
              w=10, r=8, repsn hops=7, vmap runner, balanced partitioner,
              pallas band engine, emit="pairs", the paper's cascade, auto
              caps — blocked pairs, zero overflow, kernel launches, and the
              matched set equal to the scan engine's

then the kernel table ``{"kernels": [...]}``, the card line, and the last
line ``{"ok": true, "device": {...}}``.  Every phase raises on failure, so
the script exits non-zero and prints no result line.  It exits non-zero
without a CUDA card, and where ``src/repro_torch`` is not beside it.

TF32 is switched off for matmuls and cuDNN (the cascade gate's slack is
GATE_EPS = 1e-5; K1 itself uses plain IEEE f32 FMAs).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM3 bytes/s and f32 (non-tensor) ops/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_FULL = 1_400_000          # paper §5.1: 1.4M publication records
N_PARITY = 200_000
N_KEYS = 26 ** 3            # three-letter title-prefix keys
W, R, HOPS = 10, 8, 7
KERNEL_TOL = 1e-5           # tests/test_kernels.py's fused-band tolerance


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    total = time.perf_counter() - t0
    emit({"phase": "build", "seconds": round(total, 3),
          "kernels": {name: {"seconds": round(b.seconds, 3),
                             "ptxas": [ln.strip() for ln in b.log.splitlines()
                                       if "registers" in ln or "smem" in ln
                                       or "Compiling entry" in ln]}
                      for name, b in built.items()}})


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
    import torch
    from repro_torch.kernels import ops
    got = ops.fused_cheap_band(feat, sig, window=window, w_cos=w_cos,
                               w_jac=w_jac)
    want = ops.fused_cheap_band_ref(feat, sig, window=window, w_cos=w_cos,
                                    w_jac=w_jac)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= KERNEL_TOL or got.shape != want.shape:
        raise AssertionError(f"fused_band {label}: max abs err {err} > "
                             f"{KERNEL_TOL} (shape {tuple(got.shape)})")
    return err


def phase_kernel():
    """K1 against its plain version at the main path's shapes and at edge
    cases; times at the main shape."""
    import torch
    from repro_torch.kernels import ops
    s, m, f, words, window = R, N_FULL + W - 1, 32, 8, W - 1
    feat, sig = _band_inputs(s, m, f, words, 0)
    errs = {"main": _check_band(feat, sig, window, 0.25, 0.25, "main")}
    edge = [  # (label, S, M, F, W, window, w_cos, w_jac, zero_sig)
        ("m_not_tile_multiple", 3, 1000, 32, 8, 9, 0.5, 0.5, False),
        ("cos_only_sig_dummy", 2, 777, 32, 1, 9, 1.0, 0.0, False),
        ("jac_only_feat_dummy", 2, 777, 1, 8, 9, 0.0, 2.0, False),
        ("all_zero_signatures", 2, 513, 32, 8, 9, 0.5, 0.5, True),
        ("window_eq_band_block", 2, 700, 32, 8, 256, 0.5, 0.5, False),
        ("m_below_window", 1, 5, 32, 8, 9, 0.5, 0.5, False),
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
    in_bytes = feat.numel() * 4 + sig.numel() * 4
    out_bytes = s * m * window * 4
    pairs = s * (m * window - window * (window + 1) // 2)
    ops_count = pairs * (2 * f + 6 * words)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / F32_OPS_PER_S * 1e3
    rec = {"phase": "kernel", "name": "fused_band",
           "shape": {"S": s, "M": m, "F": f, "W": words, "window": window},
           "max_abs_err": errs, "tol": KERNEL_TOL,
           "ms": kernel_ms, "plain_ms": plain_ms,
           "bytes": in_bytes + out_bytes, "ops": ops_count,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bound_basis": "H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s "
                          "f32 non-tensor",
           "library_ms": None}
    emit(rec)
    del feat, sig
    torch.cuda.empty_cache()
    return rec


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
            if res.blocking.pairs != seq.blocking.pairs or \
                    res.matches != seq.matches:
                raise AssertionError(
                    f"{label}: blocked {len(res.blocking.pairs)} vs "
                    f"{len(seq.blocking.pairs)}, matched {len(res.matches)} "
                    f"vs {len(seq.matches)}")
            rows.append({"variant": variant, "engine": engine,
                         "blocked": len(res.blocking.pairs),
                         "matched": len(res.matches),
                         "resolve_s": round(secs, 3),
                         "sequential_s": round(seq_s, 3)})
    emit({"phase": "parity", "n": N_PARITY, "equal": True, "runs": rows})


def _device_busy(fn):
    """(seconds of CUDA kernel time, top kernels) of ``fn`` under
    torch.profiler; (None, []) when the profiler records no device time."""
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
        return None, []
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy_us / 1e6, [[e.key[:80], e.count, e.self_device_time_total
                            / 1e6] for e in top]


def _breakdown(ents, cfg):
    """One steady resolve taken apart: planning, the device shard program,
    host collection into packed pairs, the public frozensets; plus the
    device's busy time over the shard program (torch.profiler)."""
    from repro_torch import api
    from repro_torch.api import runners as RN
    from repro_torch.resilience.retry import autosize_caps
    runner = api.VmapRunner(R, device="cuda")
    t0 = time.perf_counter()
    plan = api.plan_shards(ents, cfg, R)
    run_cfg, _ = autosize_caps(cfg, plan=plan)
    plan_s = time.perf_counter() - t0
    out, device_s = wall(lambda: runner.run_raw(ents, plan, run_cfg))
    packed, collect_s = wall(lambda: RN._device_outcome_packed(out, run_cfg,
                                                                R))
    _, sets_s = wall(packed.to_outcome)
    del out
    # the dedup the host collection runs, against np.unique, on the same
    # shuffled blocked pairs
    import numpy as np
    from repro_torch.api.results import unique_packed
    shuffled = np.random.default_rng(0).permutation(packed.blocked)
    t0 = time.perf_counter()
    np.unique(shuffled)
    np_unique_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unique_packed(shuffled)
    sort_unique_s = time.perf_counter() - t0
    busy_s, top = _device_busy(lambda: runner.run_raw(ents, plan, run_cfg))
    return {"plan_s": plan_s, "device_program_s": device_s,
            "host_collect_packed_s": collect_s, "frozensets_s": sets_s,
            "dedup_np_unique_s": np_unique_s,
            "dedup_unique_packed_s": sort_unique_s,
            "device_kernel_busy_s": busy_s, "top_kernels_s": top}


def phase_main():
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import entities as E
    from repro_torch.core import sn
    from repro_torch.kernels import ops

    ents = E.synth_entities(np.random.default_rng(0), N_FULL, n_keys=N_KEYS,
                            dup_frac=0.2, text_len=16, device="cuda")
    cfg = api.ERConfig(**_cfg_kw(variant="repsn", runner="vmap",
                                 partitioner="balanced",
                                 band_engine="pallas"))
    run = lambda c=cfg: api.resolve(ents, c, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, cold_s = wall(run)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["fused_band"] <= 0:
        raise AssertionError(f"main path launched no kernel: {launches}")

    expected = sn.expected_pair_count(N_FULL, W)
    _zero_overflow(res, "main")
    if len(res.blocking.pairs) != expected:
        raise AssertionError(f"blocked {len(res.blocking.pairs)} != "
                             f"{expected}")
    if not res.matches:
        raise AssertionError("main path matched nothing")

    steady_s = wall(run)[1]
    breakdown = _breakdown(ents, cfg)

    scan, scan_s = wall(lambda: run(cfg.with_(band_engine="scan")))
    if scan.matches != res.matches or scan.blocking.pairs != \
            res.blocking.pairs:
        raise AssertionError(
            f"scan vs pallas: matched {len(scan.matches)} vs "
            f"{len(res.matches)}, blocked {len(scan.blocking.pairs)} vs "
            f"{len(res.blocking.pairs)}")
    rec = {"phase": "main", "n": N_FULL, "n_keys": N_KEYS, "w": W, "r": R,
           "hops": HOPS, "variant": "repsn", "band_engine": "pallas",
           "emit": "pairs", "reduced": [],
           "rows_per_shard": R * int(np.ceil(N_FULL / R)) + W - 1,
           "cand_cap": res.resilience.cand_cap,
           "pair_cap": res.resilience.pair_cap,
           "blocked": len(res.blocking.pairs), "expected_blocked": expected,
           "matched": len(res.matches),
           "cand_count": list(res.blocking.cand_count),
           "overflow": [res.blocking.overflow, res.blocking.cand_overflow,
                        res.blocking.pair_overflow],
           "kernel_launches": launches,
           "cold_s": cold_s, "steady_s": steady_s, "breakdown": breakdown,
           "blocked_pairs_per_s": len(res.blocking.pairs) / steady_s,
           "max_memory_allocated": peak,
           "scan_s": scan_s, "scan_matched_equal": True}
    emit(rec)
    return rec


def main() -> int:
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

    dev = phase_device()
    phase_build()
    k = phase_kernel()
    phase_parity()
    main_rec = phase_main()
    emit({"kernels": [{
        "name": "fused_band", "route": "cuda", "status": "ported",
        "source": "src/repro_torch/kernels/csrc/fused_band.cu",
        "replaces": "src/repro/kernels/fused_band.py:33",
        "launches": main_rec["kernel_launches"]["fused_band"],
        "max_abs_err": max(k["max_abs_err"].values()),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
