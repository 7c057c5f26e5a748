"""Run one cell of the benchmark once and print its result.

    python3 erbench/run.py --workload pubs-1.4m.resolve --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout holding ``BENCHMARK.json``, ``erbench/`` and
the program under test in ``src/repro_torch``.  It needs one CUDA card
per chip the cell asks for and exits non-zero, printing no result,
without them.  The last line of standard output is the result as one JSON
object; the numbers compared with the reference, each beside its limit,
close both the result (under ``checks``) and standard error.  With
``--trace 1`` the window runs under ``torch.profiler`` and the result
holds the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    # the program and the harness by package name; not this directory's
    # modules by their bare names
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        d for d in sys.path if d and Path(d).resolve() != here]
    from erbench import harness

    chips = harness.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"erbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"erbench: modules loaded that the run may not load: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
