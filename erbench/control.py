"""The control of ``correct``: the reference put in the program's place and
computed in bfloat16, the precision below the float32 the configurations
state.  It has to come out as not correct.

    python3 erbench/control.py --workload pubs-1.4m.resolve --seeds 1 2 3

prints, per seed, the numbers the check compares (the bfloat16 answers
against the float64 reference) beside the cell's limits, as one JSON line
each.  It runs on the host and needs no card; at the cell's full size it
takes about as long as two references.  ``--n`` overrides the corpus's
record count.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell: str, seed: int, n: int | None = None) -> dict:
    """{name: (value, limit)} of the bfloat16 control of ``cell`` on the
    corpus of ``seed``."""
    from erbench import harness
    from erbench.data import corpus
    from erbench.reference import check, sn
    w = harness.workload(cell)
    cfg = harness.config(w["config"])
    # a served cell's corpus is its base (the window adds ~0.2% to it)
    host = corpus.make(cfg, seed, n=n)
    low_b, low_m = sn.resolve(host, cfg["er"]["window"], cfg["matcher"],
                              precision="bf16")
    return check.compare(host, cfg, low_b, low_m, [],
                         harness.limits(cell))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--n", type=int, default=None)
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [
        x for x in sys.path if x and Path(x).resolve() != here]
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control(args.workload, seed, args.n)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "seconds": time.perf_counter() - t0,
            "fails": any(v > lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
