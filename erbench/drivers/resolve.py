"""Traffic kind ``resolve``: one client resolving the configuration's
corpus back to back, as a batch-dedup user's loop does.

Set-up makes the corpus from the seed and moves it to the device; the
warm-up is one cold resolve (its shard program runs, then is captured).
In the window each ``res = api.resolve(...)`` frees the previous result
(the warm-up's, for the first) when it is bound, and the client reads the
sizes of both pair sets.  The
window admits a new call until ``seconds`` have passed and closes when
the last one admitted completes; every call admitted counts.  The check
compares the last result in full and every other by its sizes.
"""
from __future__ import annotations

import gc
import time
import traceback

from erbench.data import corpus
from erbench.reference import check


def _call(res, t0: float, t1: float) -> dict:
    b = res.blocking
    return {"t0": t0, "t1": t1, "pairs": len(res.pairs),
            "matches": len(res.matches), "load": list(b.load),
            "traces": res.perf.traces if getattr(res, "perf", None) else 0,
            "overflow": b.overflow + b.cand_overflow + b.pair_overflow}


def closed_loop(ctx, host: dict, call):
    """Warm ``call()`` up once, then call it back to back through the
    window; returns the ``Outcome`` (the check as in the module doc)."""
    from erbench.harness import Outcome
    n = int(host["valid"].sum())
    # the warm-up's answer stays alive into the window, so that every
    # call in it, the first too, frees the answer before it on binding
    res = call()
    len(res.pairs), len(res.matches)
    gc.collect()

    calls, failed = [], 0
    t_open = ctx.window.open()
    while True:
        t0 = time.perf_counter()
        try:
            res = call()
        except Exception:           # a failed answer counts as failed
            traceback.print_exc()
            failed += 1
            res = None
        if res is not None:
            calls.append(_call(res, t0, time.perf_counter()))
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    ctx.window.close()

    def compare():
        nonlocal res
        if res is None:
            raise RuntimeError("the window's last call gave no answer")
        blocked, matched, res = res.pairs, res.matches, None
        counts = [(c["pairs"], c["matches"]) for c in calls]
        return check.compare(host, ctx.config, blocked, matched, counts,
                             ctx.limits)

    return Outcome(attempted=len(calls) + failed, failed=failed,
                   calls=calls, check=compare, records=n * len(calls),
                   extra={"n_records": n})


def drive(ctx):
    from repro_torch import api
    from repro_torch.core import entities as E
    from erbench.harness import er_config

    host = corpus.make(ctx.config, ctx.seed, n=ctx.n)
    ents = E.from_numpy(host, ctx.device)
    cfg = er_config(ctx.config)
    return closed_loop(ctx, host,
                       lambda: api.resolve(ents, cfg, device=ctx.device))
