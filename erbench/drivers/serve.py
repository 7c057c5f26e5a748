"""Traffic kind ``serve``: inserts and deletes against
``repro_torch.api.serve``, an online deduplication service.

Set-up bootstraps the service with the configuration's corpus.  Requests
follow one schedule: ``delete_every`` inserts of ``insert_batch`` fresh
records, then a delete of ``delete_batch`` live records drawn at random,
over and over.  Fresh records come from the seed's endless insert stream
(``corpus.batch``), so no rate runs it dry.  The warm-up runs whole
schedules until ``warmup_clean`` in a row bring no new graph capture (a
delta call's shape bucket depends on the data, so a rare one can come
late), at most ``warmup_schedules``.

One producer waits on each request before the next; a request's latency
runs from submit to result.  The window admits requests until ``seconds``
have passed and closes when the last admitted one is answered.  The check
compares the served pair sets after the window with the reference's over
the live corpus the window left.
"""
from __future__ import annotations

import time
import traceback

import numpy as np

from erbench.data import corpus
from erbench.reference import check


class Schedule:
    """The request schedule and the live corpus it leaves."""

    def __init__(self, ctx, base: dict):
        self.ctx, self.mix = ctx, ctx.traffic
        self.k = self.batches = 0
        self.next_eid = int(base["eid"].max()) + 1
        self.parts = [base]
        self.live = base["eid"].astype(np.int64)
        self.deleted = []
        self.rng = corpus.rng(ctx.seed, corpus.DELETES)

    def next(self):
        """The next request: ("insert", host rows) or ("delete", eids)."""
        self.k += 1
        if self.k % (self.mix["delete_every"] + 1) == 0:
            pick = self.rng.choice(self.live.size, self.mix["delete_batch"],
                                   replace=False)
            eids = self.live[pick]
            self.live = np.delete(self.live, pick)
            return "delete", eids
        size = self.mix["insert_batch"]
        rows = corpus.batch(self.ctx.config, self.ctx.seed, self.batches,
                            size, self.next_eid)
        self.batches += 1
        self.next_eid += size
        return "insert", rows

    def done(self, kind: str, data) -> None:
        """Record an answered request in the live corpus."""
        if kind == "insert":
            self.parts.append(data)
            self.live = np.concatenate([self.live, data["eid"]])
        else:
            self.deleted.append(data)

    def corpus(self) -> dict:
        """The live corpus: every insert answered, less every delete."""
        host = corpus.concat(self.parts)
        if self.deleted:
            gone = np.isin(host["eid"], np.concatenate(self.deleted))
            host = corpus.rows(host, ~gone)
        return host


def _submit(svc, kind: str, data):
    return svc.submit_insert(data) if kind == "insert" \
        else svc.submit_delete(data)


def drive(ctx):
    from repro_torch import api
    from erbench.harness import Outcome, er_config

    mix = ctx.traffic
    base = corpus.make(ctx.config, ctx.seed, n=ctx.n)
    cfg = er_config(ctx.config, trace=ctx.window.trace)
    svc = api.serve(cfg, initial=base, device=ctx.device)
    sched = Schedule(ctx, base)
    clean = 0
    for _ in range(mix["warmup_schedules"]):
        before = svc.stats().traces
        for _ in range(mix["delete_every"] + 1):
            kind, data = sched.next()
            _submit(svc, kind, data).result()
            sched.done(kind, data)
        clean = clean + 1 if svc.stats().traces == before else 0
        if clean == mix["warmup_clean"]:
            break

    s0 = svc.stats()
    calls, failed = [], 0
    t_open = ctx.window.open()
    while time.perf_counter() - t_open < ctx.seconds:
        kind, data = sched.next()
        t0 = time.perf_counter()
        try:
            _submit(svc, kind, data).result()
        except Exception:           # a failed answer counts as failed
            traceback.print_exc()
            failed += 1
            continue
        t1 = time.perf_counter()
        sched.done(kind, data)
        calls.append({"t0": t0, "t1": t1, "kind": kind,
                      "n": data["key"].shape[0] if kind == "insert"
                      else data.shape[0]})
    ctx.window.close()
    s1 = svc.stats()
    if ctx.window.trace:
        t = time.perf_counter()
        report = svc.trace_report()
        ctx.window.add_spans(report.spans, t - report.wall)
    extra = {"traces": s1.traces - s0.traces,
             "compactions": s1.compactions - s0.compactions,
             "batches": s1.batches - s0.batches,
             "n_records": s1.live_entities}

    def compare():
        blocked, matched = svc.packed_pairs, svc.packed_matches
        svc.close()
        return check.compare(sched.corpus(), ctx.config,
                             np.asarray(blocked), np.asarray(matched), [],
                             ctx.limits)

    return Outcome(attempted=len(calls) + failed, failed=failed,
                   calls=calls, check=compare,
                   edits=sum(c["n"] for c in calls), extra=extra)
