"""The port's overload-hardened serving (``repro_torch.serve.admission``)
on the CPU, mirroring the reference's admission tests case for case, with
the degraded path also held to the reference's degraded service.

  * queue policies: ``reject`` raises ``OverloadError`` at submit on a
    full queue; ``shed_oldest`` evicts + fails the oldest queued future
    and admits the newcomer; ``block`` (legacy) backpressures but fails
    fast when the worker dies or the service closes mid-wait
  * deadlines: an expired request fails with ``DeadlineExceededError`` at
    batch-formation time, before any work is spent on it
  * watchdog: a stuck batch fails with ``BatchTimeoutError`` instead of
    hanging the worker; the service marks itself failed (never silently)
  * brownout + repair (invariant 13): degraded batches keep the BLOCKED
    set exact and under-approximate matches; ``repair()`` restores served
    sets bit-identical to a from-scratch resolve; snapshots drain repair
    debt first
  * ``close(timeout=...)`` cannot hang behind a stuck batch — queued
    futures fail typed
  * chaos property sweep: under any ``ChaosPlan`` schedule x queue
    policy, every submitted future completes (result or typed error),
    none is silently dropped, and post-repair served sets match a batch
    resolve of exactly the applied mutations
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_same_serve, clear_caches,  # noqa: E402
                           port_ents)
from repro import api as RA  # noqa: E402
from repro.core import entities as E  # noqa: E402
from repro.serve import AdmissionConfig as RefAdmission  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.resilience import (ChaosEvent, ChaosPlan,  # noqa: E402
                                    InjectedFault)
from repro_torch.serve import (AdmissionConfig,  # noqa: E402
                               BatchTimeoutError, DeadlineExceededError,
                               OverloadError, ResolutionService,
                               WatermarkController)
from repro_torch.serve.admission import derive_health  # noqa: E402

N, R, W = 520, 4, 6

#: the permanently-engaged brownout (high trips at depth 0, low can never
#: release) — the deterministic fixture for the degraded path
ALWAYS_DEGRADED = AdmissionConfig(brownout_high=0.0, brownout_low=-1.0)


def _kw(**kw):
    kw.setdefault("window", W)
    kw.setdefault("num_shards", R)
    kw.setdefault("variant", "repsn")
    kw.setdefault("hops", R - 1)
    kw.setdefault("runner", "vmap")
    return kw


def _cfg(**kw):
    return api.ERConfig(**_kw(**kw))


def _serve(cfg, **kw):
    """The port's service on the CPU."""
    return api.serve(cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return E.to_host(E.synth_entities(rng, N, n_keys=70, dup_frac=0.25))


def _resolve_live(h_live, cfg):
    dev = E.make_entities(h_live["key"], h_live["eid"],
                          payload=h_live["payload"], valid=h_live["valid"])
    return api.resolve(port_ents(dev), cfg, device="cpu")


class _Gate:
    """Deterministically stall the delta inside the worker: ``insert``
    blocks on an event the test releases — no sleeps, no timing races
    (``hold``: the longest it waits for the release)."""

    def __init__(self, svc, hold=30.0):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.hold = hold
        self._orig = svc._delta.insert

    def insert(self, *a, **k):
        self.entered.set()
        self.release.wait(self.hold)
        return self._orig(*a, **k)


def _gated_service(corpus, *, admission, queue_cap, hold=30.0, **kw):
    svc = _serve(_cfg(), queue_cap=queue_cap, admission=admission,
                 max_wait_ms=0.0, **kw)
    # seed with an explicit generous deadline so admission configs with a
    # tiny default_deadline_ms cannot expire the seeding insert itself
    svc.submit_insert(E.host_take(corpus, slice(0, 60)),
                      deadline_ms=600_000.0).result(timeout=60)
    gate = _Gate(svc, hold)
    svc._delta.insert = gate.insert
    return svc, gate


# -- config validation -------------------------------------------------------

def test_admission_config_validates():
    with pytest.raises(ValueError, match="queue_policy"):
        AdmissionConfig(queue_policy="drop_newest")
    with pytest.raises(ValueError, match="brownout_low"):
        AdmissionConfig(brownout_low=0.9, brownout_high=0.5)
    with pytest.raises(ValueError, match="deadline"):
        AdmissionConfig(default_deadline_ms=-1)
    with pytest.raises(ValueError, match="batch_timeout_s"):
        AdmissionConfig(batch_timeout_s=0)
    with pytest.raises(ValueError):
        ChaosEvent(batch=0, kind="explode")


def test_watermark_hysteresis():
    wm = WatermarkController(
        AdmissionConfig(brownout_high=0.75, brownout_low=0.25,
                        brownout_p95_ms=100.0), queue_cap=100)
    assert wm.update(50, 0.0) is False          # between watermarks: off
    assert wm.update(80, 0.0) is True           # depth crosses high
    assert wm.update(50, 0.0) is True           # hysteresis: stays on
    assert wm.update(26, 0.0) is True
    assert wm.update(25, 0.0) is False          # releases at low
    assert wm.update(50, 250.0) is True         # latency engages too
    assert wm.update(50, 0.0) is True           # ...and holds until low
    assert wm.update(0, 0.0) is False
    assert wm.transitions == 4


def test_derive_health_precedence():
    assert derive_health(failure=True, brownout=True, dirty_ranges=3,
                         depth_frac=1.0, high=0.75) == "failed"
    assert derive_health(failure=False, brownout=True, dirty_ranges=0,
                         depth_frac=0.9, high=0.75) == "overloaded"
    assert derive_health(failure=False, brownout=True, dirty_ranges=0,
                         depth_frac=0.1, high=0.75) == "degraded"
    assert derive_health(failure=False, brownout=False, dirty_ranges=2,
                         depth_frac=0.1, high=0.75) == "degraded"
    assert derive_health(failure=False, brownout=False, dirty_ranges=0,
                         depth_frac=0.0, high=0.75) == "ok"


# -- queue policies ----------------------------------------------------------

def test_reject_policy_fails_fast(corpus):
    svc, gate = _gated_service(
        corpus, admission=AdmissionConfig(queue_policy="reject"),
        queue_cap=2)
    futs = [svc.submit_insert(E.host_take(corpus, slice(60, 70)))]
    gate.entered.wait(30)                  # worker busy inside the gate
    futs.append(svc.submit_insert(E.host_take(corpus, slice(70, 80))))
    futs.append(svc.submit_insert(E.host_take(corpus, slice(80, 90))))
    with pytest.raises(OverloadError):     # queue_cap=2 is now full
        svc.submit_insert(E.host_take(corpus, slice(90, 100)))
    gate.release.set()
    for f in futs:                         # admitted requests all serve
        assert f.result(timeout=30).batched >= 1
    assert svc.stats().rejected == 1
    assert svc.stats().failure is None
    svc.close(timeout=60)


def test_shed_oldest_policy_evicts_oldest(corpus):
    svc, gate = _gated_service(
        corpus, admission=AdmissionConfig(queue_policy="shed_oldest"),
        queue_cap=2)
    f0 = svc.submit_insert(E.host_take(corpus, slice(60, 70)))
    gate.entered.wait(30)
    f1 = svc.submit_insert(E.host_take(corpus, slice(70, 80)))
    f2 = svc.submit_insert(E.host_take(corpus, slice(80, 90)))
    f3 = svc.submit_insert(E.host_take(corpus, slice(90, 100)))  # sheds f1
    with pytest.raises(OverloadError, match="shed"):
        f1.result(timeout=30)
    gate.release.set()
    for f in (f0, f2, f3):                 # survivors serve normally
        assert f.result(timeout=30).batched >= 1
    st = svc.stats()
    assert st.shed == 1 and st.failure is None
    # the shed insert was never applied: its entities are re-insertable
    svc.resolve_incremental(E.host_take(corpus, slice(70, 80)))
    svc.close(timeout=60)


def test_block_policy_fails_fast_when_worker_dies(corpus):
    svc, gate = _gated_service(corpus, admission=None, queue_cap=1)

    class Boom(RuntimeError):
        pass

    def broken(*a, **k):
        gate.entered.set()
        gate.release.wait(30)
        raise Boom("delta blew up")

    svc._delta.insert = broken
    f0 = svc.submit_insert(E.host_take(corpus, slice(60, 70)))
    gate.entered.wait(30)
    svc.submit_insert(E.host_take(corpus, slice(70, 80)))  # fills the queue
    blocked_err = []

    def blocked_submit():
        try:
            svc.submit_insert(E.host_take(corpus, slice(80, 90)))
        except RuntimeError as exc:
            blocked_err.append(exc)

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    time.sleep(0.2)                        # let it enter the put loop
    assert t.is_alive()                    # genuinely blocked on backpressure
    gate.release.set()                     # worker dies with Boom
    t.join(30)
    assert not t.is_alive()                # the FIX: no infinite block
    assert blocked_err and "failed" in str(blocked_err[0])
    assert isinstance(blocked_err[0].__cause__, Boom)
    with pytest.raises(Boom):
        f0.result(timeout=30)


# -- deadlines ---------------------------------------------------------------

def test_deadline_expires_in_queue(corpus):
    svc, gate = _gated_service(
        corpus, admission=AdmissionConfig(queue_policy="block"),
        queue_cap=8)
    f0 = svc.submit_insert(E.host_take(corpus, slice(60, 70)))
    gate.entered.wait(30)
    doomed = svc.submit_insert(E.host_take(corpus, slice(70, 80)),
                               deadline_ms=0.0)
    ok = svc.submit_insert(E.host_take(corpus, slice(80, 90)))
    gate.release.set()
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=30)
    assert f0.result(timeout=30).batched >= 1
    assert ok.result(timeout=30).batched >= 1
    st = svc.stats()
    assert st.expired == 1 and st.failure is None
    # the expired insert was never applied — its entities re-insert cleanly
    svc.resolve_incremental(E.host_take(corpus, slice(70, 80)))
    svc.close(timeout=60)


def test_default_deadline_from_admission_config(corpus):
    svc, gate = _gated_service(
        corpus,
        admission=AdmissionConfig(default_deadline_ms=0.0), queue_cap=8)
    f0 = svc.submit_insert(E.host_take(corpus, slice(60, 70)),
                           deadline_ms=60_000.0)   # explicit wins
    gate.entered.wait(30)
    doomed = svc.submit_insert(E.host_take(corpus, slice(70, 80)))
    gate.release.set()
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=30)
    assert f0.result(timeout=30).batched >= 1
    svc.close(timeout=60)


# -- watchdog ----------------------------------------------------------------

def test_watchdog_fails_stuck_batch(corpus):
    # the abandoned batch holds the service lock until its gate times out
    # (stats() waits for it): hold it 2 s, ten times the watchdog's limit
    svc, gate = _gated_service(
        corpus, admission=AdmissionConfig(batch_timeout_s=0.2),
        queue_cap=8, hold=2.0)
    stuck = svc.submit_insert(E.host_take(corpus, slice(60, 70)))
    gate.entered.wait(30)                  # never released: batch is stuck
    with pytest.raises(BatchTimeoutError):
        stuck.result(timeout=30)
    st = svc.stats()
    assert st.failure is not None and st.health == "failed"
    with pytest.raises(RuntimeError, match="failed"):
        svc.submit_insert(E.host_take(corpus, slice(70, 80)))
    gate.release.set()                     # zombie finishing is a no-op


def test_chaos_stall_trips_watchdog(corpus):
    svc = _serve(
        _cfg(), admission=AdmissionConfig(batch_timeout_s=0.15),
        chaos=ChaosPlan((ChaosEvent(batch=1, kind="stall", seconds=10.0),)))
    svc.resolve_incremental(E.host_take(corpus, slice(0, 60)))  # batch 0
    stuck = svc.submit_insert(E.host_take(corpus, slice(60, 90)))
    with pytest.raises(BatchTimeoutError):
        stuck.result(timeout=30)
    assert svc.stats().health == "failed"


# -- brownout + repair (invariant 13) ----------------------------------------

def test_degraded_blocked_exact_matches_deferred(corpus):
    svc = _serve(_cfg(), start=False, admission=ALWAYS_DEGRADED)
    live = np.zeros(N, bool)
    res = svc.resolve_incremental(E.host_take(corpus, slice(0, 200)))
    live[:200] = True
    assert res.degraded and res.stats.degraded_batches == 1
    svc.delete(corpus["eid"][50:80])
    live[50:80] = False
    res = svc.resolve_incremental(E.host_take(corpus, slice(200, 400)))
    live[200:400] = True
    assert res.degraded
    ref = _resolve_live(E.host_take(corpus, np.flatnonzero(live)), _cfg())
    # blocked NEVER degrades; matches under-approximate (never invent)
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches <= ref.matches
    st = svc.stats()
    assert st.dirty_ranges > 0 and st.health in ("degraded", "overloaded")
    assert svc.repair() > 0
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches == ref.matches      # eventually-exact
    st = svc.stats()
    assert st.dirty_ranges == 0 and st.repairs == 1
    assert svc.repair() == 0               # idempotent: nothing dirty


def test_degraded_interleaving_repair_parity(corpus):
    """Property-style: a random degraded insert/delete interleaving stays
    blocked-exact throughout and fully exact after each repair."""
    rng = np.random.default_rng(5)
    svc = _serve(_cfg(), start=False, admission=ALWAYS_DEGRADED)
    live = np.zeros(N, bool)
    nxt = 0
    for step in range(6):
        if nxt < N and (step % 2 == 0 or not live.any()):
            take = min(int(rng.integers(40, 90)), N - nxt)
            svc.resolve_incremental(
                E.host_take(corpus, slice(nxt, nxt + take)))
            live[nxt:nxt + take] = True
            nxt += take
        else:
            gone = rng.choice(np.flatnonzero(live),
                              min(17, int(live.sum())), replace=False)
            svc.delete(corpus["eid"][gone])
            live[gone] = False
        ref = _resolve_live(E.host_take(corpus, np.flatnonzero(live)),
                            _cfg())
        assert svc.pairs == ref.blocking.pairs      # exact at every step
        if step == 3:
            svc.repair()
            assert svc.matches == ref.matches       # exact after repair
    svc.repair()
    ref = _resolve_live(E.host_take(corpus, np.flatnonzero(live)), _cfg())
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches == ref.matches


def test_snapshot_drains_repair_debt(corpus, tmp_path):
    svc = _serve(_cfg(), start=False, admission=ALWAYS_DEGRADED)
    svc.resolve_incremental(E.host_take(corpus, slice(0, 300)))
    assert svc.stats().dirty_ranges > 0
    svc.snapshot(str(tmp_path))
    assert svc.stats().dirty_ranges == 0   # snapshot repaired first
    back = ResolutionService.restore(str(tmp_path), _cfg(), start=False,
                                     device="cpu")
    ref = _resolve_live(E.host_take(corpus, slice(0, 300)), _cfg())
    assert back.pairs == ref.blocking.pairs
    assert back.matches == ref.matches


def test_worker_repairs_when_queue_drains(corpus):
    """The background repair pass: brownout engages under a realistic
    watermark, then releases and repairs once the queue drains."""
    svc = _serve(
        _cfg(),
        admission=AdmissionConfig(brownout_high=0.3, brownout_low=0.1),
        queue_cap=10, max_batch=60)
    svc.resolve_incremental(E.host_take(corpus, slice(0, 60)))
    # flood: enough queued inserts to cross the 30% watermark
    futs = [svc.submit_insert(E.host_take(corpus, slice(i, i + 20)))
            for i in range(60, 300, 20)]
    for f in futs:                         # every future completes
        f.result(timeout=60)
    deadline = time.monotonic() + 30
    while svc.stats().dirty_ranges and time.monotonic() < deadline:
        time.sleep(0.05)                   # idle worker repairs in background
    st = svc.stats()
    assert st.dirty_ranges == 0
    ref = _resolve_live(E.host_take(corpus, slice(0, 300)), _cfg())
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches == ref.matches
    assert st.health in ("ok", "degraded")
    svc.close(timeout=60)


# -- close timeout -----------------------------------------------------------

def test_close_timeout_fails_queued_typed(corpus):
    svc, gate = _gated_service(corpus, admission=None, queue_cap=8)
    stuck = svc.submit_insert(E.host_take(corpus, slice(60, 70)))
    gate.entered.wait(30)
    queued = svc.submit_insert(E.host_take(corpus, slice(70, 80)))
    t0 = time.monotonic()
    svc.close(drain=True, timeout=0.2)     # must NOT hang behind the gate
    assert time.monotonic() - t0 < 10
    with pytest.raises(BatchTimeoutError):
        queued.result(timeout=30)
    with pytest.raises(RuntimeError):
        svc.submit_insert(E.host_take(corpus, slice(80, 90)))
    gate.release.set()                     # the stuck batch may now finish
    assert stuck.exception(timeout=30) is None or \
        isinstance(stuck.exception(timeout=30), BatchTimeoutError)


# -- chaos property sweep ----------------------------------------------------

CHAOS_SCHEDULES = [
    ChaosPlan(()),
    ChaosPlan((ChaosEvent(batch=2, kind="error"),)),
    ChaosPlan((ChaosEvent(batch=1, kind="latency", seconds=0.05),
               ChaosEvent(batch=3, kind="error"),
               ChaosEvent(batch=4, kind="error"))),
]


@pytest.mark.parametrize("policy", ["block", "reject", "shed_oldest"])
@pytest.mark.parametrize("plan", CHAOS_SCHEDULES,
                         ids=["calm", "one_error", "spike_two_errors"])
def test_chaos_no_future_hangs_no_silent_drops(corpus, policy, plan):
    """Under any injection schedule x queue policy: every submitted
    future completes (result or typed error), nothing is silently
    dropped, the service survives request-level chaos, and post-repair
    served sets match a batch resolve of exactly the applied ops."""
    adm = AdmissionConfig(queue_policy=policy, default_deadline_ms=30_000,
                          brownout_high=0.8, brownout_low=0.2)
    svc = _serve(_cfg(), admission=adm, chaos=plan, queue_cap=4,
                 max_batch=30)
    svc.resolve_incremental(E.host_take(corpus, slice(0, 60)))  # batch 0
    ops = []                               # (future, kind, lo, hi)
    for i, lo in enumerate(range(60, 300, 30)):
        try:
            if i == 4:
                f = svc.submit_delete(corpus["eid"][10:20])
                ops.append((f, "delete", 10, 20))
            else:
                f = svc.submit_insert(E.host_take(corpus,
                                                  slice(lo, lo + 30)))
                ops.append((f, "insert", lo, lo + 30))
        except OverloadError:
            ops.append((None, "rejected", lo, lo + 30))
    live = np.zeros(N, bool)
    live[:60] = True
    outcomes = []
    for f, kind, lo, hi in ops:
        if f is None:
            outcomes.append("rejected")
            continue
        exc = f.exception(timeout=60)      # NO future may hang
        if exc is None:
            outcomes.append("ok")
            if kind == "insert":
                live[lo:hi] = True
            else:
                live[lo:hi] = False
        else:
            # typed failures only — nothing vague, nothing silent
            assert isinstance(exc, (OverloadError, DeadlineExceededError,
                                    InjectedFault)), repr(exc)
            outcomes.append(type(exc).__name__)
    assert len(outcomes) == len(ops)       # accounting is total
    st = svc.stats()
    assert st.failure is None              # chaos never kills the service
    svc.repair()
    ref = _resolve_live(E.host_take(corpus, np.flatnonzero(live)), _cfg())
    assert svc.pairs == ref.blocking.pairs
    assert svc.matches == ref.matches
    svc.close(timeout=60)


def test_degraded_path_matches_reference(corpus):
    """The brownout path in step with the reference's: the same degraded
    edits and served sets after every op (blocked exact, matches carried
    forward), and the same exact sets after ``repair()``."""
    clear_caches()
    ref = RA.serve(RA.ERConfig(**_kw()), start=False,
                   admission=RefAdmission(brownout_high=0.0,
                                          brownout_low=-1.0))
    port = _serve(_cfg(), start=False, admission=ALWAYS_DEGRADED)
    for op, arg in (("insert", slice(0, 200)), ("delete", slice(50, 80)),
                    ("insert", slice(200, 400))):
        if op == "insert":
            pair = [svc.resolve_incremental(E.host_take(corpus, arg))
                    for svc in (ref, port)]
        else:
            pair = [svc.delete(corpus["eid"][arg]) for svc in (ref, port)]
        assert pair[1].degraded
        assert_same_serve(ref, port, *pair)
    assert ref.repair() == port.repair() > 0
    assert_same_serve(ref, port)
