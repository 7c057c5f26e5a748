"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size, with one fault planted in the program:
an answer altered where it is produced, half of the batch left out, the
halo exchange between shards left out, and a serving step that returns
its state unchanged."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402

CELL, SERVE = "pubs-1.4m.resolve", "pubs-350k.serve"
N = 3000
SEED = 2**31 + 99


def _run(cell, n=N):
    return harness.run(cell, SEED, 0.5, False, device="cpu", n=n)




def test_sound_program_is_correct():
    assert _run(CELL)["correct"]


def test_answer_altered_where_produced(monkeypatch):
    from repro_torch.api import results as RES
    build = RES.packed_to_frozenset
    monkeypatch.setattr(RES, "packed_to_frozenset",
                        lambda packed: build(np.asarray(packed)[1:]))
    out = _run(CELL)
    assert not out["correct"] and out["checks"]["blocked_diff"]["value"]


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.api import facade
    resolve = facade._resolve

    def half(ents, cfg, **kw):
        keep = torch.arange(ents["valid"].shape[0]) % 2 == 0
        return resolve(dict(ents, valid=ents["valid"] & keep.to(
            ents["valid"].device)), cfg, **kw)

    monkeypatch.setattr(facade, "_resolve", half)
    assert not _run(CELL)["correct"]


def test_halo_exchange_left_out(monkeypatch):
    from repro_torch.core import repsn
    ring = repsn._ring_fwd

    def dropped(ents, axis):
        out = ring(ents, axis)
        return dict(out, valid=torch.zeros_like(out["valid"]))

    monkeypatch.setattr(repsn, "_ring_fwd", dropped)
    out = _run(CELL)
    assert not out["correct"] and out["checks"]["blocked_diff"]["value"]


def test_serving_sound_program_is_correct():
    assert _run(SERVE, n=2000)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_serving_faults(monkeypatch, fault):
    from repro_torch.serve import delta
    insert = delta.DeltaMatcher.insert

    def broken(self, dev, blocked, matched, **kw):
        if fault == "half":
            keep = torch.arange(dev["valid"].shape[0]) % 2 == 0
            dev = dict(dev, valid=dev["valid"] & keep)
        nb, nm, stats = insert(self, dev, blocked, matched, **kw)
        if fault == "unchanged":
            return blocked, matched, stats
        if fault == "altered":
            return nb[1:], nm, stats
        return nb, nm, stats

    calls = []

    def counted(self, dev, blocked, matched, **kw):
        calls.append(1)
        # the bootstrap runs sound: the fault is in the timed path
        if len(calls) == 1:
            return insert(self, dev, blocked, matched, **kw)
        return broken(self, dev, blocked, matched, **kw)

    monkeypatch.setattr(delta.DeltaMatcher, "insert", counted)
    try:
        out = _run(SERVE, n=2000)
    except ValueError:
        # a delete of an eid the broken insert never kept: the run stops
        # before its window and prints no result
        assert fault == "half"
        return
    assert not out["correct"]
