"""The out-of-core cell on the CPU at a small size: a sound stream is
correct, and each fault planted in the streaming path makes it not
correct -- the seam halo's carry dropped, a sorted run left out of the
merge, the corpus staged on the device as one chunk, the spool kept in
memory.  Traced, the line holds every per-layer metric the cell lists."""
import json
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from erbench import harness  # noqa: E402
from erbench.drivers import stream as driver  # noqa: E402

CELL = "pubs-ooc-quarter.stream"
N = 3000
SEED = 2**31 + 99
ROOT = Path(__file__).resolve().parents[2]


def _run(trace=False):
    return harness.run(CELL, SEED, 0.5, trace, device="cpu", n=N)


def _failed(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


def test_sound_stream_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["blocked_diff"]["value"] == 0
    assert checks["unspooled_bytes"]["value"] == 0
    assert 0.25 < checks["device_share"]["value"] <= \
        checks["device_share"]["limit"] < 0.27


def test_seam_halo_carry_dropped(monkeypatch):
    from repro_torch.core import entities as E
    from repro_torch.stream import resolver
    # the resolver takes a slice of a host dict only for the carry
    take = lambda ents, idx: E.host_take(
        ents, slice(0, 0) if isinstance(idx, slice) else idx)
    ns = types.SimpleNamespace(**{k: getattr(E, k) for k in dir(E)
                                  if not k.startswith("__")})
    ns.host_take = take
    monkeypatch.setattr(resolver, "E", ns)
    out = _run()
    assert not out["correct"] and out["checks"]["blocked_diff"]["value"] > 0


class _AllButLast:
    """A view of a run store without its last run."""

    def __init__(self, runs):
        self.runs = runs

    def __len__(self):
        return len(self.runs) - 1

    def load(self, i):
        return self.runs.load(i)

    def load_index(self, i):
        return self.runs.load_index(i)


def test_merge_skips_a_sorted_run(monkeypatch):
    from repro_torch.stream import resolver
    merged = resolver.merged_blocks
    monkeypatch.setattr(resolver, "merged_blocks",
                        lambda runs, block: merged(_AllButLast(runs), block))
    out = _run()
    assert not out["correct"] and out["checks"]["blocked_diff"]["value"] > 0


def test_whole_corpus_as_one_chunk(monkeypatch):
    from repro_torch import stream
    from repro_torch.core import entities as E
    resolve = stream.resolve_stream

    def one_chunk(chunks, cfg, chunk_size, **kw):
        whole = E.host_concat(list(chunks))
        return resolve(iter([whole]), cfg, chunk_size=whole["key"].shape[0],
                       **kw)

    monkeypatch.setattr(stream, "resolve_stream", one_chunk)
    out = _run()
    assert not out["correct"] and _failed(out) == {"device_share"}


def test_spool_kept_in_memory(monkeypatch):
    from repro_torch import stream
    resolve = stream.resolve_stream
    monkeypatch.setattr(stream, "resolve_stream",
                        lambda chunks, cfg, spool_dir, **kw:
                        resolve(chunks, cfg, spool_dir=None, **kw))
    out = _run()
    assert not out["correct"] and _failed(out) == {"unspooled_bytes"}


def test_traced_stream_reports_every_metric():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    for m in harness.metrics_of(CELL, "per_layer", harness.spec()):
        if m["source"] == "program_span":
            assert m["name"] in out["metrics"], m["name"]
    # the window reads no device on the CPU: the card's metrics are the
    # card test's (test_erbench_gpu.py)
    assert "merge_blocks.stream" in out["metrics"]
    # four runs of a few hundred keys: one block per (key, run) at most,
    # and more than one a run
    blocks = out["metrics"]["merge_blocks.stream"]["value"]
    assert 4 < blocks <= 4 * harness.config(
        "pubs-ooc-quarter")["corpus"]["n_keys"]


def test_chunks_keep_the_configurations_share():
    class Ctx:
        config = harness.config("pubs-ooc-quarter")
    full = Ctx.config["corpus"]["n"]
    assert driver.chunk_rows(Ctx, full) == full // 4 == 87_500
    assert driver.chunk_rows(Ctx, N) == N // 4


def test_device_share_limit_is_its_derivation():
    """The file's limit is (chunk + w - 1) x (row + 4) / (n x row) at the
    configuration's size, rounded up at the sixth decimal."""
    class Ctx:
        config = harness.config("pubs-ooc-quarter")
    c = Ctx.config["corpus"]
    row = 4 + 4 + 1 + 4 * c["feat_dim"] + 4 * c["sig_words"] + c["text_len"]
    assert row == 185
    chunk, n = Ctx.config["stream"]["chunk_rows"], c["n"]
    exact = (chunk + Ctx.config["er"]["window"] - 1) * (row + 4) / (n * row)
    written = Ctx.config["guarantee_limits"]["device_share"]
    assert exact <= written < exact + 1e-6
    assert driver.device_share_limit(Ctx, n, chunk, row) == written
    assert driver.device_share_limit(Ctx, n - 1, chunk, row) == \
        pytest.approx((chunk + 9) * (row + 4) / ((n - 1) * row))


def test_same_corpus_and_matcher_as_the_other_configurations():
    mine = json.loads((ROOT / "erbench/configs/pubs-ooc-quarter.json")
                      .read_text())
    for other in ("pubs-350k", "pubs-1.4m"):
        cfg = harness.config(other)
        for key in ("graded", "er", "matcher"):
            assert mine[key] == cfg[key], (other, key)
        assert {k: v for k, v in mine["corpus"].items() if k != "n"} == \
            {k: v for k, v in cfg["corpus"].items() if k != "n"}
    assert mine["corpus"]["n"] == 350_000
    assert mine["stream"] == {"chunk_rows": 87_500, "spool": "disk"}
