"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The JAX package ``repro`` is the reference; ``repro_torch`` is held to it
on the CPU.  Inputs are made once with numpy and handed to both packages.
"""
from __future__ import annotations

import numpy as np
import pytest

# every counter a resolve result carries, compared field by field
RESULT_FIELDS = ("pairs", "matches", "load", "overflow", "cand_count",
                 "cand_overflow", "pair_overflow", "pruned", "matcher_evals")


def _field(res, name):
    if name == "pairs":
        return res.blocking.pairs
    if name == "matches":
        return res.matches
    value = getattr(res.blocking, name)
    return tuple(value) if isinstance(value, tuple) else value


def assert_same_result(ref, port) -> None:
    """The one parity contract: pairs, matches, ``load`` and every overflow
    and work counter identical between a reference and a port result."""
    for name in RESULT_FIELDS:
        a, b = _field(ref, name), _field(port, name)
        if name in ("pairs", "matches"):
            assert a == b, (f"{name}: {len(a)} vs {len(b)}; only in ref "
                            f"{sorted(a - b)[:5]}, only in port "
                            f"{sorted(b - a)[:5]}")
        else:
            assert a == b, f"{name}: {a} vs {b}"


def clear_caches() -> None:
    """Empty both packages' executable caches, so that the same calls
    meter the same hits, misses and traces in each."""
    from repro.perf.cache import executable_cache as ref_cache
    from repro_torch.perf import executable_cache as port_cache
    ref_cache().clear()
    port_cache().clear()


def assert_same_stream(ref, port) -> None:
    """A reference and a port ``StreamResult``: the result contract above,
    every ``StreamStats`` field equal (the executable-cache counters too,
    for runs that began from equal cache states: ``clear_caches``), equal
    overflow-recovery stats and metrics, and the same per pass."""
    import dataclasses
    assert_same_result(ref, port)
    for f in dataclasses.fields(port.stream):
        a, b = getattr(ref.stream, f.name), getattr(port.stream, f.name)
        assert a == b, f"stream.{f.name}: {a} vs {b}"
    assert tuple(ref.resilience) == tuple(port.resilience)
    assert (ref.metrics is None) == (port.metrics is None)
    if ref.metrics is not None:
        for f in ("reduction_ratio", "pairs_completeness", "oracle_pairs",
                  "total_comparisons"):
            assert getattr(ref.metrics, f) == getattr(port.metrics, f), f
    assert ref.pass_names == port.pass_names
    assert len(ref.passes) == len(port.passes)
    for a, b in zip(ref.passes, port.passes):
        assert_same_stream(a, b)


# the two host-clock latencies of ServeStats
SERVE_CLOCK_FIELDS = ("p50_ms", "p95_ms")
RESULT_EDIT_FIELDS = ("new_pairs", "retired_pairs", "new_matches",
                      "retired_matches", "pair_ids", "batched", "degraded")


def _assert_same_serve_stats(ref, port) -> None:
    for f in port._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if f not in SERVE_CLOCK_FIELDS:
            assert a == b, f"stats.{f}: {a} vs {b}"


def assert_same_serve(ref, port, ref_res=None, port_res=None) -> None:
    """A reference and a port ``ResolutionService``: the same served
    blocked and matched sets (packed arrays bit-identical, dtype
    included), and every ``ServeStats`` field equal but the latencies (the
    executable-cache counters too, for services that began from equal
    cache states: ``clear_caches``).  With the two services'
    ``IncrementalResult``s of one request: the same edits, pair ids, batch
    width and degraded flag, and their stats compared the same way."""
    import numpy as np
    for f in ("packed_pairs", "packed_matches"):
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), \
            f"{f}: {a.size} vs {b.size}"
    _assert_same_serve_stats(ref.stats(), port.stats())
    if ref_res is not None:
        for f in RESULT_EDIT_FIELDS:
            a, b = getattr(ref_res, f), getattr(port_res, f)
            assert a == b, f"result.{f}: {a} vs {b}" if f in (
                "batched", "degraded") else f"result.{f} differs"
        _assert_same_serve_stats(ref_res.stats, port_res.stats)


def port_ents(ref_ents, device="cpu"):
    """The reference entity dict as the port's (tensors on ``device``)."""
    from repro_torch.core import entities as TE
    return TE.from_numpy(ref_ents, device)


def paper_cascades():
    """(reference, port) paper cascades: cosine 0.25 + Jaccard 0.25 gating
    edit distance 0.5 on ``text``, threshold 0.75."""
    from repro.core.match import CascadeMatcher, Matcher
    from repro_torch.core.match import paper_cascade
    ref = CascadeMatcher(matchers=(
        Matcher(field="feat", kind="cosine", weight=0.25, cost=1.0),
        Matcher(field="sig", kind="jaccard", weight=0.25, cost=2.0),
        Matcher(field="text", kind="edit", weight=0.5, cost=10.0),
    ), threshold=0.75)
    return ref, paper_cascade()


def to_np(x):
    """A tensor (any device) or array as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


@pytest.fixture
def cuda():
    """The CUDA device for tests marked ``gpu``: decided when the test
    runs, never at import (so every test worker collects the same tests);
    skips where there is no card."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return "cuda"


@pytest.fixture(scope="module")
def gloo_mesh():
    """A world-size-1 gloo mesh for the port's shard_map runner, on an
    in-process store; the group is destroyed after the module (unless one
    existed before), and the port's cache, whose shard_map entries are
    keyed by it, cleared."""
    pytest.importorskip("torch")
    import torch.distributed as dist

    from repro_torch.launch import make_mesh_compat
    from repro_torch.perf import executable_cache
    started = not dist.is_initialized()
    mesh = make_mesh_compat((1,), ("data",), device="cpu")
    yield mesh
    if started:
        executable_cache().clear()
        dist.destroy_process_group()
