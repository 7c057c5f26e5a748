"""Executable cache — build each shard program once, replay it after
(port of ``repro.perf.cache``).

The reference maps every

    (runner kind, cfg static fingerprint, cap_link, input shapes/dtypes)

to one jitted executable, so a second same-shaped call is one XLA
dispatch.  PyTorch runs eagerly; the port's counterpart of an executable
is a captured CUDA graph:

  * **On the card** an entry's first call (the miss) runs the program
    eagerly as its warm-up — that run's result is the call's result — and
    then captures it as a ``torch.cuda.CUDAGraph``: one trace.  Every
    later call (a hit) copies its inputs into the graph's static input
    buffers, replays the graph and returns clones of its static outputs,
    so no later replay overwrites what a caller holds.  Inputs are always
    copied: nothing a caller holds is written, and ``donate_argnums`` is
    accepted for the reference's signature only.  A call whose inputs
    disagree with the captured shapes raises; it never replays.
  * **On the CPU** there is no graph: the entry holds the built callable,
    and its first run is the counted trace.  The counters then equal the
    reference's for the same sequence of calls.

Keys are exact, as in the reference: everything that shapes the program
is in the key — runner, shard count and axis, ``ERConfig.
static_fingerprint()``, ``cap_link``, and the inputs' structure, shapes,
dtypes and devices (``tree_fingerprint``).  Boundary *values* are graph
inputs, so replanning never recaptures.

Each graph captures into a memory pool of its own, which no eager work can
use.  Static inputs are allocated outside it, and the caching allocator
is emptied between the warm-up and the capture.  A warm-up's peak stacks
on what the kept graphs hold, so before a program's first run on the card
the cache evicts least-recently-used graphs of that device until those it
keeps hold at most ``GRAPH_MEMORY_SHARE`` of the card's memory (a graph's
bytes are its static inputs and what its capture added to the reserved
memory).  ``clear()`` and every eviction reset the
graphs and return their pools to the card.

Kernel launch counts (``kernels.ops.LAUNCHES``) are host-side counts, and
a replay launches without the host.  The cache records the counts a
capture added, takes them back (nothing ran), and adds them again on every
replay, so a count still says how often a kernel ran.

The runners route through the cache unless ``cfg.jit_cache`` is off;
``facade.resolve``, the stream resolver and the service meter it with
``stats.snapshot()`` / ``stats.delta()``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch

# entries kept before least-recently-used eviction (the reference's)
DEFAULT_MAX_ENTRIES = 256
# the share of a card's memory the kept graphs may hold when a new
# program's warm-up starts: the warm-up's own peak stacks on it (a
# full-size skewed plan's warm-up reserves ~54 of the 80 GB)
GRAPH_MEMORY_SHARE = 1 / 16


@dataclass
class CacheStats:
    """Counters of the executable cache (process-wide, monotone).

    ``misses`` counts builds; ``traces`` counts first runs (CPU) or
    captures (card) of built programs — equal in a healthy cache.
    ``evictions`` counts LRU drops, by entry count or by graph bytes (an
    evicted key rebuilds on next use)."""
    hits: int = 0
    misses: int = 0
    traces: int = 0
    evictions: int = 0

    def snapshot(self) -> Tuple[int, int, int]:
        """Current (hits, misses, traces)."""
        return (self.hits, self.misses, self.traces)

    def delta(self, since: Tuple[int, int, int]) -> Tuple[int, int, int]:
        """(hits, misses, traces) accrued since a ``snapshot()``."""
        h, m, t = since
        return (self.hits - h, self.misses - m, self.traces - t)


def tree_fingerprint(tree) -> Tuple:
    """Hashable (structure, shapes, dtypes, devices) key of an argument
    tree of dicts, tuples and lists over tensors; any other leaf is keyed
    by its value."""
    if torch.is_tensor(tree):
        return ("tensor", tuple(tree.shape), str(tree.dtype),
                str(tree.device))
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_fingerprint(tree[k]))
                              for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,
                tuple(tree_fingerprint(x) for x in tree))
    return ("value", tree)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in ``tree_fingerprint``'s order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def map_tensors(tree, fn):
    """``tree`` with every tensor replaced by ``fn(tensor)``; other leaves
    ride along."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(x, fn) for x in tree)
    return tree


def _cuda_device(args) -> Optional[torch.device]:
    devs = {t.device for t in _leaves(args)}
    cuda = [d for d in devs if d.type == "cuda"]
    if cuda and len(devs) > 1:
        raise ValueError(f"a cached program's inputs span "
                         f"{sorted(map(str, devs))}")
    return cuda[0] if cuda else None


class _Graph:
    """A program captured on the card: static inputs, static outputs, the
    kernel launches one replay makes and the device bytes it holds."""

    def __init__(self, fn, args, device):
        from repro_torch.kernels import ops
        self.device = device
        # static inputs, outside the graph's pool
        self.inputs = map_tensors(args,
                                  lambda t: torch.empty_like(t).copy_(t))
        self.shapes = [(t.shape, t.dtype, t.device)
                       for t in _leaves(self.inputs)]
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()        # the warm-up's blocks back to the card
        reserved = torch.cuda.memory_reserved(device)
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                self.outputs = fn(*self.inputs)
        finally:
            # the capture launched nothing: its counts come back on replay
            self.launches = {k: ops.LAUNCHES[k] - n
                             for k, n in before.items()}
            ops.LAUNCHES.update(before)
        # the pool is every segment the capture added
        self.bytes = torch.cuda.memory_reserved(device) - reserved + sum(
            t.nbytes for t in _leaves(self.inputs))

    def replay(self, args):
        from repro_torch.kernels import ops
        got = [(t.shape, t.dtype, t.device) for t in _leaves(args)]
        if got != self.shapes:
            raise ValueError(f"inputs {got} do not match the captured "
                             f"graph's {self.shapes}")
        for dst, src in zip(_leaves(self.inputs), _leaves(args)):
            dst.copy_(src)
        self.graph.replay()
        out = map_tensors(self.outputs, torch.clone)
        for k, n in self.launches.items():
            ops.LAUNCHES[k] += n
        return out

    def release(self) -> None:
        """Reset the graph: its pool goes back to the card at the next
        ``torch.cuda.empty_cache()``."""
        torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.inputs = self.outputs = None


class _Program:
    """One cache entry: the built program and, once run on the card, its
    captured graph."""

    def __init__(self, cache: "ExecutableCache", fn: Callable):
        self._cache, self._fn = cache, fn
        self._run = False
        self._graph: Optional[_Graph] = None

    def __call__(self, *args):
        if self._run and self._graph is None:
            return self._fn(*args)          # the CPU
        with self._cache._lock:     # a graph's buffers serve one call
            graph = self._graph
            if graph is not None:
                return graph.replay(args)
            if self._run:                   # released by clear()
                return self._fn(*args)
            device = _cuda_device(args)
            if device is not None:
                self._cache._make_room(device, keep=self)
            self._cache.stats.traces += 1
            out = self._fn(*args)           # the warm-up, on the card
            if device is not None:
                self._graph = _Graph(self._fn, args, device)
            # only now: a first call that raised leaves the entry to be
            # built again, never to run eagerly
            self._run = True
            return out

    def graph_bytes(self, device: torch.device) -> int:
        """Device bytes the entry's graph holds on ``device``."""
        g = self._graph
        return g.bytes if g is not None and g.device == device else 0

    def release(self) -> None:
        if self._graph is not None:
            self._graph.release()
            self._graph = None


class ExecutableCache:
    """Maps hashable program keys to built programs (see module doc),
    bounded by LRU eviction: ``max_entries`` entries, and on each card
    ``GRAPH_MEMORY_SHARE`` of its memory in kept graphs when a new
    program's warm-up starts."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self._fns: "OrderedDict[Any, _Program]" = OrderedDict()
        self._lock = threading.RLock()
        self.max_entries = max_entries
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._fns)

    def graph_bytes(self, device) -> int:
        """Device bytes the kept graphs hold on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            return sum(p.graph_bytes(device) for p in self._fns.values())

    def _evict(self, keys) -> None:
        """Drop ``keys``, reset their graphs and return the pools."""
        for key in keys:
            self._fns.pop(key).release()
            self.stats.evictions += 1
        if keys and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def _make_room(self, device: torch.device, keep: "_Program") -> None:
        """Before ``keep``'s warm-up on ``device``: evict least-recently-
        used graphs there until the kept ones hold at most the budget."""
        budget = torch.cuda.get_device_properties(device).total_memory \
            * GRAPH_MEMORY_SHARE
        held = sum(p.graph_bytes(device) for p in self._fns.values())
        drop = []
        for key, p in self._fns.items():        # least recently used first
            if held <= budget:
                break
            if p is not keep and p.graph_bytes(device):
                held -= p.graph_bytes(device)
                drop.append(key)
        self._evict(drop)

    def clear(self) -> None:
        """Drop every entry, reset its graph and return the graphs' pool
        memory to the card (the stats keep counting)."""
        with self._lock:
            programs = list(self._fns.values())
            self._fns.clear()
            for p in programs:
                p.release()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()

    def get_or_build(self, key, build: Callable[[], Callable], *,
                     donate_argnums: Tuple[int, ...] = ()) -> Callable:
        """The program for ``key``, built by ``build()`` on a miss.  On
        the card its first call captures a graph that later calls replay.
        ``donate_argnums`` is kept for the reference's signature only and
        changes nothing: inputs are always copied."""
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.stats.hits += 1
                self._fns.move_to_end(key)
                return fn
            self.stats.misses += 1
            fn = _Program(self, build())
            self._fns[key] = fn
            self._evict(list(self._fns)[:max(0, len(self._fns)
                                             - self.max_entries)])
            return fn


_GLOBAL_CACHE = ExecutableCache()


def executable_cache() -> ExecutableCache:
    """The process-wide cache every runner routes through."""
    return _GLOBAL_CACHE
