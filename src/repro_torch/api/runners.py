"""Runners — who executes the variant's shard program (port of
``repro.api.runners``).

  * SequentialRunner  host oracle (CPU torch + numpy) with the chosen
                      variant's SEMANTICS (srp: per-partition windows;
                      repsn/jobsn: the complete SN pair set) — the reference
                      every parallel run is checked against
  * VmapRunner        one device, r shards on an explicit leading dim (the
                      reference vmaps a named axis; the collectives become
                      ops over that dim).  Answers to ``runner="vmap"``.
  * ShardMapRunner    one shard per rank of a ``torch.distributed`` process
                      group (a ``launch.Mesh``): the collectives are
                      ``torch.distributed`` calls.  Answers to
                      ``runner="shard_map"``.

All three return a ``RunnerOutcome`` with identical semantics.  The device
runners also expose ``run_raw``: the per-shard outputs (leading dim r) as
tensors on their device, for benchmarks and invariant tests.

``bounds`` may be a raw (r-1,) boundary array or a ``ShardPlan``.

Steady state: with ``cfg.jit_cache`` (the default) the device runners go
through the ``repro_torch.perf`` executable cache — each (config statics,
planner capacity, input shapes) combination is built once and, on the
card, captured as a CUDA graph that later calls replay (boundary VALUES are
graph inputs, so replanning never recaptures).  ``SequentialRunner._match``
caches its chunk scorer the same way, padding the tail chunk so every chunk
reuses one program.  ``jit_cache=False`` runs the shard program eagerly.
"""
from __future__ import annotations

from collections.abc import Set as AbstractSet
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np
import torch

from repro_torch import obs as OBS
from repro_torch.api import linkage as LK
from repro_torch.api import results as RES
from repro_torch.api.variants import get_variant
from repro_torch.balance.planners import as_plan
from repro_torch.core import entities as E
from repro_torch.core.collectives import GroupAxis, gather_shards
from repro_torch.device import resolve_device
from repro_torch.perf import cache as PC

Pair = Tuple[int, int]


def _apply_plan(ents: dict, bounds, r: int, cfg):
    """Normalize (bounds | ShardPlan) for the device runner: returns
    (ents_with_routing, bounds tensor, cap_link).  A partition count other
    than the runner's shard count is rejected."""
    plan = as_plan(bounds)
    if plan.num_shards != r:
        raise ValueError(
            f"plan defines {plan.num_shards} partitions but the runner has "
            f"{r} shards")
    dev = ents["key"].device
    if plan.dest is not None:
        ents = dict(ents)
        ents["payload"] = dict(ents["payload"], _dest=torch.as_tensor(
            np.asarray(plan.dest, np.int32), device=dev))
    # explicit cap_factor keeps its override; otherwise the planner's
    # exact capacity applies
    cap_link = plan.cap_link if cfg.cap_factor <= 0 else None
    return ents, torch.as_tensor(np.asarray(plan.bounds, np.int32),
                                 device=dev), cap_link


def _run_program(program, head: tuple, cap_link, args: tuple, cfg):
    """``program(*args)`` through the executable cache under the key
    ``head + (cfg statics, cap_link, input fingerprint)``, or eagerly when
    ``cfg.jit_cache`` is off or ``cfg`` has no static fingerprint (a
    legacy ``core.pipeline.SNConfig``), as the reference's runners do."""
    fp = getattr(cfg, "static_fingerprint", None)
    if not getattr(cfg, "jit_cache", True) or fp is None:
        return program(*args)
    call = PC.executable_cache().get_or_build(
        head + (fp(), cap_link,
                PC.tree_fingerprint(args)),
        lambda: program)
    return call(*args)


class RunnerOutcome(NamedTuple):
    """What every runner returns: host pair sets + accounting (see the
    reference's ``RunnerOutcome`` for each counter)."""
    blocked: AbstractSet[Pair]
    matched: AbstractSet[Pair]
    load: Tuple[int, ...]
    overflow: int
    num_shards: int
    cand_count: Tuple[int, ...] = ()
    cand_overflow: int = 0
    matcher_evals: int = 0
    pair_overflow: int = 0
    pruned: int = 0


class PackedOutcome(NamedTuple):
    """``RunnerOutcome`` with the pair sets left as deduplicated packed
    uint64 arrays (``(lo << 32) | hi``)."""
    blocked: np.ndarray
    matched: np.ndarray
    load: Tuple[int, ...]
    overflow: int
    num_shards: int
    cand_count: Tuple[int, ...] = ()
    cand_overflow: int = 0
    matcher_evals: int = 0
    pair_overflow: int = 0
    pruned: int = 0

    def to_outcome(self) -> RunnerOutcome:
        """The public RunnerOutcome (``PairSet``s of (lo, hi) over the
        packed arrays)."""
        return RunnerOutcome(
            blocked=RES.packed_to_frozenset(self.blocked),
            matched=RES.packed_to_frozenset(self.matched),
            load=self.load, overflow=self.overflow,
            num_shards=self.num_shards, cand_count=self.cand_count,
            cand_overflow=self.cand_overflow,
            matcher_evals=self.matcher_evals,
            pair_overflow=self.pair_overflow,
            pruned=self.pruned)


@runtime_checkable
class Runner(Protocol):
    """The execution contract every runner satisfies."""

    name: str

    @property
    def shards(self) -> int:
        ...

    def resolve(self, ents: dict, bounds, cfg) -> RunnerOutcome:
        ...

    def resolve_packed(self, ents: dict, bounds, cfg) -> PackedOutcome:
        ...


def shard_input(ents: dict, r: int) -> dict:
    """Split into r mapper shards of ceil(n/r) contiguous slots each (the
    last one padded with invalid slots): every tensor gets leading dim r."""
    n = ents["key"].shape[0]
    cap0 = int(np.ceil(n / r))
    pad = r * cap0 - n
    padded = E.concat(ents, E.empty_like(ents, pad)) if pad else ents
    return E.map_fields(
        padded, lambda x: x.reshape((r, cap0) + tuple(x.shape[1:])))


def _to_host(out):
    """Runner output -> numpy.  Emitted index buffers are cut to their
    longest valid prefix on the device first, so the transfer carries the
    pairs and not the unused capacity."""
    if torch.is_tensor(out):
        return out.cpu().numpy()
    if not isinstance(out, dict):
        return out
    out = dict(out)
    for field in ("mask", "match"):
        if field + "_idx" in out:
            used = int(out[field + "_n"].max()) if out[field + "_n"].numel() \
                else 0
            out[field + "_idx"] = out[field + "_idx"][..., :used]
    return {k: _to_host(v) for k, v in out.items()}


# the per-part counters a PackedOutcome sums (a part carries each it has)
_PART_COUNTERS = ("cand_count", "cand_overflow", "matcher_evals", "pruned",
                  "mask_overflow", "match_overflow")


@torch.inference_mode()
def _counters(out: dict, variant) -> Tuple[torch.Tensor, list]:
    """Every counter of a device output that the outcome reports, as one
    vector on its device (one launch: ``cat`` promotes to the widest
    integer dtype among them), so one copy brings them all to the host,
    and its layout: (name, size) of each piece in order — ``load`` (the
    first shard's view), ``overflow``, then each of the variant's parts'
    ``_PART_COUNTERS``."""
    pieces = [("load", out["load"][0]), ("overflow", out["overflow"][0])]
    pieces += [(k, out[p][k]) for p in variant.parts if p in out
               for k in _PART_COUNTERS if k in out[p]]
    return (torch.cat([x.reshape(-1) for _, x in pieces]),
            [(k, x.numel()) for k, x in pieces])


def _device_outcome_packed(out: dict, cfg, r: int) -> PackedOutcome:
    """Per-shard device output -> PackedOutcome.  The pair sets are made
    on the output's device (``collect_device``) and the counters copied
    as one vector (``_counters``) and summed over the parts on the host:
    three copies to the host in all, each blocking, so every read of the
    output (a replayed graph's static buffers) is done on return.  Under
    an active tracer the collection runs inside a ``collect`` span
    carrying the bytes copied (also the ``transfer_bytes`` counter) and
    the realized per-shard loads, and counts one ``device_collections``."""
    sp = OBS.span("collect")
    with sp:
        variant = get_variant(cfg.variant)
        col = variant.collect_device(out)
        vec, layout = _counters(out, variant)
        copied = vec.cpu()
        vals = copied.numpy().astype(np.int64)
        ends = np.cumsum([n for _, n in layout])
        tot = {"cand_count": np.zeros(r, np.int64)}
        for (k, _), v in zip(layout, np.split(vals, ends[:-1])):
            tot[k] = tot.get(k, 0) + (v if k in ("load", "cand_count")
                                      else int(v.sum()))
        load = tuple(int(x) for x in tot["load"])
        if sp.enabled:
            nbytes = col.blocked.nbytes + col.matched.nbytes + \
                copied.nbytes
            sp.set(transfer_bytes=nbytes, load=load)
            metrics = OBS.current_tracer().metrics
            metrics.counter("transfer_bytes").inc(nbytes)
            metrics.counter("device_collections").inc()
    return PackedOutcome(blocked=col.blocked, matched=col.matched,
                         load=load, overflow=tot["overflow"], num_shards=r,
                         cand_count=tuple(int(c) for c in tot["cand_count"]),
                         cand_overflow=tot.get("cand_overflow", 0),
                         matcher_evals=tot.get("matcher_evals", 0),
                         pair_overflow=tot.get("mask_overflow", 0)
                         + tot.get("match_overflow", 0),
                         pruned=tot.get("pruned", 0))


@dataclass(frozen=True)
class VmapRunner:
    """r shards on one device as an explicit leading dim.  ``device=None``
    means the CUDA card (raises without one)."""
    num_shards: int = 8
    device: Optional[str] = None
    name = "vmap"

    @property
    def shards(self) -> int:
        return self.num_shards

    def run_raw(self, ents: dict, bounds, cfg) -> dict:
        """Execute the variant's shard program and return the per-shard
        output dict (tensors with leading dim r on the runner's device)
        without host collection.  Routed through the executable cache
        unless ``cfg.jit_cache`` is off."""
        r = self.num_shards
        dev = resolve_device(self.device)
        variant = get_variant(cfg.variant)
        ents, b, cap_link = _apply_plan(E.to_device(ents, dev), bounds, r,
                                        cfg)

        def program(st, bd):
            return variant.shard_program(st, bd, r, cfg, cap_link=cap_link)

        with torch.inference_mode():
            stacked = shard_input(ents, r)
            rows = int(stacked["key"].shape[1])
            sp = OBS.span("shard_program", device=True, runner="vmap",
                          shards=r, rows_per_shard=rows)
            with sp:
                out = _run_program(program, ("vmap", r, "sn"), cap_link,
                                   (stacked, b), cfg)
                if sp.enabled and dev.type == "cuda":
                    # kernels return before the card ran them: fence only
                    # when traced, so the untraced path is unchanged
                    torch.cuda.synchronize(dev)
        return out

    def resolve(self, ents: dict, bounds, cfg) -> RunnerOutcome:
        return self.resolve_packed(ents, bounds, cfg).to_outcome()

    def resolve_packed(self, ents: dict, bounds, cfg) -> PackedOutcome:
        return _device_outcome_packed(self.run_raw(ents, bounds, cfg), cfg,
                                      self.num_shards)


@dataclass(frozen=True)
class ShardMapRunner:
    """One shard per rank of the process group of ``mesh`` (a
    ``launch.Mesh``; None: the default group, started at world size 1 on
    ``device`` if there is none), along mesh axis ``axis``.  As under
    SPMD every rank calls the runner with the whole entity set, runs its
    own shard's program and all-gathers the outputs, so ``run_raw``
    returns tensors with a leading per-shard dim r on every rank, exactly
    like VmapRunner.  ``device=None`` means the CUDA card (NCCL); pass
    "cpu" for gloo.  A group of the other backend is refused.  On the card the cached program is captured as a CUDA
    graph with its NCCL collectives inside, as the vmap runner's is."""
    mesh: Any = None
    axis: str = "data"
    device: Optional[str] = None
    name = "shard_map"

    def __post_init__(self):
        import torch.distributed as dist
        if self.mesh is None:
            from repro_torch.launch.mesh import make_mesh_compat
            n = dist.get_world_size() if dist.is_initialized() else 1
            object.__setattr__(self, "mesh", make_mesh_compat(
                (n,), (self.axis,), device=resolve_device(self.device)))
        if sum(s > 1 for s in self.mesh.sizes) > 1:
            raise ValueError(f"mesh {self.mesh.shape}: the shard_map runner "
                             f"takes one axis of shards (one shard per "
                             f"rank)")
        # NCCL on the card, gloo on the CPU: a gloo group would carry the
        # card's collectives through host memory
        dev = torch.device(self.device or "cuda").type
        want = "nccl" if dev == "cuda" else "gloo"
        backend = str(dist.get_backend(self.mesh.group))
        if want not in backend:
            raise ValueError(f"the mesh's process group runs {backend}; a "
                             f"shard_map runner on {dev} needs {want}")

    @property
    def shards(self) -> int:
        """Number of shards == ranks on the mesh axis."""
        return int(self.mesh.shape[self.axis])

    def run_raw(self, ents: dict, bounds, cfg) -> dict:
        """Execute this rank's shard program under the group's collectives
        and return the all-gathered per-shard output dict (leading dim r,
        exactly like ``VmapRunner.run_raw``); cached per (mesh, config
        statics, shapes) unless ``cfg.jit_cache`` is off."""
        dev = resolve_device(self.device)
        axis = GroupAxis(self.mesh.group)
        r = axis.size
        variant = get_variant(cfg.variant)
        ents, b, cap_link = _apply_plan(E.to_device(ents, dev), bounds, r,
                                        cfg)

        def program(local, bd):
            out = variant.shard_program(local, bd, r, cfg,
                                        cap_link=cap_link, axis=axis)
            return PC.map_tensors(out,
                                  lambda x: gather_shards(x[0], axis))

        with torch.inference_mode():
            stacked = shard_input(ents, r)
            local = E.map_fields(stacked,
                                 lambda x: x[axis.rank:axis.rank + 1])
            rows = int(stacked["key"].shape[1])
            sp = OBS.span("shard_program", device=True, runner="shard_map",
                          shards=r, rows_per_shard=rows)
            with sp:
                out = _run_program(
                    program, ("shard_map", self.axis, self.mesh), cap_link,
                    (local, b), cfg)
                if sp.enabled and dev.type == "cuda":
                    torch.cuda.synchronize(dev)   # see VmapRunner.run_raw
        return out

    def resolve(self, ents: dict, bounds, cfg) -> RunnerOutcome:
        return self.resolve_packed(ents, bounds, cfg).to_outcome()

    def resolve_packed(self, ents: dict, bounds, cfg) -> PackedOutcome:
        return _device_outcome_packed(self.run_raw(ents, bounds, cfg), cfg,
                                      self.shards)


def _rows_of_pairs(ents_host: dict, blocked: np.ndarray):
    """Row indices (into the host entity dict) of each packed pair's two
    eids, with ``blocked`` sorted (lexicographic (lo, hi) order)."""
    rows = np.nonzero(ents_host["valid"])[0]
    eids = ents_host["eid"][rows]
    order = np.argsort(eids)
    sorted_eids, sorted_rows = eids[order], rows[order]
    plo, phi = RES.unpack_pairs(blocked)
    return (sorted_rows[np.searchsorted(sorted_eids, plo)],
            sorted_rows[np.searchsorted(sorted_eids, phi)])


@dataclass(frozen=True)
class SequentialRunner:
    """Host oracle: variant-faithful sequential blocking + batched matching
    on the CPU.  ``load`` reports per-PARTITION sizes."""
    num_shards: int = 1
    name = "sequential"
    match_chunk: int = 1 << 16

    @property
    def shards(self) -> int:
        return self.num_shards

    def resolve(self, ents: dict, bounds, cfg) -> RunnerOutcome:
        return self.resolve_packed(ents, bounds, cfg).to_outcome()

    def resolve_packed(self, ents: dict, bounds, cfg) -> PackedOutcome:
        plan = as_plan(bounds)
        bounds = np.asarray(plan.bounds)
        r = plan.num_shards
        host = E.to_host(ents)
        valid = host["valid"]
        keys = host["key"][valid]
        eids = host["eid"][valid]
        part = plan.assignment(host["key"], valid)
        weff_all = host["payload"].get("_weff")
        weff = None if weff_all is None else weff_all[valid]

        with OBS.span("block", runner="sequential", shards=r):
            blocked = RES.pack_pair_set(
                get_variant(cfg.variant).sequential_pairs(
                    keys, eids, bounds, cfg.window, part=part, weff=weff))
            if getattr(cfg, "linkage", False) and "src" in host["payload"]:
                src = host["payload"]["src"][valid]
                blocked = LK.filter_cross_source_packed(blocked, eids, src)
        pruned = 0
        if getattr(cfg, "prune_policy", "off") == "evidence":
            blocked, pruned = self._prune(host, blocked, cfg)
        with OBS.span("match", pairs=int(blocked.size)):
            matched = self._match(host, blocked, cfg)

        load = tuple(np.bincount(part, minlength=r).astype(int).tolist())
        return PackedOutcome(blocked=blocked, matched=matched,
                             load=load, overflow=0, num_shards=r,
                             matcher_evals=int(blocked.size),
                             pruned=pruned)

    def _prune(self, host: dict, blocked: np.ndarray, cfg
               ) -> Tuple[np.ndarray, int]:
        """Evidence pruning, sequential form: each blocked pair's CHEAP
        cascade evidence with the same math the band engines'
        ``prune_low_evidence`` uses — identical keep decisions."""
        from repro_torch.core import window as W
        from repro_torch.core.match import cosine_sim, jaccard_sig

        payload = {k: torch.from_numpy(v)
                   for k, v in host["payload"].items()}
        split = W.split_cascade(cfg.matcher, payload)
        if split is None:
            raise ValueError(
                "prune_policy='evidence' needs a matcher whose cascade "
                "starts with a kernel-supported cheap stage (cosine/jaccard "
                "on a present payload field); split_cascade found none")
        if blocked.size == 0:
            return blocked, 0
        blocked = np.sort(blocked)
        ra, rb = (torch.from_numpy(x) for x in _rows_of_pairs(host, blocked))
        cheap = torch.zeros(ra.shape[0], dtype=torch.float32)
        if split.feat_field is not None:
            feat = payload[split.feat_field]
            cheap = cheap + split.w_cos * cosine_sim(feat[ra], feat[rb])
        if split.sig_field is not None:
            sig = payload[split.sig_field]
            cheap = cheap + split.w_jac * jaccard_sig(sig[ra], sig[rb])
        bar = cfg.prune_threshold * (split.w_cos + split.w_jac) - W.GATE_EPS
        kept = blocked[(cheap >= bar).numpy()]
        return kept, int(blocked.size - kept.size)

    def _match(self, host: dict, blocked: np.ndarray, cfg) -> np.ndarray:
        """Score blocked pairs (packed uint64) with the cascade matcher in
        chunks (skip=False: identical accept/reject decisions, exact
        scores).  Returns the matched subset, still packed.

        The chunk scorer goes through the executable cache once per
        (matcher, chunk, payload schema); the tail chunk is padded to
        ``match_chunk`` so every chunk reuses one program."""
        if blocked.size == 0:
            return blocked
        blocked = np.sort(blocked)          # == lexicographic (lo, hi) order
        ra, rb = _rows_of_pairs(host, blocked)
        payload = {k: torch.from_numpy(v)
                   for k, v in host["payload"].items()}
        matcher = cfg.matcher
        chunk = self.match_chunk

        def program(pl, ia, ib):
            pa = {k: v[ia] for k, v in pl.items()}
            pb = {k: v[ib] for k, v in pl.items()}
            score, _ = matcher.combined(pa, pb, skip=False)
            return score >= matcher.threshold

        if getattr(cfg, "jit_cache", True):
            scorer = PC.executable_cache().get_or_build(
                ("seq_match", matcher, chunk, PC.tree_fingerprint(payload)),
                lambda: program)
        else:
            scorer = program
        keep = np.zeros(blocked.shape[0], bool)
        with torch.inference_mode():
            for s in range(0, blocked.shape[0], chunk):
                ia, ib = ra[s:s + chunk], rb[s:s + chunk]
                ln = ia.shape[0]
                if ln < chunk:              # pad the tail: one program
                    ia = np.concatenate([ia, np.zeros(chunk - ln, ia.dtype)])
                    ib = np.concatenate([ib, np.zeros(chunk - ln, ib.dtype)])
                got = scorer(payload, torch.from_numpy(ia),
                             torch.from_numpy(ib))
                keep[s:s + ln] = got[:ln].numpy()
        return blocked[keep]
