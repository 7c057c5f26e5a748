"""Checkpointed streaming — the on-disk resume protocol of DESIGN.md §11
(port of ``repro.resilience.checkpoint``: the same directory layout,
manifest schema and commit order, so a checkpoint either package wrote
resumes in the other).

A checkpoint directory is the durable mirror of one ``resolve_stream`` run:

    MANIFEST.json           versioned manifest (atomic tmp-then-rename):
                            config fingerprint, ingest progress, and one
                            state record per streaming pass
    raw/raw%06d.npz         the ingested chunk store (shared across passes)
    runs-<label>/run%06d.npz  the pass's sorted runs (external-sort output)
    profile-<label>.npz     the pass's merged KeyProfile
    pairs-<label>-%06d.npz  per-chunk packed blocked/matched pair spool
    carry-<label>.npz       the current w-1 seam halo (overwritten per chunk)

Commit protocol (per resolved chunk): write the chunk's pair spool, write
the carry, then write the manifest recording ``completed_chunks = k+1``
plus every accumulated counter.  All three are atomic writes, and the
manifest is LAST — so a crash anywhere leaves either a manifest that does
not know about chunk k (the orphaned spool/carry files are simply
overwritten when the chunk is redone) or a fully committed chunk.  Nothing
is ever partially visible, which is what makes invariant 11 (resumed pair
union == uninterrupted run) hold at every kill point.

Resume (``resume_stream`` / ``api.resume``) re-derives the merged stream
from the durable sorted runs — the external merge is deterministic — skips
``completed_chunks`` chunks, reloads their pair spools, restores the carry
and counters, and continues the loop as if never interrupted.  A run killed
mid-INGEST resumes too, but needs the chunk iterator re-supplied (the
already-committed prefix is skipped; the iterator must be deterministic).

Checkpointed runs do not support ``compute_metrics`` (the host oracle is a
whole-run accumulation the checkpoint deliberately does not persist).

Signatures are uint32 on disk, as the reference writes them; the store's
``disk_arrays`` / ``host_entities`` convert the port's int32 bit views at
that boundary (``repro_torch.stream.store``).  The manifest's executable-
cache counters (``steady``, ``hits``, ``misses``, ``traces``) are the
port's cache's, metered per chunk as in the reference.
"""
from __future__ import annotations

import json
import os
import re
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch import balance as B


def _store():
    # lazy: repro_torch.stream's package __init__ pulls in the resolver,
    # which imports repro_torch.api.results, which imports this package —
    # importing the store eagerly here would close that cycle
    # mid-initialization
    from repro_torch.stream import store as S
    return S

MANIFEST = "MANIFEST.json"
VERSION = 1

# ERConfig fields the manifest serializes verbatim (everything except the
# matcher, which is rebuilt as default_matcher() or re-supplied by the
# caller) — SortKeySpec passes are stored as dicts
_CFG_FIELDS = ("window", "variant", "hops", "cap_factor", "return_scores",
               "band_engine", "band_block", "cand_cap", "band_interpret",
               "emit", "pair_cap", "jit_cache", "on_overflow", "retry_limit",
               "runner", "num_shards", "partitioner", "linkage",
               "window_policy", "window_max", "prune_policy",
               "prune_threshold")
_PASS_FIELDS = ("name", "source", "kind", "offset", "width", "index")

_COUNTERS = ("chunks", "carry_total", "degenerate", "steady", "hits",
             "misses", "traces", "overflow", "cand_overflow",
             "matcher_evals", "pair_overflow", "pruned", "retries",
             "escalations", "device_bytes")


def _slug(label: str) -> str:
    """Filesystem-safe pass label (pass names are user strings)."""
    return re.sub(r"[^A-Za-z0-9_.-]", "_", label) or "pass"


def _fresh_pass_state() -> dict:
    state = {c: 0 for c in _COUNTERS}
    state.update(sorted=False, n_runs=0, completed_chunks=0, rank_offset=0,
                 carry_rows=0, done=False, load_max=[], cand_max=[])
    return state


class StreamCheckpoint:
    """Handle on one checkpoint directory (see module doc).

    ``open`` creates a fresh manifest or attaches to an existing one whose
    fingerprint matches the supplied config (so re-running the same
    ``resolve_stream(checkpoint_dir=...)`` command after a kill IS a
    resume); ``load`` attaches without a config (``api.resume``) and
    rebuilds it from the manifest."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest

    # -- construction --------------------------------------------------------

    @classmethod
    def open(cls, path: str, cfg, chunk_size: Optional[int]
             ) -> "StreamCheckpoint":
        """Create a fresh checkpoint at ``path``, or attach to an existing
        one — re-running the original call IS the resume path.  Attaching
        validates ``cfg`` (fingerprint + host setup) and ``chunk_size``
        against the manifest: both shape the committed chunk grid, so
        drift across a resume is rejected loudly."""
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, MANIFEST)
        if os.path.exists(mpath):
            ckpt = cls.load(path)
            ckpt._check_config(cfg)
            if ckpt.manifest["chunk_size"] != chunk_size:
                raise ValueError(
                    f"checkpoint {path!r} was created with chunk_size="
                    f"{ckpt.manifest['chunk_size']} but this run requests "
                    f"{chunk_size}; the chunk grid defines every commit "
                    f"point, so it cannot change across a resume")
            return ckpt
        manifest = {
            "version": VERSION,
            "fingerprint": repr(cfg.static_fingerprint()),
            "host": {"runner": cfg.runner, "num_shards": cfg.num_shards,
                     "partitioner": cfg.partitioner},
            "default_matcher": cls._is_default_matcher(cfg),
            "config": cls._config_blob(cfg),
            "chunk_size": chunk_size,
            "phase": "ingest",
            "ingest": {"chunks": 0, "max_len": 0, "total": 0, "nbytes": 0},
            "passes": {},
        }
        ckpt = cls(path, manifest)
        ckpt.save()
        return ckpt

    @classmethod
    def load(cls, path: str) -> "StreamCheckpoint":
        """Attach to an existing checkpoint directory (manifest version
        checked); raises FileNotFoundError if ``path`` holds none."""
        mpath = os.path.join(path, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no checkpoint manifest at {mpath!r}; was this run started "
                f"with resolve_stream(checkpoint_dir=...)?")
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("version") != VERSION:
            raise ValueError(
                f"checkpoint {path!r} has manifest version "
                f"{manifest.get('version')!r}; this build reads version "
                f"{VERSION} — finish it with the build that wrote it")
        return cls(path, manifest)

    def save(self) -> None:
        """Atomically rewrite the manifest — the ONE commit point: state
        not reachable from the manifest does not exist after a crash."""
        _store().atomic_write_json(os.path.join(self.path, MANIFEST),
                                   self.manifest)

    # -- config round-trip ---------------------------------------------------

    @staticmethod
    def _is_default_matcher(cfg) -> bool:
        from repro_torch.core.match import default_matcher
        return cfg.matcher == default_matcher()

    @staticmethod
    def _config_blob(cfg) -> dict:
        blob = {f: getattr(cfg, f) for f in _CFG_FIELDS}
        blob["passes"] = [{f: getattr(p, f) for f in _PASS_FIELDS}
                          for p in cfg.passes]
        return blob

    def _check_config(self, cfg) -> None:
        fp = repr(cfg.static_fingerprint())
        if fp != self.manifest["fingerprint"]:
            raise ValueError(
                f"config does not match checkpoint {self.path!r}: "
                f"fingerprint {fp} vs stored {self.manifest['fingerprint']} "
                f"— a resumed run must use the original configuration")
        host = {"runner": cfg.runner, "num_shards": cfg.num_shards,
                "partitioner": cfg.partitioner}
        if host != self.manifest["host"]:
            raise ValueError(
                f"execution setup does not match checkpoint {self.path!r}: "
                f"{host} vs stored {self.manifest['host']} (shard count and "
                f"partitioner shape the pair sets — they cannot change "
                f"across a resume)")

    def resolve_config(self, cfg=None):
        """The checkpoint's ERConfig: validate ``cfg`` against the stored
        fingerprint, or rebuild from the manifest (default matcher only —
        a custom matcher cannot be serialized and must be re-supplied)."""
        if cfg is not None:
            self._check_config(cfg)
            return cfg
        if not self.manifest["default_matcher"]:
            raise ValueError(
                f"checkpoint {self.path!r} was created with a non-default "
                f"matcher, which the manifest cannot serialize; call "
                f"resume(checkpoint_dir, cfg=<original config>)")
        from repro_torch.api.config import ERConfig, SortKeySpec
        blob = dict(self.manifest["config"])
        passes = tuple(SortKeySpec(**p) for p in blob.pop("passes"))
        cfg = ERConfig(passes=passes, **blob)
        self._check_config(cfg)
        return cfg

    # -- ingest phase --------------------------------------------------------

    @property
    def phase(self) -> str:
        """Lifecycle phase: ``"ingest"`` → ``"resolve"`` → ``"done"``."""
        return self.manifest["phase"]

    @property
    def ingest(self) -> dict:
        """Committed ingest totals (chunks / max_len / total / nbytes)."""
        return self.manifest["ingest"]

    def raw_store(self):
        """The durable raw chunk store, re-attached to exactly the
        committed chunk count (un-committed debris swept)."""
        raw_dir = os.path.join(self.path, "raw")
        if not os.path.isdir(raw_dir):
            return _store().ChunkStore(raw_dir, prefix="raw")
        return _store().ChunkStore.attach(raw_dir, "raw",
                                 count=self.ingest["chunks"])

    def commit_raw(self, max_len: int, total: int, nbytes: int) -> None:
        """Commit one durably-appended raw chunk (running totals)."""
        self.manifest["ingest"] = {
            "chunks": self.ingest["chunks"] + 1, "max_len": max_len,
            "total": total, "nbytes": nbytes}
        self.save()

    def ingest_done(self) -> None:
        """Advance ingest → resolve (idempotent on a resumed run)."""
        if self.manifest["phase"] == "ingest":
            self.manifest["phase"] = "resolve"
            self.save()

    def mark_done(self) -> None:
        """Commit run completion; a resume of a done checkpoint replays
        the (deterministic) merge and returns the identical result."""
        self.manifest["phase"] = "done"
        self.save()

    # -- per-pass state ------------------------------------------------------

    def pass_state(self, label: str) -> dict:
        """The pass's live manifest state dict (created on first touch):
        sort status, completed_chunks, carry/rank bookkeeping, and every
        streaming counter — mutate it, then ``save()`` to commit."""
        states = self.manifest["passes"]
        if label not in states:
            states[label] = _fresh_pass_state()
        return states[label]

    def runs_store(self, label: str):
        """(runs store, sorted_already): attach the pass's committed sorted
        runs, or hand back a swept store for a (re)run of the sort phase —
        a crash mid-sort simply redoes it."""
        runs_dir = os.path.join(self.path, f"runs-{_slug(label)}")
        state = self.pass_state(label)
        if state["sorted"]:
            return _store().ChunkStore.attach(runs_dir, "run",
                                     count=state["n_runs"]), True
        if os.path.isdir(runs_dir):          # sweep a half-written sort
            _store().ChunkStore.attach(runs_dir, "run", count=0)
        return _store().ChunkStore(runs_dir, prefix="run"), False

    def commit_sorted(self, label: str, runs,
                      profile: B.KeyProfile) -> None:
        """Commit the pass's sort phase: profile to disk, then manifest."""
        _store().atomic_savez(
            self._profile_path(label),
            n=np.int64(profile.n), window=np.int64(profile.window),
            uniq=profile.uniq, counts=profile.counts,
            cum_entities=profile.cum_entities,
            block_comparisons=profile.block_comparisons,
            cum_comparisons=profile.cum_comparisons)
        state = self.pass_state(label)
        state["sorted"] = True
        state["n_runs"] = len(runs)
        self.save()

    def load_profile(self, label: str) -> B.KeyProfile:
        """Reload the pass's committed ``KeyProfile`` (the exact merged
        profile — SRP replanning on resume is bit-identical)."""
        with np.load(self._profile_path(label), allow_pickle=False) as z:
            return B.KeyProfile(
                n=int(z["n"]), window=int(z["window"]), uniq=z["uniq"],
                counts=z["counts"], cum_entities=z["cum_entities"],
                block_comparisons=z["block_comparisons"],
                cum_comparisons=z["cum_comparisons"])

    # -- per-chunk commits ---------------------------------------------------

    def spool_chunk(self, label: str, chunk: int, blocked: np.ndarray,
                    matched: np.ndarray) -> None:
        """Write chunk ``chunk``'s packed pair arrays (atomic; NOT yet
        committed — the manifest still points at the previous chunk)."""
        _store().atomic_savez(self._pairs_path(label, chunk),
                     blocked=blocked, matched=matched)

    def commit_chunk(self, label: str, carry: Optional[dict],
                     **state_updates) -> None:
        """Commit one completed chunk: persist the seam halo, then write
        the manifest with ``completed_chunks`` advanced and every
        accumulator updated.  The manifest write is the commit point."""
        state = self.pass_state(label)
        if carry is not None:
            _store().atomic_savez(
                os.path.join(self.path, f"carry-{_slug(label)}.npz"),
                **_store().disk_arrays(carry))
            state["carry_rows"] = int(carry["key"].shape[0])
        state["completed_chunks"] += 1
        state.update(state_updates)
        self.save()

    def load_pairs(self, label: str,
                   chunk: int) -> Tuple[np.ndarray, np.ndarray]:
        """(blocked, matched) packed uint64 pair arrays of one committed
        chunk — the restore path re-unions them on resume."""
        with np.load(self._pairs_path(label, chunk),
                     allow_pickle=False) as z:
            return z["blocked"], z["matched"]

    def load_carry(self, label: str) -> Optional[dict]:
        """The persisted w−1 seam-halo carry of the last committed chunk
        (host entity dict), or None when nothing carries over."""
        state = self.pass_state(label)
        if state["carry_rows"] == 0 or state["completed_chunks"] == 0:
            return None
        path = os.path.join(self.path, f"carry-{_slug(label)}.npz")
        with np.load(path, allow_pickle=False) as z:
            return _store().host_entities(z)

    def mark_pass_done(self, label: str) -> None:
        """Commit the pass as fully resolved (all chunks committed)."""
        state = self.pass_state(label)
        state["done"] = True
        self.save()

    def _profile_path(self, label: str) -> str:
        return os.path.join(self.path, f"profile-{_slug(label)}.npz")

    def _pairs_path(self, label: str, chunk: int) -> str:
        return os.path.join(self.path,
                            f"pairs-{_slug(label)}-{chunk:06d}.npz")


def resume_stream(checkpoint_dir: str, *, chunks: Optional[Iterable] = None,
                  cfg=None, mesh=None, axis: str = "data", device=None):
    """Resume a checkpointed ``resolve_stream`` run (== ``api.resume``).

    Loads the manifest, validates/rebuilds the config (``cfg`` is only
    required when the original run used a non-default matcher), and
    continues at the last committed chunk.  ``chunks`` must re-supply the
    original (deterministic) chunk iterator ONLY when the run died during
    ingest — after ingest the corpus is durable in the checkpoint and the
    iterator is not consulted.  ``mesh``/``axis`` select the process
    group of the shard_map runner; ``device`` is where the remaining
    chunks are sorted and resolved (None = the CUDA card).  Returns the same
    ``StreamResult`` an uninterrupted run would have returned, with a
    bit-identical pair union (invariant 11)."""
    from repro_torch.device import resolve_device
    from repro_torch.stream import resolver
    ckpt = StreamCheckpoint.load(checkpoint_dir)
    cfg = ckpt.resolve_config(cfg)
    return resolver._resolve_checkpointed(chunks, cfg, ckpt, mesh=mesh,
                                          axis=axis,
                                          device=resolve_device(device),
                                          fault=None)
