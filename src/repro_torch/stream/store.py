"""Spooled chunk storage — the out-of-core buffer behind ``resolve_stream``
(port of ``repro.stream.store``; numpy and the leaf ``obs``, the same
on-disk layout).

A ``ChunkStore`` holds a sequence of HOST entity chunks (the numpy schema of
``core.entities.to_host``) either in memory (default) or spooled to disk as
``.npz`` files (``spool_dir``) — the stand-in for the paper's HDFS sequence
files.  Spooled chunks are written once at append time and re-read on
demand, so the resident set during the external merge is the per-run index
plus the runs currently being consumed, never the whole corpus.

Two access granularities keep the merge cheap:

  * ``load(i)``        the full chunk (key/eid/valid + payload) — read when
                       a merge block actually gathers the chunk's rows
  * ``load_index(i)``  only ``key``/``eid`` — the 8–12 bytes/entity the
                       k-way merge needs to ORDER the stream (``.npz``
                       members are decompressed lazily, so payload bytes
                       stay on disk)

**Signature dtype.**  The port's host dicts hold the ``UINT32_FIELDS``
(``sig``) as int32 bit views; the reference's files hold uint32.  The disk
is the one boundary: ``disk_arrays`` writes those fields as uint32 and
``host_entities`` reads them back as int32 views, so spool, carry and
checkpoint files are the reference's byte for byte and a checkpoint
either package wrote resumes in the other.

**Tracing.**  A spooled store's disk writes and reads are ``spool`` spans
(``op`` = ``write``, ``read``, ``index`` or ``field``); an in-memory store
(``spool_dir=None``, as the serve index's) opens none.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch import obs as OBS
from repro_torch.core.entities import UINT32_FIELDS

_PAYLOAD_PREFIX = "payload__"
_TMP_SUFFIX = ".tmp"


def disk_arrays(ents: dict) -> Dict[str, np.ndarray]:
    """The ``.npz`` members of one host entity dict: key/eid/valid plus
    ``payload__<field>`` columns, the ``UINT32_FIELDS`` as uint32."""
    def col(k, v):
        v = np.asarray(v)
        return v.view(np.uint32) if k in UINT32_FIELDS and \
            v.dtype == np.int32 else v
    return dict(key=ents["key"], eid=ents["eid"], valid=ents["valid"],
                **{_PAYLOAD_PREFIX + k: col(k, v)
                   for k, v in ents["payload"].items()})


def host_column(name: str, a: np.ndarray) -> np.ndarray:
    """One host column in the port's dtype: a ``UINT32_FIELDS`` column held
    as uint32 (the reference's form) viewed as int32; others as they are."""
    return a.view(np.int32) if name in UINT32_FIELDS and \
        a.dtype == np.uint32 else a


def host_entities(z) -> dict:
    """A host entity dict from an open ``.npz`` written by ``disk_arrays``
    (or by the reference): the ``UINT32_FIELDS`` as int32 bit views."""
    n = len(_PAYLOAD_PREFIX)
    return {
        "key": z["key"], "eid": z["eid"], "valid": z["valid"],
        "payload": {k[n:]: host_column(k[n:], z[k])
                    for k in z.files if k.startswith(_PAYLOAD_PREFIX)},
    }


def atomic_savez(path: str, **arrays) -> None:
    """Write an ``.npz`` crash-atomically: serialize to ``{path}.tmp`` in
    the same directory, then ``os.replace`` onto the final name.  A reader
    (or a resumed run) therefore sees either the complete previous file or
    the complete new one, never a torn write; a crash mid-write leaves only
    a ``.tmp`` leftover that re-attachment/disposal sweeps up."""
    tmp = path + _TMP_SUFFIX
    with open(tmp, "wb") as f:       # file object: savez must not append
        np.savez(f, **arrays)        # its .npz suffix to the tmp name
    os.replace(tmp, path)


def atomic_write_json(path: str, obj) -> None:
    """Crash-atomic JSON write (same tmp-then-``os.replace`` contract as
    ``atomic_savez``) — the manifest writer of ``repro_torch.resilience``."""
    import json
    tmp = path + _TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


class ChunkStore:
    """Append-only sequence of host entity chunks, optionally disk-spooled.

    ``spool_dir=None`` keeps chunks in memory (tests, small corpora);
    otherwise each appended chunk is written to
    ``{spool_dir}/{prefix}{i:06d}.npz`` and dropped from memory.  All
    chunks must share one payload schema (validated on append)."""

    def __init__(self, spool_dir: Optional[str] = None,
                 prefix: str = "chunk"):
        self.spool_dir = spool_dir
        self.prefix = prefix
        self.spooled_bytes = 0
        self._mem: List[Optional[dict]] = []
        self._paths: List[str] = []
        self._schema: Optional[tuple] = None
        if spool_dir is not None:
            os.makedirs(spool_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._mem)

    @classmethod
    def attach(cls, spool_dir: str, prefix: str = "chunk",
               count: Optional[int] = None) -> "ChunkStore":
        """Re-open an existing on-disk spool (the checkpoint/resume path).

        Adopts ``{prefix}{i:06d}.npz`` for consecutive ``i`` from 0; with
        ``count`` (a manifest's durably-committed chunk total) exactly that
        many files are adopted — later files and ``.tmp`` leftovers are
        DELETED, since they can only be the un-committed debris of the
        append that was in flight when the previous run died."""
        store = cls(spool_dir, prefix=prefix)
        i = 0
        while count is None or i < count:
            path = os.path.join(spool_dir, f"{prefix}{i:06d}.npz")
            if not os.path.exists(path):
                break
            store._mem.append(None)
            store._paths.append(path)
            store.spooled_bytes += os.path.getsize(path)
            i += 1
        if count is not None and i < count:
            raise FileNotFoundError(
                f"spool {spool_dir!r} holds only {i} '{prefix}' chunks but "
                f"the manifest committed {count}; the checkpoint is "
                f"corrupt (files deleted behind the manifest's back)")
        for name in os.listdir(spool_dir):   # sweep un-committed debris
            if not name.startswith(prefix):
                continue
            path = os.path.join(spool_dir, name)
            if name.endswith(_TMP_SUFFIX) or path not in store._paths:
                try:
                    os.remove(path)
                except OSError:
                    pass
        if len(store) > 0:
            store._check_schema(store.load(0))
        return store

    @property
    def n_entities(self) -> int:
        """Total rows across all stored chunks."""
        return sum(self.load_index(i)["key"].shape[0]
                   for i in range(len(self)))

    def _check_schema(self, ents: dict) -> None:
        schema = tuple(sorted(ents["payload"]))
        if self._schema is None:
            self._schema = schema
        elif schema != self._schema:
            raise ValueError(f"chunk payload schema {schema} does not match "
                             f"the store's {self._schema}")

    def append(self, ents: dict) -> None:
        """Store one host entity chunk (spooling it to disk when the store
        was built with a ``spool_dir``)."""
        self._check_schema(ents)
        if self.spool_dir is None:
            self._mem.append(ents)
            self._paths.append("")
            return
        i = len(self._mem)
        path = os.path.join(self.spool_dir, f"{self.prefix}{i:06d}.npz")
        # tmp-then-rename: a crash mid-append can never leave a torn chunk
        # file behind for a resumed run to trip over
        with OBS.span("spool", op="write"):
            atomic_savez(path, **disk_arrays(ents))
        self.spooled_bytes += os.path.getsize(path)
        self._mem.append(None)
        self._paths.append(path)

    def load(self, i: int) -> dict:
        """Read chunk ``i`` back as a host entity dict."""
        if self._mem[i] is not None:
            return self._mem[i]
        with OBS.span("spool", op="read"), \
                np.load(self._paths[i], allow_pickle=False) as z:
            return host_entities(z)

    def load_index(self, i: int) -> Dict[str, np.ndarray]:
        """Read only chunk ``i``'s ``key``/``eid`` columns (the merge
        index; payload members stay unread on disk)."""
        if self._mem[i] is not None:
            return {"key": self._mem[i]["key"], "eid": self._mem[i]["eid"]}
        with OBS.span("spool", op="index"), \
                np.load(self._paths[i], allow_pickle=False) as z:
            return {"key": z["key"], "eid": z["eid"]}

    def load_field(self, i: int, name: str) -> np.ndarray:
        """Read one payload column of chunk ``i`` (``.npz`` members load
        lazily, so other payload arrays stay on disk — the metrics path
        counts ``src`` tags this way without re-reading the corpus)."""
        if self._mem[i] is not None:
            return self._mem[i]["payload"][name]
        with OBS.span("spool", op="field"), \
                np.load(self._paths[i], allow_pickle=False) as z:
            return host_column(name, z[_PAYLOAD_PREFIX + name])

    def payload_fields(self) -> tuple:
        """Sorted payload field names of the stored schema (empty before
        the first append)."""
        return self._schema or ()

    def dispose(self) -> None:
        """Drop every stored chunk and delete its spooled file (best-effort
        — a file already gone is not an error), so the bytes are reclaimed
        from the spool directory."""
        for path in self._paths:
            if path:
                for p in (path, path + _TMP_SUFFIX):
                    try:
                        os.remove(p)
                    except OSError:
                        pass     # already gone (e.g. a crash raced us)
        self.spooled_bytes = 0
        self._mem = []
        self._paths = []

    def __iter__(self) -> Iterator[dict]:
        """Yield every chunk in append order (each loaded on demand)."""
        for i in range(len(self)):
            yield self.load(i)
