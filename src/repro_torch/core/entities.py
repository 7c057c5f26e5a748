"""Entity representation for the ER pipeline (port of ``repro.core.entities``).

Entities are fixed-width records:

  key:   (..., N)  int32   blocking key (packed, non-negative, < 2^30)
  eid:   (..., N)  int32   stable global entity id
  valid: (..., N)  bool    slot occupancy (fixed-capacity shards carry padding)
  payload: dict of per-entity tensors, e.g.
     "sig":  (..., N, SIG_WORDS) int32    bit-packed trigram signature, as
                                          int32 BIT VIEWS of the reference's
                                          uint32 words (torch's uint32 has
                                          too few ops for the matchers)
     "feat": (..., N, F)         float32  dense feature embedding
     "text": (..., N, L)         uint8    padded byte string

The leading ``...`` is empty for one entity set and ``(r,)`` for the shard
program's stacked shards: every op here works along the ROW dim
(``key.dim() - 1``), so the same code serves both — the explicit shard dim
replaces the reference's vmap.

All shard-level ops keep VALID ENTITIES CONTIGUOUS from slot 0 in
blocking-key order — the sliding-window distance is then slot distance.
"""
from __future__ import annotations

import numpy as np
import torch

INVALID_KEY = 2**31 - 1   # sorts after every real key

# payload fields that the reference holds as uint32 and the port as int32
# bit views (``from_numpy`` / ``to_numpy`` convert them)
UINT32_FIELDS = ("sig",)


def _row_dim(ents) -> int:
    return ents["key"].dim() - 1


def map_fields(ents, fn) -> dict:
    """``fn`` applied to every tensor of an entity dict."""
    return {
        "key": fn(ents["key"]),
        "eid": fn(ents["eid"]),
        "valid": fn(ents["valid"]),
        "payload": {k: fn(v) for k, v in ents["payload"].items()},
    }


def _from_host(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = np.ascontiguousarray(a)
    # torch cannot wrap read-only memory (e.g. arrays exported by another
    # framework): copy those
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = _from_host(a)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _payload_tensor(a, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return _from_host(a).to(device)
    return torch.as_tensor(a, device=device)


def make_entities(key, eid, payload=None, valid=None, *,
                  device=None) -> dict:
    """Entity dict from numpy arrays or tensors.  uint32 numpy payload
    arrays become int32 bit views."""
    key = _tensor(key, torch.int32, device)
    dev = key.device
    return {
        "key": key,
        "eid": _tensor(eid, torch.int32, dev),
        "valid": torch.ones(key.shape, dtype=torch.bool, device=dev)
        if valid is None else _tensor(valid, torch.bool, dev),
        "payload": {k: _payload_tensor(v, dev)
                    for k, v in (payload or {}).items()},
    }


def from_numpy(ents: dict, device) -> dict:
    """The reference's entity dict (numpy-convertible arrays) -> the port's
    (tensors on ``device``): uint32 signatures become int32 bit views, every
    other dtype is kept (``key``/``eid`` int32, ``valid`` bool, ``feat``
    f32, ``text`` uint8)."""
    return make_entities(np.asarray(ents["key"]), np.asarray(ents["eid"]),
                         payload={k: np.asarray(v)
                                  for k, v in ents["payload"].items()},
                         valid=np.asarray(ents["valid"]), device=device)


def to_numpy(ents: dict) -> dict:
    """The port's entity dict -> host numpy in the reference's dtypes (the
    ``UINT32_FIELDS`` int32 bit views go back to uint32)."""
    def host(k, v):
        a = v.detach().cpu().numpy()
        return a.view(np.uint32) if k in UINT32_FIELDS else a
    return {
        "key": ents["key"].cpu().numpy(),
        "eid": ents["eid"].cpu().numpy(),
        "valid": ents["valid"].cpu().numpy(),
        "payload": {k: host(k, v) for k, v in ents["payload"].items()},
    }


def to_device(ents: dict, device) -> dict:
    """Every tensor of ``ents`` moved to ``device``."""
    return map_fields(ents, lambda a: a.to(device))


def n_valid(ents) -> torch.Tensor:
    """Valid slots per entity set: shape ``key.shape[:-1]``, int32."""
    return ents["valid"].sum(dim=-1, dtype=torch.int32)


def sort_key(ents) -> torch.Tensor:
    """int32 sort key: invalid slots pushed to the end."""
    return torch.where(ents["valid"], ents["key"],
                       torch.full_like(ents["key"], INVALID_KEY))


def take_rows(a: torch.Tensor, idx: torch.Tensor, row_dim: int):
    """``a`` gathered along ``row_dim`` at ``idx`` (shape: the leading dims
    of ``a`` up to and including the row dim); trailing dims ride along."""
    extra = a.dim() - idx.dim()
    return torch.take_along_dim(
        a, idx.reshape(idx.shape + (1,) * extra), dim=row_dim)


def put_rows(buf: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             row_dim: int) -> torch.Tensor:
    """In-place scatter of ``val`` rows into ``buf`` at ``idx`` along
    ``row_dim`` (indices must be unique, except a dump slot the caller
    slices off)."""
    shape = idx.shape + buf.shape[idx.dim():]
    full = idx.reshape(idx.shape + (1,) * (buf.dim() - idx.dim())) \
        .expand(shape)
    return buf.scatter_(row_dim, full, val)


def permute(ents, order) -> dict:
    """Rows of every field reordered by ``order`` (per entity set)."""
    rd = _row_dim(ents)
    return map_fields(ents, lambda a: take_rows(a, order, rd))


def sort_entities(ents) -> dict:
    """Deterministic sort by (key, eid), invalid slots last.

    One stable sort on the int64 composite ``(sort_key << 32) | eid`` —
    the same order as the reference's ``lexsort((eid, sort_key))``: keys
    are < 2^30 (or INVALID_KEY = 2^31-1) and eids non-negative int32, so
    the composite orders exactly like the (key, eid) pair, and stability
    breaks exact ties by slot like lexsort does."""
    comp = (sort_key(ents).to(torch.int64) << 32) | \
        ents["eid"].to(torch.int64)
    order = torch.sort(comp, dim=-1, stable=True).indices
    return permute(ents, order)


def concat(a, b) -> dict:
    """Rows of ``b`` appended after the rows of ``a``."""
    rd = _row_dim(a)
    cat = lambda x, y: torch.cat([x, y], dim=rd)
    return {
        "key": cat(a["key"], b["key"]),
        "eid": cat(a["eid"], b["eid"]),
        "valid": cat(a["valid"], b["valid"]),
        "payload": {k: cat(a["payload"][k], b["payload"][k])
                    for k in a["payload"]},
    }


def empty_like(ents, n: int) -> dict:
    """``n`` invalid slots with ``ents``' leading dims and payload schema."""
    rd = _row_dim(ents)
    lead = tuple(ents["key"].shape[:rd])
    dev = ents["key"].device
    z = lambda a: torch.zeros(lead + (n,) + tuple(a.shape[rd + 1:]),
                              dtype=a.dtype, device=dev)
    return {
        "key": torch.full(lead + (n,), INVALID_KEY, dtype=torch.int32,
                          device=dev),
        "eid": z(ents["eid"]),
        "valid": torch.zeros(lead + (n,), dtype=torch.bool, device=dev),
        "payload": {k: z(v) for k, v in ents["payload"].items()},
    }


def slice_entities(ents, start, size: int) -> dict:
    """``size`` rows from ``start`` (an int, or one start per entity set).
    Starts are clamped to ``[0, M - size]`` exactly like
    ``jax.lax.dynamic_slice`` clamps them — ``repsn.tail_window`` relies
    on it."""
    rd = _row_dim(ents)
    m = ents["key"].shape[rd]
    if size > m:
        raise ValueError(f"slice of {size} rows from {m}")
    lead = tuple(ents["key"].shape[:rd])
    dev = ents["key"].device
    # an int start is a fill, not a host-to-device copy (which would
    # synchronize, and a CUDA graph cannot capture that)
    start = (torch.full(lead, start, dtype=torch.int64, device=dev)
             if isinstance(start, int) else
             torch.as_tensor(start, dtype=torch.int64, device=dev)
             .expand(lead)).clamp(0, m - size)
    idx = start.unsqueeze(-1) + torch.arange(size, device=dev)
    return map_fields(ents, lambda a: take_rows(a, idx, rd))


def roll(ents, shift) -> dict:
    """Rows rolled by ``shift`` (an int, or one shift per entity set):
    row i moves to row i + shift, like ``jnp.roll``."""
    rd = _row_dim(ents)
    if isinstance(shift, int):
        return map_fields(ents, lambda a: torch.roll(a, shift, dims=rd))
    m = ents["key"].shape[rd]
    dev = ents["key"].device
    shift = torch.as_tensor(shift, dtype=torch.int64, device=dev)
    idx = torch.remainder(torch.arange(m, device=dev) - shift.unsqueeze(-1),
                          m)
    return map_fields(ents, lambda a: take_rows(a, idx, rd))


# -- host-side chunk helpers (numpy mirrors of the ops above) --------------------

def to_host(ents) -> dict:
    """Entity dict with every array as host numpy (same schema; int32
    signature views stay int32)."""
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)
    return {
        "key": host(ents["key"]),
        "eid": host(ents["eid"]),
        "valid": host(ents["valid"]),
        "payload": {k: host(v) for k, v in ents["payload"].items()},
    }


def host_take(ents: dict, idx) -> dict:
    """Row subset of a host entity dict (slice, bool mask or index array)."""
    return {
        "key": ents["key"][idx],
        "eid": ents["eid"][idx],
        "valid": ents["valid"][idx],
        "payload": {k: v[idx] for k, v in ents["payload"].items()},
    }


def host_concat(chunks) -> dict:
    """Concatenate host entity dicts row-wise (one payload schema; an empty
    list is rejected — there is no schema to produce)."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("host_concat needs at least one chunk")
    if len(chunks) == 1:
        return chunks[0]
    cat = lambda f: np.concatenate([c[f] for c in chunks], axis=0)
    return {
        "key": cat("key"), "eid": cat("eid"), "valid": cat("valid"),
        "payload": {k: np.concatenate([c["payload"][k] for c in chunks],
                                      axis=0)
                    for k in chunks[0]["payload"]},
    }


def host_pad(ents: dict, cap: int) -> dict:
    """A host entity dict padded to exactly ``cap`` rows with invalid slots
    whose keys sort past every real key (the fixed shape of a streamed
    chunk's or a serve delta's shard program); ``cap == n`` returns
    ``ents`` itself."""
    pad = cap - int(ents["key"].shape[0])
    if pad == 0:
        return ents
    z = lambda a: np.zeros((pad,) + a.shape[1:], a.dtype)
    return host_concat([ents, {
        "key": np.full((pad,), INVALID_KEY, np.int32),
        "eid": z(ents["eid"]),
        "valid": np.zeros((pad,), bool),
        "payload": {k: z(v) for k, v in ents["payload"].items()},
    }])


def sort_chunk(ents, key=None) -> dict:
    """Sort one chunk by (key, eid) and return it as a host dict with
    invalid slots dropped.  ``key`` optionally overrides ``ents["key"]``."""
    e = ents if key is None else {
        "key": torch.as_tensor(key, dtype=torch.int32,
                               device=ents["eid"].device),
        "eid": ents["eid"], "valid": ents["valid"],
        "payload": ents["payload"]}
    h = to_host(sort_entities(e))
    return host_take(h, slice(0, int(h["valid"].sum())))


def composite_order_key(ents: dict) -> np.ndarray:
    """(N,) int64 merge key ``(key << 32) | eid`` — orders exactly like the
    (key, eid) lexsort (keys < 2^30, eids non-negative int32)."""
    key = np.asarray(ents["key"], np.int64)
    eid = np.asarray(ents["eid"], np.int64)
    return (key << 32) | eid


# -- synthetic data (benchmarks / tests) ------------------------------------------

def synth_arrays(rng: np.random.Generator, n: int, *, n_keys: int = 1000,
                 sig_words: int = 8, feat_dim: int = 32,
                 dup_frac: float = 0.2, skew: float = 0.0,
                 text_len: int = 0) -> dict:
    """The reference's ``synth_entities`` corpus as host numpy arrays in
    the reference's dtypes (uint32 signatures): the same rng draws in the
    same order, so one seed gives bit-identical arrays in both packages.

    Paper §5.1 analogue (1.4M records, key = first letters of title);
    ``skew`` concentrates that fraction of entities on the largest key;
    duplicates get near-identical payloads; ``text_len > 0`` adds a padded
    lowercase "text" field whose duplicates carry a one-character typo."""
    keys = rng.integers(0, n_keys, size=n).astype(np.int32)
    if skew > 0:
        hot = rng.random(n) < skew
        keys[hot] = n_keys - 1
    feat = rng.normal(size=(n, feat_dim)).astype(np.float32)
    sig = rng.integers(0, 2**32, size=(n, sig_words), dtype=np.uint64) \
        .astype(np.uint32)
    text = rng.integers(ord("a"), ord("z") + 1, size=(n, text_len)) \
        .astype(np.uint8) if text_len else None
    n_dup = int(n * dup_frac)
    if n_dup:
        src = rng.integers(0, n, size=n_dup)
        dst = rng.integers(0, n, size=n_dup)
        keys[dst] = keys[src]
        feat[dst] = feat[src] + 0.01 * rng.normal(size=(n_dup, feat_dim)) \
            .astype(np.float32)
        sig[dst] = sig[src]
        if text is not None:
            text[dst] = text[src]
            typo_pos = rng.integers(0, text_len, size=n_dup)
            text[dst, typo_pos] = rng.integers(
                ord("a"), ord("z") + 1, size=n_dup).astype(np.uint8)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True) + 1e-9
    payload = {"feat": feat, "sig": sig}
    if text is not None:
        payload["text"] = text
    return {"key": keys, "eid": np.arange(n, dtype=np.int32),
            "valid": np.ones(n, bool), "payload": payload}


def synth_entities(rng: np.random.Generator, n: int, *, device="cpu",
                   **kw) -> dict:
    """``synth_arrays`` as a port entity dict on ``device`` (data is made
    on the host with numpy, then moved)."""
    return from_numpy(synth_arrays(rng, n, **kw), device)
