"""PyTorch wrappers for the port's kernels, each beside its plain version.

A wrapper takes its plain-PyTorch version ONLY for tensors on the CPU; for
CUDA tensors it launches the hand-written kernel (built on first use by
``kernels.build``) or raises — there is no fallback.  Each launch adds one
to the kernel's count in ``LAUNCHES``, so a run can show that it went
through the kernel.

The kernels (the TPU kernel each replaces, all in ``repro/kernels/``):

  fused_band    csrc/fused_band.cu    <- fused_band.py ``_fused_band_kernel``
                (``fused_cheap_band``; on the resolve path)
  banded_sim    csrc/banded_sim.cu    <- banded_sim.py ``_banded_sim_kernel``
                (``banded_dot_band``)
  jaccard_band  csrc/jaccard_band.cu  <- jaccard_band.py ``_jaccard_kernel``
                (``jaccard_band``)
  local_attn    csrc/local_attn.cu    <- local_attn.py ``_local_attn_kernel``
                (``local_attn``; bf16 on the tensor cores with wgmma and
                TMA, f32 scalar)

The last three are reached only through this module, as in the reference.
Their plain versions are in ``kernels.ref``.  ``block_i``, ``block_q`` and
``block_k`` are for parity only: they keep the reference's contracts, so
that a config fails the same way in both packages, and change no result;
the kernels pick their own tiles.  ``band_from_tiles`` is for parity only.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from repro_torch.core.match import cosine_sim, jaccard_sig
from repro_torch.kernels.ref import (banded_sim_ref, jaccard_band_ref,
                                     local_attention_ref)

# launches per kernel since the last reset (the only global state the
# port keeps)
LAUNCHES: Dict[str, int] = {"fused_band": 0, "banded_sim": 0,
                            "jaccard_band": 0, "local_attn": 0}

# a block's dynamic shared memory on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448
# first row tile of each band kernel, halved until it fits _MAX_SMEM; the
# fastest of 512/256/128/64 at the main shape on the H100 (PERF.md): many
# small blocks an SM, so one block's loads overlap another's compute
_ROWS = {"fused_band": 128, "banded_sim": 64, "jaccard_band": 128}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _window_fits(window: int, block_i: int) -> None:
    # the reference's resolve_block_i error, so a config fails the same way
    # in both packages
    if window > block_i:
        raise ValueError(
            f"band window={window} exceeds block_i={block_i}; the band "
            f"kernels need window <= block_i (one tile + successor covers "
            f"the whole band).  Raise block_i (VMEM grows as block_i^2) or "
            f"use the scan band engine")


def fused_cheap_band_ref(feat: torch.Tensor, sig: torch.Tensor, *,
                         window: int, w_cos: float,
                         w_jac: float) -> torch.Tensor:
    """Plain PyTorch version of the fused cheap band: (..., M, F) f32 x
    (..., M, W) int32 -> (..., M, window) f32 with
    ``out[..., i, d] = w_cos*cosine(i, i+1+d) + w_jac*jaccard(i, i+1+d)``,
    zero where i+1+d >= M.  A weight <= 0 disables its half (its input may
    be an (..., M, 1) dummy)."""
    m = feat.shape[-2]
    i = torch.arange(m, device=feat.device)
    cols = []
    for d in range(1, window + 1):
        part = torch.zeros(feat.shape[:-1], dtype=torch.float32,
                           device=feat.device)
        if w_cos > 0.0:
            part = part + w_cos * cosine_sim(
                feat, torch.roll(feat, -d, dims=-2))
        if w_jac > 0.0:
            part = part + w_jac * jaccard_sig(
                sig, torch.roll(sig, -d, dims=-2))
        cols.append(torch.where(i + d < m, part, 0.0))
    return torch.stack(cols, dim=-1)


def _check_band_inputs(feat: torch.Tensor, sig: torch.Tensor) -> None:
    if feat.dtype != torch.float32 or sig.dtype != torch.int32:
        raise TypeError(f"fused_cheap_band takes f32 feat and int32 sig, "
                        f"got {feat.dtype} and {sig.dtype}")
    if feat.dim() != 3 or sig.dim() != 3 or \
            feat.shape[:2] != sig.shape[:2]:
        raise ValueError(f"fused_cheap_band takes (S, M, F) and (S, M, W) "
                         f"with matching S, M; got {tuple(feat.shape)} and "
                         f"{tuple(sig.shape)}")
    if feat.device != sig.device:
        raise ValueError(f"feat on {feat.device}, sig on {sig.device}")
    if not (feat.is_contiguous() and sig.is_contiguous()):
        raise ValueError("fused_cheap_band needs contiguous inputs")


def fused_cheap_band(feat: torch.Tensor, sig: torch.Tensor, *, window: int,
                     w_cos: float, w_jac: float,
                     block_i: int = 256) -> torch.Tensor:
    """Fused cheap-cascade band: (S, M, F) f32 x (S, M, W) int32 ->
    (S, M, window) f32 weighted partial score ``w_cos*cosine +
    w_jac*jaccard`` (unnormalized; the cascade gate compares it against a
    pre-scaled tau), zero where i+1+d >= M.  Unbatched (M, F) x (M, W)
    inputs give (M, window).

    Either half is disabled by a zero weight (pass an (S, M, 1) dummy for
    the unused input).  ``block_i`` is the reference's row block: only
    its ``window <= block_i`` contract is kept, so configs fail alike."""
    _window_fits(window, block_i)
    unbatched = feat.dim() == 2
    if unbatched:
        feat, sig = feat.unsqueeze(0), sig.unsqueeze(0)
    _check_band_inputs(feat, sig)
    if feat.device.type == "cpu":
        out = fused_cheap_band_ref(feat, sig, window=window, w_cos=w_cos,
                                   w_jac=w_jac)
    elif feat.device.type == "cuda":
        use_cos, use_jac = int(w_cos > 0.0), int(w_jac > 0.0)
        out = _launch_band("fused_band", (feat, sig), window,
                           extra=(float(w_cos), float(w_jac), use_cos,
                                  use_jac),
                           smem_extra=(use_cos, use_jac))
    else:
        raise ValueError(f"fused_cheap_band: no kernel for {feat.device}")
    return out[0] if unbatched else out


def resolve_block_i(m: int, window: int, block_i: int) -> int:
    """The reference's row-block choice for a band kernel: ``window <=
    block_i`` or a ``ValueError`` with the reference's text; a block
    clamped to small M grows back to ``window``."""
    _window_fits(window, block_i)
    return max(min(block_i, m), window)


def band_from_tiles(tiles: torch.Tensor, *, window: int,
                    block_i: int) -> torch.Tensor:
    """(M, 2*Bi) tiles -> (M, window) band (the reference's host gather,
    for API parity only: nothing in the port calls it, since the port's
    kernels emit the band directly).

    band[g, d] = tiles[g, (g % Bi) + 1 + d]; entries with global j >= M are
    zeroed."""
    m = tiles.shape[0]
    r = torch.arange(m, device=tiles.device)
    d = torch.arange(window, device=tiles.device)
    cols = (r % block_i)[:, None] + 1 + d[None, :]
    band = torch.take_along_dim(tiles, cols, dim=1)
    return torch.where((r[:, None] + 1 + d[None, :]) < m, band, 0.0)


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with the argtypes of its C interface
    (pointers and the stream as c_void_p, ints as c_int)."""
    from repro_torch.kernels import build
    lib = build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch, smem = {
        "fused_band": ([p] * 3 + [i] * 6 + [f, f, i, i, p], [i] * 6),
        "banded_sim": ([p, p] + [i] * 6 + [p], [i] * 3),
        "jaccard_band": ([p, p] + [i] * 5 + [p], [i] * 3),
        "local_attn": ([p] * 4 + [i] * 4 + [f, f, i, p], None),
    }[name]
    getattr(lib, f"{name}_launch").restype = ctypes.c_int
    getattr(lib, f"{name}_launch").argtypes = launch
    if smem is not None:
        getattr(lib, f"{name}_smem_bytes").restype = ctypes.c_size_t
        getattr(lib, f"{name}_smem_bytes").argtypes = smem
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    return lib


def _launched(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: " + getattr(
            lib, f"{name}_error_string")(err).decode())
    LAUNCHES[name] += 1


def _band_rows(name: str, window: int, widths,
               smem_extra: tuple = ()) -> int:
    """The row tile of one launch of the band kernel ``name``:
    ``_ROWS[name]`` halved until the block fits shared memory."""
    smem = getattr(_lib(name), f"{name}_smem_bytes")
    rows = _ROWS[name]
    while rows > 1 and smem(rows, window, *widths,
                            *smem_extra) > _MAX_SMEM:
        rows //= 2
    if smem(rows, window, *widths, *smem_extra) > _MAX_SMEM:
        raise ValueError(f"{name}: rows of widths {list(widths)} with "
                         f"window={window} do not fit shared memory")
    return rows


def _launch_band(name: str, inputs: tuple, window: int, *,
                 extra: tuple = (), smem_extra: tuple = ()) -> torch.Tensor:
    """One launch of the band kernel ``name`` on (S, M, C) inputs (one for
    banded_sim and jaccard_band, feat and sig for fused_band), at the row
    tile ``_band_rows`` gives.  The C interface is ``launch(*inputs, out,
    S, M, *widths, window, rows, *extra, stream)`` and ``smem_bytes(rows,
    window, *widths, *smem_extra)``."""
    lib = _lib(name)
    s, m = inputs[0].shape[:2]
    widths = [x.shape[2] for x in inputs]
    if m >= 2**31 or s >= 2**16:
        raise ValueError(f"{name}: S={s}, M={m} exceed the kernel's grid")
    rows = _band_rows(name, window, widths, smem_extra)
    out = torch.empty((s, m, window), dtype=torch.float32,
                      device=inputs[0].device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = getattr(lib, f"{name}_launch")(
            *(x.data_ptr() for x in inputs), out.data_ptr(), s, m, *widths,
            window, rows, *extra, stream)
    _launched(name, lib, err)
    return out


def _band_op(name: str, x: torch.Tensor, window: int, block_i: int,
             dtypes: tuple, plain) -> torch.Tensor:
    """(M, C) or (S, M, C) -> (..., M, window) f32 through the plain
    version on the CPU or the kernel ``name`` on the card."""
    if x.dim() not in (2, 3):
        raise ValueError(f"{name} takes (M, C) or (S, M, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} takes {dtypes}, got {x.dtype}")
    if window < 1:
        raise ValueError(f"{name}: window={window} < 1")
    resolve_block_i(x.shape[-2], window, block_i)
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")
    unbatched = x.dim() == 2
    if unbatched:
        x = x.unsqueeze(0)
    if x.device.type == "cpu":
        out = plain(x, window=window)
    elif x.device.type == "cuda":
        extra = (int(x.dtype == torch.bfloat16),) \
            if name == "banded_sim" else ()
        out = _launch_band(name, (x,), window, extra=extra)
    else:
        raise ValueError(f"{name}: no kernel for {x.device}")
    return out[0] if unbatched else out


def banded_dot_band(feat: torch.Tensor, *, window: int,
                    block_i: int = 256) -> torch.Tensor:
    """Banded <feat_i, feat_j> similarity: (M, F) or (S, M, F) f32 or bf16
    -> (..., M, window) f32 with ``out[..., i, d] = <feat_i, feat_{i+1+d}>``
    (raw dot, no clip), zero where i+1+d >= M.  ``block_i`` is for parity
    only (``window <= block_i``)."""
    return _band_op("banded_sim", feat, window, block_i,
                    (torch.float32, torch.bfloat16), banded_sim_ref)


def jaccard_band(sig: torch.Tensor, *, window: int,
                 block_i: int = 256) -> torch.Tensor:
    """Banded Jaccard over bit signatures: (M, W) or (S, M, W) int32 bit
    views -> (..., M, window) f32 ``popc(a & b) / max(popc(a | b), 1)``,
    zero where i+1+d >= M.  Empty vs empty is 0.0, unlike
    ``fused_cheap_band`` (1.0), as in the reference.  ``block_i`` is for
    parity only (``window <= block_i``)."""
    return _band_op("jaccard_band", sig, window, block_i, (torch.int32,),
                    jaccard_band_ref)


# the head dims K4 is built for
ATTN_HEAD_DIMS = (64, 128, 256)


@torch.library.custom_op("repro_torch::local_attn", mutates_args=())
def _local_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int, softcap: float) -> torch.Tensor:
    """K4 as one registered op: its launch on real CUDA tensors, and under
    ``FakeTensorMode`` the shape rule below, so that a dry run
    (``launch.dryrun``) traces the card's route through it as one op."""
    return _launch_local_attn(q, k, v, window, softcap)


@_local_attn_op.register_fake
def _(q, k, v, window, softcap):
    return torch.empty_like(q)


def _launch_local_attn(q, k, v, window, softcap) -> torch.Tensor:
    bh, s, d = q.shape
    if d not in ATTN_HEAD_DIMS:
        raise ValueError(f"local_attn: the kernel takes head dims "
                         f"{ATTN_HEAD_DIMS}, got D={d}")
    if bh >= 2**16:
        raise ValueError(f"local_attn: BH={bh} exceeds the kernel's grid")
    lib = _lib("local_attn")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.local_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            d, window, 1.0 / math.sqrt(d), float(softcap),
            int(q.dtype == torch.bfloat16), stream)
    _launched("local_attn", lib, err)
    return out


def local_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int, block_q: int = 256, block_k: int = 256,
               softcap: float = 0.0) -> torch.Tensor:
    """Sliding-window flash attention: (BH, S, D) x3, all f32 or all bf16
    -> (BH, S, D) in q's dtype.  Key kp is kept for query qp iff
    qp - window < kp <= qp; scale 1/sqrt(D); optional
    ``softcap * tanh(s / softcap)``.

    ``window >= 1`` (at 0 every key is masked and the reference's kernel
    and plain version disagree).  No operand may require grad: the kernel
    has no backward.  No operand may be a DTensor.  ``block_q``/``block_k`` are for parity
    only and keep the reference's contract: S must be a multiple of
    ``min(block_q, block_k, S)``."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("local_attn takes plain tensors: a DTensor's local "
                        "heads reach it through models.attention")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"local_attn takes three (BH, S, D) of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"local_attn takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 1:
        raise ValueError(f"local_attn: window={window} < 1 masks every key")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("local_attn has no backward (nor has the "
                         "reference's kernel): it takes no operand that "
                         "requires grad")
    s = q.shape[1]
    blk = min(block_q, block_k, s)
    if blk < 1 or s % blk:
        raise ValueError(f"local_attn: S={s} is not a multiple of the "
                         f"block min(block_q, block_k, S)={blk}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("local_attn needs contiguous inputs")
    if q.device.type == "cpu":
        return local_attention_ref(q, k, v, window=window, softcap=softcap)
    if q.device.type == "cuda":
        return _local_attn_op(q, k, v, int(window), float(softcap))
    raise ValueError(f"local_attn: no kernel for {q.device}")
