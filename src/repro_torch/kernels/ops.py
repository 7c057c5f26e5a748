"""PyTorch wrappers for the port's kernels, each beside its plain version.

A wrapper takes its plain-PyTorch version ONLY for tensors on the CPU; for
CUDA tensors it launches the hand-written kernel (built on first use by
``kernels.build``) or raises — there is no fallback.  Each launch adds one
to the kernel's count in ``LAUNCHES``, so a run can show that it went
through the kernel.

Kernels ported so far (the TPU kernel each replaces):

  fused_band   kernels/csrc/fused_band.cu  <-  repro/kernels/fused_band.py
               ``_fused_band_kernel`` (via ``ops.fused_cheap_band``)
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.core.match import cosine_sim, jaccard_sig

# launches per kernel since the last reset (the only global state the
# port keeps)
LAUNCHES: Dict[str, int] = {"fused_band": 0}

# a block's dynamic shared memory on Hopper (227 KB of the SM's 256 KB)
_MAX_SMEM = 232_448
_ROWS = 256


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


@functools.cache
def _fused_band_lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("fused_band")
    lib.fused_band_launch.restype = ctypes.c_int
    lib.fused_band_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 +
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.fused_band_smem_bytes.restype = ctypes.c_size_t
    lib.fused_band_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.fused_band_error_string.restype = ctypes.c_char_p
    lib.fused_band_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch_fused_band(feat, sig, window, w_cos, w_jac) -> torch.Tensor:
    lib = _fused_band_lib()
    s, m, f = feat.shape
    words = sig.shape[2]
    if m >= 2**31 or s >= 2**16:
        raise ValueError(f"fused_cheap_band: S={s}, M={m} exceed the "
                         f"kernel's grid")
    use_cos, use_jac = int(w_cos > 0.0), int(w_jac > 0.0)
    rows = _ROWS
    while rows > 1 and lib.fused_band_smem_bytes(
            rows, window, f, words, use_cos, use_jac) > _MAX_SMEM:
        rows //= 2
    if lib.fused_band_smem_bytes(rows, window, f, words, use_cos,
                                 use_jac) > _MAX_SMEM:
        raise ValueError(f"fused_cheap_band: rows of F={f} and W={words} "
                         f"with window={window} do not fit shared memory")
    out = torch.empty((s, m, window), dtype=torch.float32,
                      device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    with torch.cuda.device(feat.device):
        err = lib.fused_band_launch(
            feat.data_ptr(), sig.data_ptr(), out.data_ptr(), s, m, f, words,
            window, rows, float(w_cos), float(w_jac), use_cos, use_jac,
            stream)
    if err != 0:
        raise RuntimeError("fused_band kernel launch failed: "
                           + lib.fused_band_error_string(err).decode())
    LAUNCHES["fused_band"] += 1
    return out


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
        out = _launch_fused_band(feat, sig, window, w_cos, w_jac)
    else:
        raise ValueError(f"fused_cheap_band: no kernel for {feat.device}")
    return out[0] if unbatched else out
