"""Checkpointing of the train state — port of ``repro.train.checkpoint``,
in the reference's file format, so that a checkpoint written by either
package restores in the other.

  * save: copy to the host, write ``<dir>/step_N.npz.tmp``, fsync, rename
    it atomically to ``step_N.npz``, then write ``manifest.json`` the same
    way and delete all but the newest ``keep`` checkpoints: a crash
    mid-write never corrupts the latest checkpoint.
  * the npz's keys are the strings ``jax.tree_util.keystr`` gives each
    leaf's path (``['params']['embed']['table']``), its arrays the leaves;
    a bf16 leaf is stored as numpy stores the reference's (ml_dtypes)
    bfloat16: its raw 2-byte words, dtype ``|V2``.
  * restore: the newest complete step, into the structure, shapes and
    dtypes of a tree of tensors or ``ShapeDtype`` records, on ``device``
    (default: the CUDA card).  A ``|V2`` array is read back as bf16 by a
    bit view; the reference's own restore cannot cast it.  With
    ``shardings`` (``train.steps.resolve_shardings``) each leaf is laid
    out on the mesh as a DTensor (``train.steps.place_tree``; a plain
    tensor on a mesh of size-1 axes): a checkpoint restores onto any
    mesh.
  * a state of DTensors is saved whole, in the same format: every rank
    gathers each leaf (``full_tensor``, a collective) before ``save``
    returns, and rank 0 writes.  The ranks meet on a barrier in ``wait``
    (which ``restore`` and ``latest_step`` call first), after rank 0's
    write: a checkpoint one rank sees is there for all.
  * async: optional background thread, so the train loop overlaps the
    write with the next step (the host copies are taken before ``save``
    returns), a sharded state's too; without it ``save`` returns once
    the checkpoint is written (and, sharded, every rank has waited).
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.modules import tree_items
from repro_torch.sharding import local as SL

_BF16_WORDS = np.dtype("V2")


def _host(x: torch.Tensor) -> np.ndarray:
    if SL.is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_WORDS)
    return x.numpy()


def _flatten(tree) -> dict:
    return {k: _host(x) for k, x in tree_items(tree)}


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if arr.dtype == _BF16_WORDS:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _unflatten_into(tree_like, flat: dict, device, prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}[{k!r}]")
                for k, v in tree_like.items()}
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(tree_like.shape):
        raise ValueError(f"checkpoint leaf {prefix}: shape {arr.shape}, "
                         f"want {tuple(tree_like.shape)}")
    return _tensor(arr, tree_like.dtype, device)


def _steps(directory: Path):
    return sorted(directory.glob("step_*.npz"),
                  key=lambda p: int(p.stem.split("_")[1]))


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._barrier = False    # a sharded save whose barrier is to come

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state, *, extra: Optional[dict] = None):
        flat = _flatten(state)            # host copies (synchronous)
        writes = True
        if any(SL.is_dtensor(x) for _, x in tree_items(state)):
            import torch.distributed as dist
            self._barrier = True
            writes = dist.get_rank() == 0
        if writes and self.async_save:
            if self._thread is not None:
                self._thread.join()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        elif writes:
            self._write(step, flat, extra or {})
        if not self.async_save:
            self.wait()

    def wait(self):
        """The pending write finished; after a sharded save, on every
        rank (a collective then)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = self.dir / f"step_{step}.npz.tmp"
        final = self.dir / f"step_{step}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)            # atomic on POSIX
        manifest = {"latest_step": step, "time": time.time(), **extra}
        mtmp = self.dir / "manifest.json.tmp"
        mtmp.write_text(json.dumps(manifest))
        os.rename(mtmp, self.dir / "manifest.json")
        self._gc()

    def _gc(self):
        for p in _steps(self.dir)[:-self.keep]:
            p.unlink()

    # -- restore -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        self.wait()
        m = self.dir / "manifest.json"
        if not m.exists():
            ckpts = _steps(self.dir)
            return int(ckpts[-1].stem.split("_")[1]) if ckpts else None
        return int(json.loads(m.read_text())["latest_step"])

    def restore(self, step: int, state_like, *, device=None,
                shardings=None):
        """``state_like``: a tree of tensors or ``ShapeDtype`` records
        giving structure, shapes and dtypes.  Returns new tensors on
        ``device`` (default: the CUDA card); with ``shardings`` (a
        matching tree of ``NamedSharding``s) DTensors laid out by them,
        read on every rank."""
        dev = resolve_device(device)
        self.wait()
        with np.load(self.dir / f"step_{step}.npz") as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten_into(state_like, flat, dev)
        if shardings is not None:
            from repro_torch.train.steps import place_tree
            state = place_tree(state, shardings)
        return state

    def restore_latest(self, state_like, *, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, state_like, device=device,
                                  shardings=shardings)
