"""Fault-tolerant training loop — port of ``repro.train.loop``.

  * checkpoint every ``ckpt_every`` steps and at the end (atomic,
    async-capable) + resume from the latest checkpoint at start
  * deterministic data order (batch = f(seed, step)), so recovery replays
    the exact token stream
  * step-level fault barrier: a failing step (``RuntimeError``, or a
    non-finite loss with ``halt_on_nan``) restores the latest checkpoint
    instead of crashing the job; repeated failures at one step abort
    (poison-pill guard)
  * straggler hook: per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x the EWMA are counted

The port's train step updates the state in place
(``train.steps.make_train_step``).  A restore builds new tensors from the
checkpoint, on the device of the state's leaves, so it does not matter
what a failed step left in the old ones.  Before the first checkpoint a
failed step is retried on the state as it stands, as the reference's
loop does: a step that raised before its update left it as it was; one
whose loss came back non-finite has updated it already, but so would its
retry (the same batch), and the poison-pill guard aborts either way.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.models.modules import tree_items
from repro_torch.train.checkpoint import Checkpointer


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    halt_on_nan: bool = True
    max_retries_per_step: int = 2
    straggler_factor: float = 3.0


@dataclass
class LoopStats:
    steps: int = 0
    restores: int = 0
    stragglers: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


def train_loop(train_step: Callable, state, batcher, ckpt: Checkpointer,
               cfg: LoopConfig, *, shardings=None,
               inject_fault_at: Optional[int] = None) -> tuple[Any, LoopStats]:
    """Runs to ``cfg.total_steps`` with checkpoint/restart fault tolerance.

    ``inject_fault_at``: test hook — raises a simulated device failure once
    at that step to exercise the restore path.  ``shardings``: the state's
    layout (``train.steps.resolve_shardings``), which every restore puts
    it back into."""
    device = tree_items(state)[0][1].device
    stats = LoopStats()
    step = 0
    if ckpt.latest_step() is not None:
        step, state = ckpt.restore_latest(state, device=device,
                                          shardings=shardings)
    injected = False
    ewma = None
    retries = 0

    while step < cfg.total_steps:
        batch = batcher.batch(step)
        t0 = time.time()
        try:
            if inject_fault_at is not None and step == inject_fault_at \
                    and not injected:
                injected = True
                raise RuntimeError("injected device failure")
            new_state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            if cfg.halt_on_nan and not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        except (RuntimeError, FloatingPointError) as e:
            stats.restores += 1
            retries += 1
            if retries > cfg.max_retries_per_step:
                raise RuntimeError(
                    f"step {step} failed {retries}x; aborting") from e
            last = ckpt.latest_step()
            if last is not None:
                step, state = last, ckpt.restore(last, state, device=device,
                                                 shardings=shardings)
            continue
        retries = 0
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > cfg.straggler_factor * ewma and stats.steps > 3:
            stats.stragglers += 1
        state = new_state
        step += 1
        stats.steps += 1
        stats.losses.append(loss)
        stats.step_times.append(dt)
        if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
            ckpt.save(step, state)
        if step % cfg.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
    ckpt.wait()
    return state, stats
