"""AdamW with global-norm clipping, decoupled weight decay and the
warmup + cosine schedule — port of ``repro.train.optim``.

The reference's maths: moments in f32 whatever the param dtype, the
global gradient norm clipped to ``clip_norm``, bias correction from the
step, and weight decay only on leaves with ``ndim >= 2``.  The layer
groups are stacked on a leading axis as the reference's are, so a stacked
norm scale is 2-D and takes weight decay there too; so it does here.

``adamw_update`` updates the params and both moments in place, leaf by
leaf and in slices of ``UPDATE_SLICE`` elements, so that its temporaries
stay small: a second tree of moments does not fit beside the first at
the largest configuration one card trains.  Each slice goes through the
reference's expression op by op, so the numbers are those of a whole-leaf
update.  ``torch.optim.AdamW`` has another schedule, clipping and decay
rule, and is not used.

On DTensor leaves (a state laid out by ``train.steps.train_state_specs``)
the moments share the params' placements (ZeRO comes with FSDP), and a
leaf's gradient is brought to them first.  The update is elementwise, so
each rank updates its own shards; the global norm sums every leaf's
squares over its shards before the square root.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.modules import tree_items, tree_map
from repro_torch.sharding import local as SL

# elements of one leaf updated at a time (64 MB of f32 temporaries each)
UPDATE_SLICE = 1 << 24


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"      # "cosine" | "constant"


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as an
    f32 0-d tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "constant":
        return oc.lr * warm
    prog = torch.clamp((step - oc.warmup_steps) /
                       max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def adamw_init(params):
    """f32 zero moments shaped as ``params`` and an int32 step, on the
    params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_items(params)[0][1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_specs(param_specs):
    """Moments share the params' logical sharding; step replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def _slices(x: torch.Tensor):
    return x.view(-1).split(UPDATE_SLICE)


def _sum_squares(x) -> torch.Tensor:
    """The sum of a leaf's squares in f32, a slice at a time; a DTensor's
    over all its shards (each replica counted once)."""
    if SL.is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate, Shard
        part = _sum_squares(x.to_local())
        pl = [Partial() if isinstance(p, Shard) else Replicate()
              for p in x.placements]
        return SL.from_local(part, x.device_mesh, pl, ()).full_tensor()
    return sum(torch.sum(torch.square(s.float()))
               for s in _slices(x.contiguous()))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (leaves in the
    reference's order; each summed a slice at a time)."""
    return torch.sqrt(sum(_sum_squares(x) for _, x in tree_items(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, oc: OptConfig):
    """Returns (params, opt_state, metrics): ``params`` and ``opt_state``
    are the trees given, updated in place (the step count too)."""
    step = opt_state["step"]
    step.add_(1)
    if SL.is_dtensor(step):
        step = step.to_local()
    p_items = tree_items(params)
    g_items = dict(tree_items(grads))
    for key, p in p_items:
        g = g_items[key]
        if SL.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            # a partial sum over data shards becomes the params' layout
            g_items[key] = g.redistribute(p.device_mesh, p.placements)
    gnorm = torch.sqrt(sum(_sum_squares(g_items[k]) for k, _ in p_items))
    if oc.clip_norm > 0:
        scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(oc, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(oc.b1, stepf)
    b2c = 1 - torch.pow(oc.b2, stepf)

    m_items = dict(tree_items(opt_state["m"]))
    v_items = dict(tree_items(opt_state["v"]))
    for key, p in p_items:
        decay = p.dim() >= 2               # the global shape's
        g, m, v = g_items[key], m_items[key], v_items[key]
        if SL.is_dtensor(p):
            g = SL.to_local(g, p.placements)
            p, m, v = p.to_local(), m.to_local(), v.to_local()
        g = g.contiguous()
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            g32 = gs.float() * scale
            ms.mul_(oc.b1).add_((1 - oc.b1) * g32)
            vs.mul_(oc.b2).add_(((1 - oc.b2) * g32).mul_(g32))
            delta = (ms / b1c) / (torch.sqrt(vs / b2c) + oc.eps)
            if decay:
                delta = delta + oc.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
