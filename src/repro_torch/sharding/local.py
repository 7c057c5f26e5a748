"""Per-shard bodies under the sharding rules: the port's counterpart of the
reference's ``shard_map`` and of the layouts it pins for per-head or
per-row work.

A body here runs on each rank's local tensors (``to_local``) and its
results go back onto the mesh as DTensors (``from_local``).  Two kinds:

  * a body whose ranks exchange nothing that autograd must see (attention
    on each rank's own heads and rows, a recurrent mixer on each rank's
    own rows with whole weights): the local gradients are the slices of
    the global one, or partial sums where a weight was gathered whole
    (``to_local(..., grad_placements=Partial)``), and DTensor reduces them;
  * the MoE's body (``models.moe``), with explicit collectives.  It keeps
    the reference's ``shard_map`` semantics for gradients too: an output
    replicated over mesh axes its spec does not name gets its cotangent
    divided by their size (``scale_grad``); ``all_reduce`` (psum) and
    ``all_gather`` differentiate to their transposes (psum, and a reduce-
    scatter); an input's cotangent is summed over the axes its spec does
    not name (``psum_grad``).  So the gradient is the global function's.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_device(x, device):
    """``x`` (an array or a tensor) as a tensor on ``device``; a DTensor
    (a step's input given as each rank's shard) as it is."""
    return x if is_dtensor(x) else torch.as_tensor(x, device=device)


def on_mesh(x, rules, where: str) -> bool:
    """Whether ``x`` takes a body's per-shard form under ``rules``: a
    DTensor does.  A plain tensor takes the one-device form, without rules
    or where every axis of the rules' mesh has size 1 (its tensors stay
    plain there: ``Rules.dtensors``); on a wider mesh it is a fault and
    raises."""
    if rules is None:
        return False
    if is_dtensor(x):
        return True
    if rules.dtensors:
        raise ValueError(f"{where} with rules on a mesh axis above 1 takes "
                         f"DTensors laid out on the rules' mesh "
                         f"(train.steps.place_tree), not a plain tensor")
    return False


def to_local(x, placements=None, grad_placements=None) -> torch.Tensor:
    """This rank's local tensor of DTensor ``x``, redistributed first to
    ``placements`` where given; ``grad_placements``: the layout its
    gradient will have (default: ``placements``)."""
    if placements is not None and tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, tuple(placements))
    return x.to_local(grad_placements=grad_placements)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, device_mesh, placements, shape):
    """A DTensor of global ``shape`` whose local tensor on this rank is
    ``local`` (shards may be uneven: the shape is given, not inferred)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local.contiguous(), device_mesh,
                              tuple(placements),
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def local_shape_and_offset(shape, device_mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` laid out by ``placements`` on ``device_mesh``: each
    ``Shard`` splits its dim in ``torch.chunk``'s pieces (ceil(n / m)
    each, the last ones shorter or empty), the mesh dims in order, as
    DTensor lays it out.  Plain Python on the rank's mesh coordinate, so
    it reads no tensor (a trace under ``FakeTensorMode`` runs it too)."""
    from torch.distributed.tensor import Shard
    coord = device_mesh.get_coordinate()
    shape, offset = list(shape), [0] * len(shape)
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, c = shape[pl.dim], -(-shape[pl.dim] // device_mesh.size(md))
            lo = min(coord[md] * c, n)
            offset[pl.dim] += lo
            shape[pl.dim] = min(lo + c, n) - lo
    return tuple(shape), tuple(offset)


def matmul(x, w):
    """``x @ w`` of DTensors x (..., K) and w (K, N) on each rank's own
    shards, as XLA's SPMD partitioner lays the product out for the
    reference, per mesh dim:

      x rows split, w whole   -> out rows split   (w's gradient partial)
      x whole, w's N split    -> out N split      (x's gradient partial)
      both split on K         -> out a partial sum
      both whole              -> out whole

    First w is gathered over the mesh dims that split x's rows (its FSDP
    shards), and a K split on one side alone is matched on the other by
    a local slice (x) or a gather (w).  Left to DTensor, the product (its
    backward above all) may gather a weight whole and compute every
    column or row on every rank.  A partial operand is left to DTensor's
    own ``x @ w``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    px, pw = list(x.placements), list(w.placements)
    if any(isinstance(p, Partial) for p in px + pw):
        return x @ w
    mesh = x.device_mesh
    last = x.ndim - 1
    for i, (a, b) in enumerate(zip(px, pw)):
        if isinstance(a, Shard) and a.dim < last:
            pw[i] = Replicate()
        elif a == Replicate() and b == Shard(0):
            px[i] = Shard(last)
        elif a == Shard(last):
            pw[i] = Shard(0)
    # per mesh dim: (the output's placement, x's gradient's, w's)
    lay = []
    for a, b in zip(px, pw):
        if isinstance(a, Shard) and a.dim < last:      # rows
            lay.append((a, a, Partial()))
        elif b == Shard(1):                             # columns
            lay.append((Shard(last), Partial(), b))
        elif b == Shard(0):                             # contraction
            lay.append((Partial(), a, b))
        else:
            lay.append((Replicate(), a, b))
    out, gx, gw = (list(col) for col in zip(*lay))
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    y = to_local(x, px, gx) @ to_local(w, pw, gw)
    return from_local(y, mesh, out, shape)


def embedding(table, tokens):
    """``table[tokens]`` of DTensors table (V, D) and integer tokens, on
    each rank's own shards: a rank looks its tokens up in its rows of the
    table, zeros for an id another rank's vocab shard holds, and the rows
    are summed over the mesh dims that split the vocab (one rank holds
    each id: the sum is exact); the tokens' own split stays.  A table split
    over a mesh dim that also splits the tokens is gathered there first.
    (DTensor's own ``aten.index`` refuses tokens split over two mesh dims,
    the multi-pod mesh's ("pod", "data") batch.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    tp, kp = list(table.placements), list(tokens.placements)
    if any(isinstance(p, Partial) for p in tp + kp):
        return table[tokens]
    mesh = table.device_mesh
    out, grad = [], []
    for i, (w, t) in enumerate(zip(tp, kp)):
        if isinstance(w, Shard) and (w.dim != 0 or isinstance(t, Shard)):
            tp[i] = w = Replicate()
        if isinstance(t, Shard):                    # the tokens' rows
            out.append(t)
            grad.append(Partial())
        elif isinstance(w, Shard):                  # the vocab
            out.append(Partial())
            grad.append(w)
        else:
            out.append(Replicate())
            grad.append(w)
    local = to_local(table, tp, grad)
    lo = local_shape_and_offset(table.shape, mesh, tp)[1][0]
    ids = tokens.to_local().long() - lo
    inside = (ids >= 0) & (ids < local.shape[0])
    rows = local[ids.clamp(0, max(local.shape[0] - 1, 0))] * \
        inside[..., None].to(local.dtype)
    y = from_local(rows, mesh, out, tuple(tokens.shape) + (table.shape[1],))
    rep = tuple(Replicate() if isinstance(p, Partial) else p for p in out)
    return y if rep == tuple(out) else y.redistribute(mesh, rep)


def replicated(t: torch.Tensor, like):
    """``t``, a tensor every rank computed alike, as a replicated DTensor
    on ``like``'s mesh (unchanged when ``like`` is not a DTensor)."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = like.device_mesh
    return from_local(t, mesh, [Replicate()] * mesh.ndim, t.shape)


def mesh_groups(device_mesh, axes: Sequence[str]) -> list:
    """The process groups of the mesh axes ``axes`` that have more than one
    rank."""
    names = device_mesh.mesh_dim_names
    return [device_mesh.get_group(a) for a in axes
            if device_mesh.size(names.index(a)) > 1]


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def psum_grad(x: torch.Tensor, groups: list) -> torch.Tensor:
    """``x``; its cotangent summed over ``groups`` (the transpose of an
    input replicated over those axes)."""
    return _PsumGrad.apply(x, groups) if groups else x


def scale_grad(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x``; its cotangent times ``c``."""
    return _ScaleGrad.apply(x, c) if c != 1 else x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                          + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: every rank's cotangent of this rank's slice
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),)
                          + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_reduce(x: torch.Tensor, groups: list) -> torch.Tensor:
    """psum of ``x`` over ``groups``, differentiable (its backward is the
    psum of the cotangent)."""
    for grp in groups:
        x = _AllReduce.apply(x, grp)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated on ``dim`` in rank
    order (tiled all-gather), differentiable (a reduce-scatter back)."""
    return _AllGather.apply(x, group, dim)


def group_size(groups: list) -> int:
    return math.prod(dist.get_world_size(g) for g in groups)


def batch_local_call(fn, rules, x, params, state=None):
    """``fn(params, x, state) -> (y, new_state)`` on each rank's own rows
    of ``x`` (its batch shard) with every weight whole, as the reference's
    GSPMD may lay a per-row recurrent body out.  ``y`` and ``new_state``
    come back as DTensors of ``x``'s batch layout; a weight's gradient is
    the sum over the batch shards (``Partial``) of the local ones."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    rows = rules.placements(("batch",) + (None,) * (x.dim() - 1),
                            tuple(x.shape))
    whole = (Replicate(),) * mesh.ndim
    grads = tuple(Partial() if isinstance(p, Shard) else Replicate()
                  for p in rows)

    def tree(f, t):
        if isinstance(t, dict):
            return {k: tree(f, v) for k, v in t.items()}
        return f(t)

    def state_rows(t):
        return rules.placements(("batch",) + (None,) * (t.dim() - 1),
                                tuple(t.shape))

    xl = to_local(x, rows)
    pl = tree(lambda w: to_local(w, whole, grads), params)
    sl = None if state is None else tree(
        lambda t: to_local(t, state_rows(t)) if is_dtensor(t) else t, state)
    yl, nsl = fn(pl, xl, sl)
    b = x.shape[0]

    def back(t):
        shape = (b,) + tuple(t.shape[1:])
        return from_local(t, mesh, rules.placements(
            ("batch",) + (None,) * (t.dim() - 1), shape), shape)
    return back(yl), tree(back, nsl)
