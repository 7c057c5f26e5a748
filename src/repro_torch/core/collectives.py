"""The shard program's collectives over the "local shards" leading dim.

The reference runs one shard program per shard on a named axis (``vmap``
on one device, ``shard_map`` over a mesh) and exchanges data with five
collectives: the SRP shuffle's ``all_to_all`` (``core/srp.py``), the
RepSN halo's forward ``ppermute`` (``core/repsn.py``), the JobSN
boundary's backward ``ppermute`` (``core/jobsn.py``), and the ``psum`` and
``all_gather`` of the overflow and load telemetry.  In the port every
tensor of a shard program carries a leading dim of the shards it holds
locally, and an axis object supplies those collectives over it:

  * ``LocalAxis(r)``    all r shards are local (the vmap runner): each
                        collective is a tensor op over the leading dim
  * ``GroupAxis(group)``  one local shard per rank of a ``torch.distributed``
                        process group (the shard_map runner): each
                        collective is a ``torch.distributed`` call

Both give a shard program the same results: the shard program under
``GroupAxis`` on rank s equals row s of the same program under
``LocalAxis``.  Every collective is a full ring or exchange over the
axis; the callers invalidate the wrapped edges by ``axis_index``.
"""
from __future__ import annotations

import torch


class LocalAxis:
    """All ``r`` shards on the leading dim of one tensor."""

    def __init__(self, r: int):
        self.size = r

    def axis_index(self, device) -> torch.Tensor:
        """(r,) global index of each local shard."""
        return torch.arange(self.size, device=device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(r, r*c, ...) grouped by destination -> (r, r*c, ...) where
        shard t holds block t of every source, in source order: a
        transpose of the (r_src, r_dst, c, ...) view."""
        r = self.size
        y = x.reshape((r, r, x.shape[1] // r) + tuple(x.shape[2:]))
        return y.transpose(0, 1).reshape(x.shape)

    def ppermute_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Shard s receives shard s-1's rows (ring: shard 0 gets r-1's)."""
        return torch.roll(x, 1, dims=0)

    def ppermute_back(self, x: torch.Tensor) -> torch.Tensor:
        """Shard s receives shard s+1's rows (ring: r-1 gets shard 0's)."""
        return torch.roll(x, -1, dims=0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(r, ...) -> the sum over the shards, in every shard's slot."""
        return x.sum(dim=0, keepdim=True, dtype=x.dtype).expand(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(r, ...) -> (r, r, ...): every shard holds all r values."""
        return x.unsqueeze(0).expand((x.shape[0],) + tuple(x.shape))


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor in a dtype every backend moves (bool as uint8:
    NCCL and gloo both take bytes)."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.view(torch.bool) if like.dtype == torch.bool else y


class GroupAxis:
    """One local shard per rank of ``group`` (None: the default group);
    every tensor's leading dim is 1 and rank s holds shard s."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def axis_index(self, device) -> torch.Tensor:
        # a fill, not a host-to-device copy, so a captured graph holds it
        return torch.full((1,), self.rank, dtype=torch.int64, device=device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        src = _wire(x[0])            # (r*c, ...): block t goes to rank t
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return _unwire(out, x).unsqueeze(0)

    def _peer(self, step: int) -> int:
        import torch.distributed as dist
        peer = (self.rank + step) % self.size
        return peer if self.group is None else \
            dist.get_global_rank(self.group, peer)

    def _ring(self, x: torch.Tensor, step: int) -> torch.Tensor:
        import torch.distributed as dist
        if self.size == 1:
            # a ring of one: the shard receives its own rows (gloo cannot
            # send to its own rank)
            return x.clone()
        src = _wire(x)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self._peer(step),
                          group=self.group),
               dist.P2POp(dist.irecv, out, self._peer(-step),
                          group=self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return _unwire(out, x)

    def ppermute_fwd(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, 1)

    def ppermute_back(self, x: torch.Tensor) -> torch.Tensor:
        return self._ring(x, -1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) -> (1, r, ...)."""
        return gather_shards(x[0], self).unsqueeze(0)


def gather_shards(x: torch.Tensor, axis: GroupAxis) -> torch.Tensor:
    """One rank's (...) tensor -> (r, ...) holding every rank's, in rank
    order, on every rank."""
    import torch.distributed as dist
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``;
    # both take the ranks' tensors concatenated along dim 0
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    src = _wire(x).reshape(-1)
    out = src.new_empty((axis.size * src.numel(),))
    gather(out, src, group=axis.group)
    return _unwire(out, x).reshape((axis.size,) + tuple(x.shape))
