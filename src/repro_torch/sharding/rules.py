"""Logical-axis sharding rules — port of ``repro.sharding.rules``.

Params and activations are annotated with *logical* axis names; a ``Rules``
instance (bound to a mesh) resolves them to ``PartitionSpec``s, dropping any
mesh axis that does not divide the concrete dim (the reference's rule for
step-function inputs: params, optimizer state, caches), and from a spec to
the DTensor placements of the mesh (``Rules.sharding``).

Logical axes used throughout the framework:

  batch        activation batch                  -> ("pod","data")
  seq          activation sequence               -> None
  residual_seq residual stream sequence          -> "model" when seq_parallel
  kv_seq       kv-cache sequence (decode)        -> "model" when seq_shard_kv
  embed        param d_model dim (FSDP)          -> "data" when fsdp else None
  embed_act    activation d_model dim            -> None
  qkv          fused attention proj out dim      -> "model"
  heads        per-head activation dim           -> "model" (uneven ok)
  d_ff         mlp hidden                        -> "model"
  experts      MoE expert dim                    -> "model" (EP)
  vocab        vocab / logits dim                -> "model"
  layers       stacked layer-group dim           -> None
  none         explicitly replicated             -> None

``Rules`` reads only the mesh's ``axis_names`` and ``shape`` ({name:
size}), so resolving a spec needs no process group.  Building a tensor on
the mesh (``sharding(...).placements`` with ``distribute_tensor``,
``constrain``, ``shard_input``) needs the port's ``launch.Mesh``, whose
``device_mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with the
same axis names.

On a mesh whose axes all have size 1 every layout is the whole tensor:
there the tensors stay plain (``Rules.dtensors`` is False) and run
without DTensor dispatch, with the reference's functions under rules
(the capacity MoE, the one-hot embedding) all the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

Axis = Union[str, None, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over those axes, the first one major) —
    the reference's ``jax.sharding.PartitionSpec``, entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_is_spread(mesh) -> bool:
    """Whether some axis of ``mesh`` has more than one rank: only then are
    tensors laid out on it DTensors."""
    return any(n > 1 for n in mesh.shape.values())


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(axis_names: Sequence[str], spec,
                    sizes: Optional[dict] = None) -> tuple:
    """The DTensor placements of ``spec`` on a mesh with ``axis_names``:
    ``Shard(i)`` on every mesh dim that entry ``i`` names, ``Replicate()``
    on the others.  A tuple entry shards its dim over its axes in the
    mesh's order, as JAX does; an entry naming them in another order has
    no DTensor placement and is refused.  With ``sizes`` ({name: size}) a
    mesh dim of size 1 stays ``Replicate()``: the same layout, which
    DTensor's view rules take where a dim of one element is concerned."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in axis_names]
    for i, entry in enumerate(spec):
        names = _names(entry)
        dims = [list(axis_names).index(a) for a in names]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r}: its axes are not in "
                             f"the mesh's order {tuple(axis_names)}")
        for d in dims:
            if sizes is None or sizes[axis_names[d]] > 1:
                out[d] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what ``jax.sharding.NamedSharding`` is to the
    reference.  ``placements`` are its DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh.axis_names, self.spec,
                               self.mesh.shape)

    @property
    def device_mesh(self):
        return self.mesh.device_mesh

    @property
    def dtensors(self) -> bool:
        """Whether a tensor laid out by this sharding is a DTensor (some
        mesh axis above 1) or stays a plain tensor."""
        return mesh_is_spread(self.mesh)


class Rules:
    def __init__(self, mesh, *, fsdp: bool = True,
                 seq_shard_kv: bool = False, context_parallel: bool = False,
                 seq_parallel: bool = False):
        self.mesh = mesh
        self.fsdp = fsdp
        axes = tuple(mesh.axis_names)
        batch: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in axes)
        self.table: dict[str, Axis] = {
            "batch": batch,
            "seq": None,
            # Megatron-style sequence parallelism: the residual stream is
            # sharded over 'model' on the seq dim between blocks
            "residual_seq": ("model",) if seq_parallel else None,
            "kv_seq": ("model",) if seq_shard_kv else None,
            "embed": ("data",) if fsdp and "data" in axes else None,
            "embed_act": None,
            "qkv": ("model",),
            "heads": ("model",),
            "d_ff": ("model",),
            "experts": ("model",),
            "vocab": ("model",),
            "layers": None,
            "none": None,
        }
        if context_parallel:
            # long-context decode (batch=1): spread kv over data+model
            self.table["kv_seq"] = tuple(
                a for a in ("data", "model") if a in axes)
            self.table["batch"] = tuple(a for a in ("pod",) if a in axes)

    def _present(self, axis: Axis) -> Tuple[str, ...]:
        """Filter to axes that exist in the mesh (partial meshes: tests and
        single-axis topologies)."""
        if axis is None:
            return ()
        if isinstance(axis, str):
            axis = (axis,)
        return tuple(a for a in axis if a in self.mesh.shape)

    def axis_size(self, axis: Axis) -> int:
        n = 1
        for a in self._present(axis):
            n *= self.mesh.shape[a]
        return n

    def spec(self, logical: Sequence[Optional[str]],
             dims: Optional[Sequence[int]] = None) -> PartitionSpec:
        """Resolve logical axis names to a PartitionSpec.

        If ``dims`` is given, any mesh axis that does not evenly divide the
        corresponding dim is dropped (replicated)."""
        out = []
        for i, name in enumerate(logical):
            if name is None:
                out.append(None)
                continue
            phys = self._present(self.table[name])
            if len(phys) == 0:
                out.append(None)
                continue
            if dims is not None:
                sz = self.axis_size(phys)
                if sz == 0 or dims[i] % sz != 0:
                    out.append(None)
                    continue
            out.append(phys if len(phys) > 1 else phys[0])
        return PartitionSpec(*out)

    def sharding(self, logical: Sequence[Optional[str]],
                 dims: Optional[Sequence[int]] = None) -> NamedSharding:
        """The spec on this mesh; ``.placements`` are its DTensor
        placements."""
        return NamedSharding(self.mesh, self.spec(logical, dims))

    def placements(self, logical: Sequence[Optional[str]],
                   dims: Optional[Sequence[int]] = None) -> tuple:
        """The DTensor placements of ``spec(logical, dims)``."""
        return self.spec_placements(self.spec(logical, dims))

    def spec_placements(self, spec) -> tuple:
        """``spec``'s DTensor placements on this mesh."""
        return spec_placements(self.mesh.axis_names, spec, self.mesh.shape)

    @property
    def device_mesh(self):
        return self.mesh.device_mesh

    @property
    def dtensors(self) -> bool:
        """Whether tensors laid out by these rules are DTensors: where some
        mesh axis has more than one rank.  On a mesh of size-1 axes they
        stay plain tensors."""
        return mesh_is_spread(self.mesh)

    def constrain(self, x, logical: Sequence[Optional[str]]):
        """``with_sharding_constraint`` by logical names (uneven dims
        allowed, but for the batch: rows that the batch axes do not divide
        stay whole, as ``shard_input`` lays them out, for DTensor has no
        view of unevenly split rows, such as a (B*S, D) flattening): a
        DTensor is redistributed to the spec's placements.  A plain tensor
        is allowed only where every mesh axis the spec names has size 1
        (it is then laid out already); on a real mesh it is a fault and
        raises."""
        from torch.distributed.tensor import DTensor
        spec = self.spec(logical)
        if "batch" in logical and len(logical) == len(x.shape):
            even = self.spec(logical, tuple(x.shape))
            spec = PartitionSpec(*(even[i] if name == "batch" else e
                                   for i, (name, e) in
                                   enumerate(zip(logical, spec))))
        if isinstance(x, DTensor):
            want = self.spec_placements(spec)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(self.device_mesh, want)
        wide = [a for e in spec for a in _names(e) if self.mesh.shape[a] > 1]
        if wide:
            raise ValueError(f"constrain {tuple(logical)}: a plain tensor "
                             f"on mesh axes {wide} of size > 1")
        return x

    def shard_input(self, x, logical: Sequence[Optional[str]]):
        """``x``, a tensor every rank holds whole (a step's batch, a
        position grid), as a DTensor laid out by ``logical`` with the
        divisibility rule: each rank keeps its own slice, nothing is
        communicated.  A DTensor (a batch given as each rank's shard, as
        a dry run gives it) is brought to that layout.  On a mesh of
        size-1 axes ``x`` itself."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        if not self.dtensors:
            return x
        want = self.placements(logical, tuple(x.shape))
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == want else \
                x.redistribute(self.device_mesh, want)
        return distribute_tensor(x, self.device_mesh, want,
                                 src_data_rank=None)


def is_logical_leaf(x) -> bool:
    """A logical spec: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(rules: Rules, spec_tree, shape_tree):
    """Map a tree of logical-axis tuples + a matching tree of tensors (or
    records with ``.shape``) to ``NamedSharding``s (dropping non-divisible
    axes per leaf)."""
    if is_logical_leaf(spec_tree):
        return rules.sharding(spec_tree, tuple(shape_tree.shape))
    return {k: tree_shardings(rules, spec_tree[k], shape_tree[k])
            for k in spec_tree}
