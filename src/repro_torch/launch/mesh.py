"""Meshes (port of ``repro.launch.mesh``).

The reference's mesh is a grid of JAX devices with named axes.  Here a
``Mesh`` is a ``torch.distributed`` process group laid out as a grid of
its ranks with named axes (``axis_names``, ``sizes``).  Two consumers read
it:

  * the SN ``ShardMapRunner`` puts one shard on each rank of one axis, so
    it takes a mesh with at most one axis above 1;
  * the LM scaffold's sharding rules (``repro_torch.sharding``) lay
    tensors out on ``mesh.device_mesh``, a
    ``torch.distributed.device_mesh.DeviceMesh`` over the same ranks with
    the same axis names, ("data", "model") or ("pod", "data", "model").

``make_mesh_compat`` and ``make_host_mesh`` build it.  Where no default
process group exists they start a world-size-1 group on an in-process
``HashStore`` (no port, no environment variables): NCCL when the device is
the CUDA card (``device=None``), gloo for ``device="cpu"``.  The
shard_map runner refuses a group whose backend does not serve its device.  More shards need more processes: start
them with a launcher (or ``torch.multiprocessing``), call
``torch.distributed.init_process_group`` in each, and pass the group (or
rely on the default one).  Call ``torch.distributed.destroy_process_group``
when done, and clear the executable cache (``perf.executable_cache``),
whose shard_map entries are keyed by the group.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

# a world-size-1 group's collectives never wait on another process; a
# hang there is a fault, raised after this long
GROUP_TIMEOUT = timedelta(seconds=60)


@dataclass(frozen=True)
class Mesh:
    """A process group as a mesh: ``axis_names`` with their sizes
    (``sizes``), the group's ranks laid out row-major over them.  Two
    meshes of the same group and axes are equal (one cache entry)."""
    group: Any
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    # the device type of the tensors on a "fake" group's mesh (a dry run,
    # ``launch.dryrun``): a fake group serves any device
    fake_device: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh's ranks and axis names, on the
        device type the group's backend serves (NCCL: "cuda", gloo:
        "cpu", a fake group: ``fake_device``); built on first use, which
        every rank of the group must reach (it creates one process group
        per axis)."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        ranks = dist.get_process_group_ranks(self.group)
        backend = str(dist.get_backend(self.group))
        kind = self.fake_device if backend == "fake" else \
            "cuda" if "nccl" in backend else "cpu"
        return DeviceMesh(kind, torch.tensor(ranks).reshape(self.sizes),
                          mesh_dim_names=self.axis_names)


def _default_group(size: int, device):
    """The default process group, started at world size 1 on a HashStore
    when none exists: NCCL on the CUDA card (``device=None``, as at every
    entry point of the port), gloo for ``device="cpu"``."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(
                f"a mesh of {size} shards needs {size} processes: start "
                f"them and call torch.distributed.init_process_group in "
                f"each before building the mesh")
        dev = resolve_device(device)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
            timeout=GROUP_TIMEOUT)
    return dist.group.WORLD


def make_mesh_compat(shape, axes, *, group=None, device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``group`` (None:
    the default group, started at world size 1 if there is none; its
    backend follows ``device``, None meaning the card).  The shape's
    product must be the group's world size."""
    import torch.distributed as dist
    sizes = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(sizes) != len(axes):
        raise ValueError(f"shape {sizes} and axes {axes} differ in length")
    if group is None:
        group = _default_group(math.prod(sizes), device)
    world = dist.get_world_size(group)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the group has {world}")
    fake = None
    if str(dist.get_backend(group)) == "fake":
        from repro_torch.device import resolve_device
        fake = resolve_device(device).type
    return Mesh(group=group, axis_names=axes, sizes=sizes, fake_device=fake)


def make_production_mesh(*, multi_pod: bool = False, group=None,
                         device=None) -> Mesh:
    """The reference's production meshes: 16 x 16 = 256 ranks ("data",
    "model"), or with ``multi_pod`` 2 x 16 x 16 = 512 ("pod", "data",
    "model"), over ``group`` (None: the default group).  A group of
    another size raises, and so does the lack of any group: this never
    starts a world-size-1 group.  ``device`` is the device type of the
    tensors when the group is a fake one (a dry run, ``launch.dryrun``;
    None meaning the card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, group=group, device=device)


# H100 SXM5 80GB at its 700 W limit, per card (NVIDIA H100 Tensor Core GPU
# data sheet: dense bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 at
# 900 GB/s in both directions together), the port's counterparts of the
# reference's TPU v5e constants for the roofline
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s each way


def make_host_mesh(model: int = 1, *, group=None, device=None) -> Mesh:
    """A ("data", "model") mesh of (world / ``model``, ``model``) over every
    rank of ``group`` (None: the default group, as ``make_mesh_compat``)."""
    import torch.distributed as dist
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the world size "
                         f"{n}")
    return make_mesh_compat((n // model, model), ("data", "model"),
                            group=group, device=device)
