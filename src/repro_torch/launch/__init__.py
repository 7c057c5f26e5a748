"""``repro_torch.launch`` — meshes for the shard_map runner and the
sharding rules (``launch/mesh.py``), the production meshes and the H100's
roofline constants, and the dry run (``launch/dryrun.py``, run as
``python -m repro_torch.launch.dryrun``)."""
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, Mesh,
                                     make_host_mesh, make_mesh_compat,
                                     make_production_mesh)

__all__ = ["Mesh", "make_mesh_compat", "make_host_mesh",
           "make_production_mesh", "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW"]
