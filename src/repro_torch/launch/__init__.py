"""``repro_torch.launch`` — meshes for the shard_map runner
(``launch/mesh.py``)."""
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh_compat

__all__ = ["Mesh", "make_mesh_compat", "make_host_mesh"]
