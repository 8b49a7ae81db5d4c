"""Launch layer of the port: meshes over ``torch.distributed`` and the
ranks' spawner (``mesh.py``), and the command-line entry points
(``python -m repro_torch.launch.serve`` / ``.train``)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]
