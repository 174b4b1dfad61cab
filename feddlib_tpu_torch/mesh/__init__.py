from feddlib_tpu_torch.mesh.mesh import Mesh
from feddlib_tpu_torch.mesh.io import read_mesh, write_mesh
from feddlib_tpu_torch.mesh.structured import build_structured_mesh

__all__ = ["Mesh", "read_mesh", "write_mesh", "build_structured_mesh"]
