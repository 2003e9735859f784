from vasp_tpu_torch.mesh.tetmesh import TetMesh  # noqa: F401
from vasp_tpu_torch.mesh.io import read_vasp_mesh, write_vasp_mesh  # noqa: F401
