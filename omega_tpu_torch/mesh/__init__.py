from omega_tpu_torch.mesh.carve import carve_mesh
from omega_tpu_torch.mesh.horz_mesh import HorzMesh, finalize_mesh
from omega_tpu_torch.mesh.icos_patches import patch_icos_mesh
from omega_tpu_torch.mesh.planar import planar_hex_mesh
from omega_tpu_torch.mesh.reorder import reorder_mesh
from omega_tpu_torch.mesh.spherical import spherical_icos_mesh
