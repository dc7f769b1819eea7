from foundationstereo_torch.parallel.mesh import current_mesh, make_mesh, mesh_context  # noqa: F401
from foundationstereo_torch.parallel.sharding import place_batch, replicate  # noqa: F401
