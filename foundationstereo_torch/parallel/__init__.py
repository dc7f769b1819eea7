from foundationstereo_torch.parallel.mesh import (  # noqa: F401
    RankMesh,
    current_mesh,
    make_mesh,
    mesh_context,
)
from foundationstereo_torch.parallel.sharding import place_batch, replicate  # noqa: F401
