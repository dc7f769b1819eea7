from foundationstereo_torch.parallel.mesh import current_mesh, make_mesh, mesh_context  # noqa: F401
