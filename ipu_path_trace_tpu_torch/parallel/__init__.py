from .mesh import make_mesh, parse_mesh_shape, sharded_render_step
