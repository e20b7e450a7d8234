from .sharding import (Mesh, dp_size, get_current_mesh, make_mesh, sp_size, sp_vae,
                       use_mesh)

__all__ = ["Mesh", "dp_size", "get_current_mesh", "make_mesh", "sp_size", "sp_vae",
           "use_mesh"]
