from .mesh import SimsMesh, make_sims_mesh

__all__ = ["SimsMesh", "make_sims_mesh"]
