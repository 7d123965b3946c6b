from .mesh import FieldColumns, SimsMesh, make_sims_mesh

__all__ = ["FieldColumns", "SimsMesh", "make_sims_mesh"]
