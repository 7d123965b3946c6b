from .grf import GrfConfig, grf_field_problem, grf_marginal_mle

__all__ = ["GrfConfig", "grf_field_problem", "grf_marginal_mle"]
