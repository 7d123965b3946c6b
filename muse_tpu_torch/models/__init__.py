from .funnel import funnel_analytic_H, funnel_problem, vector_funnel_problem
from .grf import (GrfConfig, grf_field_problem, grf_marginal_mle,
                  grf_spectral_problem, hermitian_white_packed)

__all__ = ["GrfConfig", "grf_field_problem", "grf_marginal_mle",
           "grf_spectral_problem", "hermitian_white_packed",
           "funnel_problem", "vector_funnel_problem", "funnel_analytic_H"]
