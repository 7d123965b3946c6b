from .bandpower import band_edges, bandpower_mle, bandpower_problem
from .funnel import funnel_analytic_H, funnel_problem, vector_funnel_problem
from .grf import (GrfConfig, grf_field_problem, grf_marginal_mle,
                  grf_problem, grf_spectral_problem, hermitian_white_packed)
from .lensing import (bilinear_warp, gradient_field, lensing_problem,
                      taylor_lens)

__all__ = ["GrfConfig", "grf_problem", "grf_field_problem",
           "grf_marginal_mle", "grf_spectral_problem",
           "hermitian_white_packed", "funnel_problem",
           "vector_funnel_problem", "funnel_analytic_H", "band_edges",
           "bandpower_problem", "bandpower_mle", "lensing_problem",
           "bilinear_warp", "gradient_field", "taylor_lens"]
