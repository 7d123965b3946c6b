from .grf import (GrfConfig, grf_field_problem, grf_marginal_mle,
                  grf_spectral_problem, hermitian_white_packed)

__all__ = ["GrfConfig", "grf_field_problem", "grf_marginal_mle",
           "grf_spectral_problem", "hermitian_white_packed"]
