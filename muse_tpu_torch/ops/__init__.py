from .cg import BatchedCgResult, batched_cg
from .diag_pcg import batched_diag_pcg
from .grf_spectrum import (SpectrumQuadform, SpectrumQuadforms, pack_rfft2,
                           pack_weights, spectrum_quadform,
                           spectrum_quadform_and_grad,
                           spectrum_quadform_and_grad_cuda,
                           spectrum_quadform_and_grad_plain,
                           spectrum_quadform_cuda, spectrum_quadform_plain,
                           spectrum_quadforms, spectrum_quadforms_cuda,
                           spectrum_quadforms_plain)
from .herm_white import (herm_white_batched, herm_white_cuda,
                         herm_white_plain)
from .lbfgs import LbfgsResult, batched_lbfgs
from .lens_planes import (lens_combine, lens_contract, lens_expand,
                          lens_residual, lens_spread)
from .newton_cg import NewtonCgResult, batched_newton_cg
from .varpro import VarproResult, batched_varpro

__all__ = ["BatchedCgResult", "batched_cg", "batched_diag_pcg",
           "LbfgsResult", "batched_lbfgs",
           "NewtonCgResult", "batched_newton_cg", "VarproResult",
           "batched_varpro", "SpectrumQuadform", "pack_rfft2",
           "pack_weights", "spectrum_quadform", "spectrum_quadform_and_grad",
           "spectrum_quadform_and_grad_cuda",
           "spectrum_quadform_and_grad_plain", "spectrum_quadform_cuda",
           "spectrum_quadform_plain", "SpectrumQuadforms",
           "spectrum_quadforms", "spectrum_quadforms_cuda",
           "spectrum_quadforms_plain", "herm_white_batched",
           "herm_white_cuda", "herm_white_plain", "lens_expand",
           "lens_combine", "lens_residual", "lens_spread", "lens_contract"]
