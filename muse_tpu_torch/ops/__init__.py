from .cg import BatchedCgResult, batched_cg
from .grf_spectrum import (SpectrumQuadform, pack_rfft2, pack_weights,
                           spectrum_quadform, spectrum_quadform_and_grad,
                           spectrum_quadform_and_grad_cuda,
                           spectrum_quadform_and_grad_plain,
                           spectrum_quadform_cuda, spectrum_quadform_plain)
from .lbfgs import LbfgsResult, batched_lbfgs
from .newton_cg import NewtonCgResult, batched_newton_cg
from .varpro import VarproResult, batched_varpro

__all__ = ["BatchedCgResult", "batched_cg", "LbfgsResult", "batched_lbfgs",
           "NewtonCgResult", "batched_newton_cg", "VarproResult",
           "batched_varpro", "SpectrumQuadform", "pack_rfft2",
           "pack_weights", "spectrum_quadform", "spectrum_quadform_and_grad",
           "spectrum_quadform_and_grad_cuda",
           "spectrum_quadform_and_grad_plain", "spectrum_quadform_cuda",
           "spectrum_quadform_plain"]
