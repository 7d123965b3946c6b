from .cg import BatchedCgResult, batched_cg
from .grf_spectrum import (SpectrumQuadform, pack_rfft2, pack_weights,
                           spectrum_quadform, spectrum_quadform_and_grad,
                           spectrum_quadform_and_grad_cuda,
                           spectrum_quadform_and_grad_plain,
                           spectrum_quadform_cuda, spectrum_quadform_plain)

__all__ = ["BatchedCgResult", "batched_cg", "SpectrumQuadform", "pack_rfft2",
           "pack_weights", "spectrum_quadform", "spectrum_quadform_and_grad",
           "spectrum_quadform_and_grad_cuda",
           "spectrum_quadform_and_grad_plain", "spectrum_quadform_cuda",
           "spectrum_quadform_plain"]
