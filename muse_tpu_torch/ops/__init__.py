from .grf_spectrum import (SpectrumQuadform, pack_rfft2, pack_weights,
                           spectrum_quadform, spectrum_quadform_cuda,
                           spectrum_quadform_plain)

__all__ = ["SpectrumQuadform", "pack_rfft2", "pack_weights",
           "spectrum_quadform", "spectrum_quadform_cuda",
           "spectrum_quadform_plain"]
