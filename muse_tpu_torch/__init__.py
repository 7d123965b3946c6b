"""muse_tpu_torch — MUSE (Marginal Unbiased Score Expansion) on PyTorch and CUDA.

The port of ``muse_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100. Module
names mirror ``muse_tpu``'s. Plain tensor work is PyTorch on an explicit
device; each Pallas kernel of ``muse_tpu`` on a ported path becomes a
hand-written CUDA kernel (``csrc/``, built with ``nvcc`` at first use).
The θ loop runs on the host in float64; the device works in float32.
Entry points run on the card (``"cuda"``) unless the caller asks for the
CPU with ``device="cpu"``.

Ported so far: the full MUSE pipeline — ``muse_fit`` (keyed, or with the
CRN whites hoisted), ``get_J``, finite-difference (fixed or adaptive step)
and implicit-diff ``get_H``, ``finalize_result`` — on the field GRF
(``models.grf_field_problem``, slice 1), on the packed spectral GRF of the
north star (``models.grf_spectral_problem``, slice 2), and on user models
without their own latent solver (slice 3): ``SimpleMuseProblem``, the
funnel family and the PPL (``ppl``, ``transforms``, ``distributions``),
whose latent MAPs are the batched L-BFGS of ``ops/lbfgs.py``. Slice 4
adds the remaining field-model families: the lensing model
(``models.lensing_problem``) with its batched variable projection
(``ops/varpro.py``) and trust-region Newton-CG (``ops/newton_cg.py``), the
bandpower model with a vector θ (``models.bandpower_problem``) and the
pixel-space whitened GRF (``models.grf_problem``). Both TPU
kernels of the JAX package have their CUDA counterparts in
``csrc/spectrum_quadform.cu``: the spectrum quadform (the θ-scores) and the
fused quadform + half-gradient (the spectral GRF's PCG operator).
"""

import torch as _torch

# TF32 keeps about three decimal digits. A MUSE score is an O(N)-term sum
# whose per-sim scatter sits in its low bits (docs/internals.md, "f32 score
# precision"), so every float32 product on the card stays full precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .adapters.simple import SimpleMuseProblem  # noqa: E402
from .problem import MuseProblem, check_self_consistency  # noqa: E402
from .result import MuseResult, load_result  # noqa: E402
from .solver.jacobians import get_H, get_J  # noqa: E402
from .solver.muse import muse, muse_fit  # noqa: E402
from .theta import ThetaSpec  # noqa: E402
from .ppl import PPLMuseProblem, model_problem  # noqa: E402
from . import distributions, ppl, transforms  # noqa: E402

__all__ = [
    "MuseProblem", "SimpleMuseProblem", "MuseResult", "load_result", "muse",
    "muse_fit", "get_J", "get_H", "check_self_consistency", "ThetaSpec",
    "PPLMuseProblem", "model_problem", "distributions", "ppl", "transforms",
]

__version__ = "0.3.0"
