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
``csrc/spectrum_quadform.cu``: the spectrum quadforms (every θ component
of a GRF θ-score from one read of z) and the fused quadform +
half-gradient (the spectral GRF's PCG operator).

Slice 5 adds the mesh (``parallel``): one process per device over
``torch.distributed``, the sims axis for every problem and every entry
point (``mesh=`` on ``muse``, ``muse_fit``, ``get_J``, ``get_H``), the field
axis for the packed spectral models (``grf_spectral_problem``,
``bandpower_problem``), and ``muse_fit(profile_dir=...)`` on
``torch.profiler``.

Slice 6 gives the field axis to every problem, by two routes
(``solver/compiled.py``): the problems built with ``mesh=`` (the packed
spectral models and, new, the pixel ``grf_problem``, whose entry and exit
FFTs gather each lane's field) sum per-rank partial sums; every other
problem (``SimpleMuseProblem``, the funnel family, the PPL with or without
a θ-bijector, ``grf_field_problem``, lensing) keeps its solver's vectors as
this rank's columns of the latent, with the field hooks of the L-BFGS,
VarPro and Newton-CG loops, and evaluates its own functions on the
gathered latent. ``grf_field_problem(use_pallas=False)`` runs the
quadform's plain version, the JAX package's A/B switch. With it the port
does everything the JAX package does, apart from what is left out on
purpose (ROADMAP).

Slice 8 ports the repo's measuring programs: ``python -m
muse_tpu_torch.bench`` (the headline benchmark of ``bench.py``) and the
scripts of ``muse_tpu_torch.scripts`` (the kernel A/B, the noise modes and
the lensing calibration study).

Slice 9 gives the quadform kernel K weights in one pass
(``ops.spectrum_quadforms``): the GRF θ-scores take every θ component
from one launch, and ``grf_field_problem``'s θ-score is analytic (no
backward); ``scripts.theta_score_bench`` times its routes.
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
from . import distributions, parallel, ppl, transforms  # noqa: E402
# every module that keeps counters, so that trace.counters() lists them
# whatever a caller imported first
from . import models, ops  # noqa: E402,F401

__all__ = [
    "MuseProblem", "SimpleMuseProblem", "MuseResult", "load_result", "muse",
    "muse_fit", "get_J", "get_H", "check_self_consistency", "ThetaSpec",
    "PPLMuseProblem", "model_problem", "distributions", "parallel", "ppl",
    "transforms",
]

__version__ = "0.4.0"
