"""Gaussian-random-field models: the field GRF and the packed spectral GRF.

Counterpart of ``muse_tpu/models/grf.py``'s hermitian white sampler
(grf.py:46-107), ``GrfConfig`` (the ``"fft"`` transform mode;
grf.py:110-173), ``grf_problem`` (grf.py:176-413),
``grf_spectral_problem`` (grf.py:416-662), ``grf_field_problem``
(grf.py:665-738) and ``grf_marginal_mle`` (grf.py:741-805).

``grf_field_problem`` infers the log-amplitude θ of the power spectrum
C_k(θ) = e^θ (k+k0)^(−γ) of a 2D field z from x = z + σ·noise. Its latent
IS the field, and its log-likelihood's Fourier-space term
Σ_k w_k|ẑ_k|²/C_k runs in the hand-written CUDA kernel of
``ops/grf_spectrum.py`` on a card. The MAP is the Wiener filter
ẑ_k = C x̂_k/(C+σ²), batched over lanes, and the θ-score is analytic at
any z: one ``spectrum_quadforms`` launch per batched evaluation.

``grf_problem`` is the same model with the WHITE field u as its latent,
z = S_θ u, in pixel space: its MAP enters and leaves the packed-spectral
PCG through cuFFT, and its analytic θ-score ½Σ w|x̂|²·∂C/(C+σ²)²/n² is one
``spectrum_quadforms`` launch per batched evaluation, every θ component's
weight in the same pass.

``grf_spectral_problem`` carries x and the white latent in the isometric
packing ṽ = pack(√w/n · rfft2(v)), where every operator is diagonal: its
MAP is a batched PCG whose operator and curvature run in the fused
``spectrum_quadform_and_grad`` kernel, and its analytic θ-score in one
``spectrum_quadforms`` launch.

Transforms are ``torch.fft`` with the default "backward" norm, as
``jnp.fft`` uses. Every tensor lives on the configuration's device, in
float32; the device defaults to the card (``"cuda"``) and raises where
there is none.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from ..ops.herm_white import herm_white_batched, herm_white_draw
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.keys import lane_generator

__all__ = ["GrfConfig", "grf_problem", "grf_field_problem",
           "grf_spectral_problem", "grf_marginal_mle",
           "hermitian_white_packed", "pack_field_host"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@functools.lru_cache(maxsize=None)
def _herm_white_coeffs(n: int):
    """Mask coefficients for drawing pack(rfft2(N(0,1)^{n×n})) by indexing.

    A copy of muse_tpu's ``_herm_white_coeffs`` (grf.py:49-84). Per packed
    coordinate of a hermitian white spectrum: generic modes (herm weight 2)
    are iid N(0,1); in the two self-mirrored columns (0 and n/2) rows r and
    n−r are conjugate duplicates (re copied, im negated, each N(0,1/2));
    the four self-conjugate modes are real N(0,1). Encoded as a
    mask-weighted combination of a normal draw and its row-flip
    r→(n−r) mod n. Returns four read-only (n, n//2+1) float32 arrays
    (a, b, c, d): re = a·g + b·flip(g), im = c·h + d·flip(h).
    """
    nr = n // 2 + 1
    a = np.ones((n, nr), np.float32)         # own-draw coefficient (re)
    b = np.zeros((n, nr), np.float32)        # flipped-draw coefficient
    c = np.ones((n, nr), np.float32)         # own-draw coefficient (im)
    d = np.zeros((n, nr), np.float32)
    self_rows = [0] + ([n // 2] if n % 2 == 0 else [])
    spec_cols = [0] + ([nr - 1] if n % 2 == 0 else [])
    for col in spec_cols:
        for r in range(n):
            if r in self_rows:
                a[r, col], c[r, col] = 1.0, 0.0      # real mode
            elif r < n - r:
                a[r, col] = c[r, col] = 1.0 / np.sqrt(2.0)
            else:                                    # mirror of n−r
                a[r, col] = c[r, col] = 0.0
                b[r, col] = 1.0 / np.sqrt(2.0)
                d[r, col] = -1.0 / np.sqrt(2.0)
    for v in (a, b, c, d):
        v.flags.writeable = False
    return a, b, c, d


def _herm_white_tensors(n: int, device) -> tuple:
    return tuple(torch.tensor(v, device=device) for v in _herm_white_coeffs(n))


def _herm_whites_hook(n: int, coeffs, cols, x_parts):
    """A packed model's ``sample_whites_batched(seeds, x_only)`` (problem.py):
    each lane's two hermitian whites, cut to ``cols``, for all lanes at once
    (:func:`~muse_tpu_torch.ops.herm_white.herm_white_batched`). With
    ``x_only`` it draws only the parts ``x_parts`` names (all of them when
    None) and returns None for the others; every lane's generator is fresh,
    so a part left undrawn changes none drawn before it."""
    def sample_whites_batched(seeds, x_only: bool = False):
        parts = x_parts if x_only and x_parts is not None else (0, 1)
        W = [None, None]
        for p, w in zip(parts, herm_white_batched(seeds, n, coeffs, parts,
                                                   cols)):
            W[p] = w
        return tuple(W)
    return sample_whites_batched


def _herm_whites(gen: torch.Generator, n: int, coeffs, cols) -> tuple:
    """A packed model's ``sample_white(gen)``: two hermitian white draws
    from ``gen`` in turn (:func:`hermitian_white_packed`), each cut to
    ``cols``; the hook above draws the same for every lane at once."""
    return (herm_white_draw(gen, n, coeffs)[cols],
            herm_white_draw(gen, n, coeffs)[cols])


def hermitian_white_packed(gen: torch.Generator, n: int) -> torch.Tensor:
    """Draw pack(rfft2(white n×n field))-distributed noise without an FFT.

    Two (n, n//2+1) normal draws from ``gen`` (g, then h), combined by the
    masks of :func:`_herm_white_coeffs`; the (L,) result, L = 2·n·(n//2+1),
    lies on ``gen``'s device (muse_tpu grf.py:87-107, with a generator in
    place of the key)."""
    return herm_white_draw(gen, n, _herm_white_tensors(n, gen.device))


def pack_field_host(x, herm_weight, n: int) -> np.ndarray:
    """Real (n, n) field → packed (L,) float32, on the host in float64
    (muse_tpu grf.py:633-640): pack(√w/n · rfft2(x))."""
    xf = np.fft.rfft2(np.asarray(_host(x), np.float64))
    xf = xf * (np.sqrt(np.asarray(_host(herm_weight), np.float64)) / n)
    return np.concatenate([xf.real.reshape(-1),
                           xf.imag.reshape(-1)]).astype(np.float32)


def _pack_spectrum(zf: torch.Tensor, sqw_n: torch.Tensor) -> torch.Tensor:
    """(…, n, m) complex half-spectrum → (…, 2·n·m) real, scaled by the
    isometric pack scale ``sqw_n`` = √w/n: [real; imag], each flattened."""
    zs = zf * sqw_n
    return torch.cat([zs.real.flatten(-2), zs.imag.flatten(-2)], -1)


def _unpack_spectrum(zt: torch.Tensor, sqw_n: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_pack_spectrum`."""
    re, im = zt.chunk(2, -1)
    return torch.complex(re, im).reshape(zt.shape[:-1] + sqw_n.shape) / sqw_n


def _packed_diag_pcg(A, b, Z0, atol, cg_maxiter, grid, nz=None,
                     reduce=None):
    """Batched PCG on the diagonal system A·z = b in packed coordinates,
    preconditioned by the exact inverse 1/A. ``A`` is (1, L), ``b`` and the
    warm start ``Z0`` are (B, L), and ``grid`` = (n, 2m) is the kernels'
    view of a packed (L,). The operator and the curvature (Ap, pᵀAp) of
    every step come from one ``spectrum_quadform_and_grad`` call: the fused
    kernel on a card. Returns (the (B, L) solution, the MAP solver's aux
    dict).

    The CG residual r = b − Az is −∇z(−log_like) exactly, so the stop
    follows the solver-wide ∇z tolerance, an ABSOLUTE gradient norm:
    ``atol``·√nz (the L∞→L2 envelope; ``nz`` is the latent's length, L
    unless the caller's latent lives in pixels) over ‖b‖ is the per-lane
    relative tolerance that ``batched_cg`` takes.

    Under a field axis the vectors are this rank's rows of the grid,
    ``grid`` is their (rows, 2m) view, ``nz`` the WHOLE latent's length and
    ``reduce`` the mesh's field sum: ‖b‖ and every sum of the loop are
    global, and the kernel still computes each launch's local part."""
    from ..ops.cg import batched_cg
    from ..ops.grf_spectrum import spectrum_quadform_and_grad

    A_grid = A.reshape(grid)
    r0 = b - A * Z0
    if reduce is None:
        b_norm = torch.linalg.vector_norm(b, dim=-1)
    else:
        b_norm = torch.sqrt(reduce(torch.sum(b * b, -1)))
    rel_tol = atol * float(np.sqrt(np.float32(nz or Z0.shape[1]))) / \
        torch.clamp(b_norm, min=1e-30)

    def matvec_and_curvature(P):
        quad, half = spectrum_quadform_and_grad(
            P.reshape((P.shape[0],) + grid), A_grid)
        return half.reshape(P.shape), quad

    res = batched_cg(None, None, Z0, tol=rel_tol, maxiter=cg_maxiter,
                     precond=lambda R: R / A, r0=r0, z0=r0 / A,
                     b_norm=b_norm,
                     matvec_and_curvature=matvec_and_curvature,
                     reduce=reduce)
    return res.x, {"converged": res.converged,
                   "failed": ~torch.isfinite(res.r_norm),
                   "iterations": res.iterations, "g_norm": res.r_norm}


def _field_share(mesh, n: int, solver: str, who: str):
    """This rank's share of a packed (n, 2m) grid under ``mesh``: (the
    slice of a packed (L,) vector it holds, the count of its rows, the sum
    over the field axis of a per-lane partial sum). Without a field axis:
    every row, ``slice(None)`` and no sum. A field axis needs a solver whose
    sums over the latent take the mesh's reduction (not the generic
    L-BFGS)."""
    if mesh is None:
        return slice(None), n, None
    from ..parallel.mesh import SimsMesh
    if not isinstance(mesh, SimsMesh):
        raise TypeError(f"{who}: mesh must be a SimsMesh "
                        f"(parallel.make_sims_mesh), got {type(mesh).__name__}")
    if mesh.field_axis is None:
        return slice(None), n, None
    if solver == "lbfgs":
        raise ValueError(f"{who}(solver='lbfgs') cannot be built with a "
                         "field axis: the generic L-BFGS evaluates the "
                         "log-likelihood on whole lanes. Build it without "
                         "mesh= and pass the mesh to the solver only (the "
                         "gathered route, solver/compiled.py)")
    rows = mesh.field_rows(n)
    m2 = 2 * (n // 2 + 1)
    return (slice(rows.start * m2, rows.stop * m2), rows.stop - rows.start,
            mesh.reduce_field)


def _set_field(prob, mesh, cols, size: int):
    """Mark ``prob`` as holding the slice ``cols`` of its length-``size``
    latent on ``mesh``'s field axis (``MuseProblem.field_mesh``)."""
    if mesh is not None and mesh.field_axis is not None:
        prob.field_mesh = mesh
        prob.field_slice = cols
        prob.field_size = size


def _packed_spectral_problem(name: str, cfg: GrfConfig, model_on,
                             log_prior, theta_true, *, noise: str,
                             solver: str, x_obs, data_seed: int,
                             cg_maxiter: int, mesh, read=_host,
                             weight64=None) -> SimpleMuseProblem:
    """The packed-spectral diagonal GRF, the family of
    :func:`grf_spectral_problem` and ``bandpower_problem``: x and the white
    latent ũ in the isometric packing ṽ = pack(√w/n · rfft2(v)) of length
    L = 2·n·(n//2+1), x̃ = √C(θ)·ũ + σ·ẽ per packed coordinate, so the MAP
    operator A = 1 + C/σ² and the implicit-H preconditioner 1/A are
    diagonal. The white draws and split, the log-likelihood, the MAP
    solvers, the data's three forms, the field share and the attributes
    are here; the caller gives what is its own:

      * ``model_on(cols, grid)`` → ``(C2, grad_theta, attrs)`` on the slice
        ``cols`` of a packed (L,) vector that this rank holds, whose
        kernels' view is ``grid`` = (rows, 2m): ``C2(θ)`` the spectrum per
        packed coordinate of the slice, ``grad_theta`` the analytic
        θ-score and ``attrs`` the problem's own attributes;
      * ``log_prior``, and ``theta_true``, which draws the data when
        ``x_obs`` is None;
      * ``read``, its device→host read (one that counts, or ``_host``),
        and ``weight64``, the float64 hermitian weights of
        ``unpack_field`` (None: ``cfg.herm_weight``, read).

    ``noise``, ``solver``, ``x_obs``, ``data_seed``, ``cg_maxiter`` and
    ``mesh`` are :func:`grf_spectral_problem`'s; ``name`` names the problem
    and its errors."""
    if noise not in ("marginal", "direct", "fft"):
        raise ValueError(
            f"noise must be 'marginal'|'direct'|'fft', got {noise!r}")
    if solver not in ("cg", "direct", "lbfgs"):
        raise ValueError(f"solver must be 'cg'|'direct'|'lbfgs', got "
                         f"{solver!r}")
    n = cfg.n
    cols, rows, reduce = _field_share(mesh, n, solver, name)
    if cols != slice(None) and x_obs is None:
        # the data, drawn whole as without a mesh
        x_obs = _packed_spectral_problem(
            name, cfg, model_on, log_prior, theta_true, noise=noise,
            solver="direct", x_obs=None, data_seed=data_seed,
            cg_maxiter=cg_maxiter, mesh=None, read=read,
            weight64=weight64).x
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device
    nr = n // 2 + 1
    # the kernels' (rows, 2m) view of this rank's packed coordinates
    grid = (rows, 2 * nr)
    sqw_n = torch.sqrt(cfg.herm_weight) / n
    if weight64 is None:
        weight64 = np.asarray(read(cfg.herm_weight), np.float64)
    sqw_n_host = np.sqrt(weight64) / n
    coeffs = _herm_white_tensors(n, dev)
    _C2, grad_theta, attrs = model_on(cols, grid)

    def pack_field(v):
        """Real (n, n) field → packed (L,) on the device."""
        zs = torch.fft.rfft2(v, dim=(-2, -1)) * sqw_n
        return torch.cat([zs.real.reshape(-1), zs.imag.reshape(-1)])

    def unpack_field(vt):
        """Packed (L,) → real (n, n) field, numpy float64 on the host."""
        re, im = np.split(np.asarray(read(vt), np.float64), 2)
        zf = (re + 1j * im).reshape(n, nr) / sqw_n_host
        return np.fft.irfft2(zf, s=(n, n))

    # ---- packed white noise and the sample completion --------------- #
    if noise == "fft":
        def sample_white(gen):
            return tuple(pack_field(torch.randn((n, n), generator=gen,
                                                device=dev))[cols]
                         for _ in range(2))
    else:
        def sample_white(gen):
            return _herm_whites(gen, n, coeffs, cols)

    if noise == "marginal":
        # x̃ ~ N(0, C+σ²) and ũ|x̃ ~ N(√C x̃/(C+σ²), σ²/(C+σ²)): the same
        # joint law as the other modes, with x a function of w₁ alone
        def x_of_white(W, theta):
            w1, w2 = W
            C2 = _C2(theta)
            D = C2 + s2
            xt = torch.sqrt(D) * w1
            if w2 is None:
                return xt, None
            return xt, (torch.sqrt(C2) / D) * xt + torch.sqrt(s2 / D) * w2
    else:
        def x_of_white(W, theta):
            ut, et = W
            return torch.sqrt(_C2(theta)) * ut + cfg.sigma_noise * et, ut

    def sample_x_z(gen, theta):
        # the CRN stream of every noise mode is the white split composed
        return x_of_white(sample_white(gen), theta)

    def log_like(xt, ut, theta):
        r = xt - torch.sqrt(_C2(theta)) * ut
        return -0.5 * (torch.sum(r * r) / s2 + torch.sum(ut * ut))

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG with the diagonal operator A = 1 + C/σ²: no FFT."""
        C2 = _C2(th_flat)[None]
        return _packed_diag_pcg(1.0 + C2 / s2, torch.sqrt(C2) * xs / s2, Z0,
                                atol, cg_maxiter, grid, nz=2 * n * nr,
                                reduce=reduce)

    def zhat_direct(xs, Z0, th_flat, atol):
        C2 = _C2(th_flat)[None]
        Z = torch.sqrt(C2) * xs / (s2 + C2)
        B = Z.shape[0]
        return Z, {"converged": torch.ones(B, dtype=torch.bool, device=dev),
                   "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    elif np.ndim(read(x_obs)) == 2:
        x_obs = torch.tensor(pack_field_host(read(x_obs),
                                             read(cfg.herm_weight), n),
                             device=dev)
    else:
        x_obs = torch.tensor(np.asarray(read(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(
        x_obs[cols], sample_x_z, log_like, log_prior,
        custom_zhat={"cg": zhat_cg, "direct": zhat_direct,
                     "lbfgs": None}[solver],
        grad_theta_log_like=grad_theta, device=dev,
        sample_white=sample_white, x_of_white=x_of_white,
        x_white_parts=(0,) if noise == "marginal" else None)
    prob.name = name
    prob.grf_config = cfg
    if noise != "fft" and dev.type == "cuda":
        prob.sample_whites_batched = _herm_whites_hook(n, coeffs, cols,
                                                       prob.x_white_parts)
    _set_field(prob, mesh, cols, 2 * n * nr)
    prob.x_real = unpack_field(x_obs)     # for closed-form oracles
    prob.pack_field = pack_field
    prob.unpack_field = unpack_field

    def h_precond(w, x, th_flat):
        """Exact A⁻¹ for implicit-diff get_H: diagonal in packed
        coordinates (the Pl hook, src/muse.jl:312)."""
        return w / (1.0 + _C2(th_flat) / s2)

    prob.suggested_h_precond = h_precond
    for k, v in attrs.items():
        setattr(prob, k, v)
    return prob


def _dlogC(cfg) -> torch.Tensor:
    """∂log C/∂θ_α on the rfft grid, one (n, m) plane per θ component: 1 for
    the log-amplitude and, with ``infer_tilt``, −log(k+k₀) for the tilt."""
    d = [torch.ones_like(cfg.k)]
    if cfg.infer_tilt:
        d.append(-torch.log(cfg.k + cfg.k0))
    return torch.stack(d)


def _theta_shaped(g: torch.Tensor, theta) -> torch.Tensor:
    """The (ntheta,) score ``g`` in θ's own shape: a scalar for a scalar
    θ."""
    scalar = (theta.dim() if isinstance(theta, torch.Tensor)
              else np.ndim(theta)) == 0
    return g[0] if scalar else g


class GrfConfig:
    """Static configuration for a GRF amplitude(/tilt) problem.

    ``k`` and ``herm_weight`` (each (n, n//2+1)) are computed from ``n``
    unless given, which lets ``convert.grf_config_from_arrays`` carry the
    JAX package's arrays across unchanged."""

    def __init__(self, n: int = 256, sigma_noise: float = 1.0,
                 gamma: float = 2.0, k0: float = 1.0,
                 infer_tilt: bool = False, *, device="cuda",
                 k=None, herm_weight=None):
        self.n = n
        self.sigma_noise = sigma_noise
        self.gamma = gamma
        self.k0 = k0
        self.infer_tilt = infer_tilt
        self.device = resolve_device(device)
        if k is None:
            ky = np.fft.fftfreq(n) * n
            kx = np.fft.rfftfreq(n) * n
            k = np.hypot(ky[:, None], kx[None, :])
        if herm_weight is None:
            # multiplicity of each rfft2 mode in the full hermitian spectrum
            # (columns 0 and n/2 appear once, the others twice)
            herm_weight = np.full((n, n // 2 + 1), 2.0)
            herm_weight[:, 0] = 1.0
            if n % 2 == 0:
                herm_weight[:, -1] = 1.0
        self.k = torch.tensor(np.asarray(k, np.float32), device=self.device)
        self.herm_weight = torch.tensor(np.asarray(herm_weight, np.float32),
                                        device=self.device)
        if tuple(self.k.shape) != (n, n // 2 + 1) or \
                self.herm_weight.shape != self.k.shape:
            raise ValueError(f"k and herm_weight must be ({n}, {n // 2 + 1})")

    def theta_tensor(self, theta) -> torch.Tensor:
        """θ as a float32 tensor on the device (differentiable if it was)."""
        if isinstance(theta, torch.Tensor):
            return theta.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(theta, np.float32),
                               device=self.device)

    def rfft2(self, u):
        """Batched 2D real FFT over the trailing axes."""
        return torch.fft.rfft2(u, dim=(-2, -1))

    def irfft2(self, v):
        """Inverse of :meth:`rfft2` for hermitian-consistent spectra."""
        return torch.fft.irfft2(v, s=(self.n, self.n), dim=(-2, -1))

    def spectrum(self, theta) -> torch.Tensor:
        """C_k(θ) = e^{θ₀} (k+k0)^{-(γ+θ₁)} on the rfft grid."""
        th = torch.atleast_1d(self.theta_tensor(theta))
        gamma = self.gamma + (th[1] if self.infer_tilt else 0.0)
        return torch.exp(th[0]) * (self.k + self.k0) ** (-gamma)

    def apply_sqrtC(self, u, theta):
        """z = S_θ u = F⁻¹(√C_k · F u) — real symmetric operator."""
        return self.irfft2(torch.sqrt(self.spectrum(theta)) * self.rfft2(u))

    def apply_C(self, u, theta):
        """F⁻¹(C_k · F u): the field covariance applied to u."""
        return self.irfft2(self.spectrum(theta) * self.rfft2(u))


def grf_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                sigma_noise: float = 1.0, gamma: float = 2.0,
                k0: float = 1.0, infer_tilt: bool = False,
                theta_true=None, data_seed: int = 42, x_obs=None,
                solver: str = "cg", cg_maxiter: int = 200,
                prior_std: float = 3.0, mesh=None,
                fft_mode: str = "auto", device="cuda") -> SimpleMuseProblem:
    """The whitened GRF in pixel space: the latent is the white field
    u ~ N(0, I), z = S_θ u, x = z + σ·noise.

    Counterpart of muse_tpu's ``grf_problem`` (grf.py:176-413). The latent
    Hessian is I + S_θᵀS_θ/σ², of bounded condition number.

      * ``solver="cg"`` (default): the batched PCG in packed-spectral
        coordinates, where the normal-equation operator A = 1 + C/σ² is
        diagonal. The only transforms of a solve are ``rfft2`` of x and of
        the warm start at entry and one ``irfft2`` at exit; every CG step
        is one launch of the fused ``spectrum_quadform_and_grad`` kernel
        on a card. ``"direct"``: the Fourier-diagonal closed form
        û = √C x̂/(σ²+C). ``"lbfgs"``: no ``custom_zhat``, so the MAPs take
        the generic batched L-BFGS on the log-likelihood.
      * ``grad_theta``: the analytic score at the exact MAP, the
        cancellation-free sum ½ Σ w p ∂C/(C+σ²)², p = |x̂|²/n², through the
        ``spectrum_quadforms`` kernel: one launch per batched evaluation,
        with one weight per θ component.
      * ``fft_mode``: ``"auto"`` and ``"fft"`` are ``torch.fft`` (under a
        field axis, on the gathered field). The einsum DFT (``"matmul"``)
        exists in the JAX package for sharded layouts that XLA's FFT
        rejects and is not ported (ROADMAP, "Left out on purpose").
      * ``mesh``: a :class:`~muse_tpu_torch.parallel.SimsMesh`. Its sims
        axis is the solver's business. Under a field axis of size f this
        rank holds the pixel rows ``mesh.field_rows(n)`` of every lane's
        latent u (n/f rows of n), and the PCG state lives on the same rows
        of the packed (n, 2m) grid: the fused kernel runs on
        (B, n/f, 2m) at every CG step and the solver sums the CG's dot
        products over the field axis (the sharded-sum route,
        ``solver/compiled.py``). Only a solve's entry ``rfft2`` of the
        warm start and its exit ``irfft2`` touch a whole field: each
        gathers the lanes' fields whole (``SimsMesh.gather_field``),
        transforms them locally and keeps this rank's rows. x and the
        whites stay whole on every rank (the sampler's √C is a local
        transform), and the θ-score runs the quadform on this rank's rows
        of x̂, a partial sum that the solver sums over the axis. JAX's
        ``fft_mode="fft"`` does the same (reshard, local FFT, reshard).
        Its ``log_like`` needs the whole latent, so the generic L-BFGS
        (``solver="lbfgs"``) and implicit-diff ``get_H`` are refused on
        this route: build the problem without ``mesh=`` and pass the mesh
        to the solver only, and they run on the gathered route.

    ``x_obs`` (an (n, n) array or tensor) is the data; without it the data
    are drawn at ``theta_true`` from ``data_seed``. ``config``, when given,
    fixes the device.
    """
    from ..ops.grf_spectrum import (pack_rfft2, pack_weights,
                                    spectrum_quadforms)

    if solver not in ("cg", "direct", "lbfgs"):
        raise ValueError(f"solver must be 'cg'|'direct'|'lbfgs', got "
                         f"{solver!r}")
    if fft_mode not in ("auto", "fft", "matmul"):
        raise ValueError(f"fft_mode must be 'auto'|'fft'|'matmul', got "
                         f"{fft_mode!r}")
    if fft_mode == "matmul":
        raise NotImplementedError(
            "grf_problem(fft_mode='matmul'): the einsum DFT guards a fault "
            "of XLA's FFT under sharding and is left out of the port "
            "(ROADMAP, 'Left out on purpose')")
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt,
                              device=device)
    n = cfg.n
    # this rank's packed share (the (n, 2m) grid's rows ``prows`` as the
    # slice ``pcols`` of a packed (L,)) and the CG's field sum
    pcols, nrows, reduce = _field_share(mesh, n, solver, "grf_problem")
    field = reduce is not None
    rows = mesh.field_rows(n) if field else slice(0, n)
    ucols = slice(rows.start * n, rows.stop * n)   # ... of a flat pixel u
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device
    nr = n // 2 + 1
    L = 2 * n * nr
    grid = (nrows, 2 * nr)   # the kernels' view of this rank's packed rows
    sqw_n = torch.sqrt(cfg.herm_weight) / n   # isometric pack scale
    dlogC = _dlogC(cfg)

    def gather(V, cols, size):
        """Every lane's whole field from this rank's columns (V itself
        without a field axis)."""
        return mesh.gather_field(V, cols, size) if field else V

    # CRN white split (problem.py): the pixel whites are θ-independent, so
    # the muse loop hoists the RNG out of the outer iteration (the
    # θ-dependent √C scaling stays)
    def sample_white(gen):
        return (torch.randn((n, n), generator=gen, device=dev),
                torch.randn((n, n), generator=gen, device=dev))

    def x_of_white(W, theta):
        u, e = W
        return cfg.apply_sqrtC(u, theta) + cfg.sigma_noise * e, u[rows]

    def sample_x_z(gen, theta):
        return x_of_white(sample_white(gen), theta)

    def log_like(x, u, theta):
        if field:
            raise NotImplementedError(
                "grf_problem built with a field-axis mesh= holds this rank's "
                "rows of the latent, and its log-likelihood needs the whole "
                "latent (the generic L-BFGS MAP, implicit-diff get_H): build "
                "it without mesh= and pass the mesh to the solver only (the "
                "gathered route)")
        r = x - cfg.apply_sqrtC(u, theta)
        return -0.5 * (torch.sum(r * r) / s2 + torch.sum(u * u))

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(x, u, theta):
        """Analytic ∂θ log_like in Fourier space (the ∇θ_logLike override).

        Per rfft mode, with r̂ = x̂ − √C û and p = |x̂|²/n²:
          g_α = ½/σ² Σ w Re[r̂·conj(∂_α√C·û)]/n²
        which AT THE EXACT MAP û = √C x̂/(C+σ²) collapses to the
        cancellation-free, all-positive form
          g_α = ½ Σ w p ∂_αC/(C+σ²)²      (∂C/∂θ₀ = C; ∂C/∂θ₁ = −log(k+k₀)C).
        At high SNR (σ² ≪ C) the real-space product rᵀSu/σ² loses the
        residual's significant bits to float32 FFT rounding; this form has
        a per-mode relative error ~eps. It assumes that the latent solve
        reached the Wiener MAP (exact for ``solver="direct"``, to the
        solver's tolerance for ``"cg"``). Every θ component's sum comes from
        one ``spectrum_quadforms`` call (one weight each)."""
        C = cfg.spectrum(theta)
        wq = cfg.herm_weight * C / ((C + s2) ** 2 * (n * n))
        # this rank's rows of x̂ (all of them without a field axis)
        z = pack_rfft2(x)[None, rows]
        g = 0.5 * spectrum_quadforms(z, pack_weights(dlogC * wq)[:, rows])[0]
        return _theta_shaped(g, theta)

    # batched MAP solvers over the whitened latent; the normal equations
    # are (I + S_θᵀS_θ/σ²) u = S_θᵀ x / σ², with S_θᵀS_θ = C_k

    def _theta_of(th_flat):
        return th_flat if cfg.infer_tilt else th_flat[0]

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG in PACKED-SPECTRAL coordinates.

        A = I + SᵀS/σ² is exactly diagonal per Fourier mode, so the CG runs
        on the isometric packing ũ = pack(√w/n · rfft2(u)) (Parseval with
        hermitian column weights). CG in exact arithmetic is invariant
        under an isometric change of basis, and the packed residual norm
        equals the pixel-space gradient norm, so the stopping semantics
        are those of a pixel-space CG. The diagonal operator keeps the
        hermitian-consistent subspace because the spectrum is radial."""
        B = xs.shape[0]
        C = cfg.spectrum(_theta_of(th_flat))
        A = (1.0 + C / s2).reshape(-1).repeat(2)[None, pcols]   # (1, L/f)
        bt = _pack_spectrum(torch.sqrt(C) * cfg.rfft2(xs) / s2,
                            sqw_n)[:, pcols]
        U0 = gather(Z0, ucols, n * n).reshape(B, n, n)
        u0t = _pack_spectrum(cfg.rfft2(U0), sqw_n)[:, pcols]
        del U0
        ut, aux = _packed_diag_pcg(A, bt, u0t, atol, cg_maxiter, grid,
                                   nz=n * n, reduce=reduce)
        U = cfg.irfft2(_unpack_spectrum(gather(ut, pcols, L), sqw_n))
        return U[:, rows].reshape(B, -1), aux

    def zhat_direct(xs, Z0, th_flat, atol):
        C = cfg.spectrum(_theta_of(th_flat))
        Z = cfg.irfft2(torch.sqrt(C) * cfg.rfft2(xs) / (s2 + C))[:, rows]
        B = Z.shape[0]
        return Z.reshape(B, -1), {
            "converged": torch.ones(B, dtype=torch.bool, device=dev),
            "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        if theta_true is None:
            theta_true = (torch.zeros(2, device=dev) if cfg.infer_tilt
                          else 0.0)
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(
        x_obs, sample_x_z, log_like, log_prior,
        custom_zhat={"cg": zhat_cg, "direct": zhat_direct,
                     "lbfgs": None}[solver],
        grad_theta_log_like=grad_theta, device=dev,
        sample_white=sample_white, x_of_white=x_of_white)
    prob.name = "grf_problem"
    prob.grf_config = cfg
    _set_field(prob, mesh, ucols, n * n)

    def h_precond(w, x, th_flat):
        """Ready-made CG preconditioner for implicit-diff get_H (the Pl
        hook, src/muse.jl:312): for the whitened latent the z-Hessian is
        EXACTLY Fourier-diagonal, A = −∇z²logLike = I + C_θ/σ², so this is
        the exact inverse and the per-column CG solves converge in O(1)
        iterations."""
        C = cfg.spectrum(_theta_of(th_flat))
        return cfg.irfft2(cfg.rfft2(w.reshape(n, n))
                          / (1.0 + C / s2)).reshape(-1)

    prob.suggested_h_precond = h_precond
    return prob


def grf_field_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true: float = 0.0,
                      data_seed: int = 42, x_obs=None,
                      prior_std: float = 3.0, use_pallas: bool = True,
                      device="cuda") -> SimpleMuseProblem:
    """Non-whitened GRF: the latent IS the field z ~ N(0, F⁻¹CF).

      log p(x, z|θ) = −½ [ Σ(x−z)²/σ² + Σ_k w_k|ẑ_k|²/C_k / n²
                           + Σ_k w_k log C_k ] + const

    The quadform term runs through :func:`spectrum_quadform` (the CUDA
    kernel on a card). The θ-score is analytic, at any z (the
    ``grad_theta_log_like`` hook; muse_tpu takes ``jax.grad`` of the same
    log-likelihood): ½Σ w d_α|ẑ|²/C/n² − ½Σ w d_α with d_α = ∂log C/∂θ_α,
    every component from one :func:`spectrum_quadforms` launch per batched
    evaluation and no backward. ``use_pallas=False`` sends both through
    the plain versions instead, on the card too, with no kernel launch:
    the end-to-end A/B switch of the JAX package's argument of the same
    name (which there picks the Pallas kernel). ``x_obs`` (an
    (n, n) array or tensor) is the data; without it the data are drawn at
    ``theta_true`` from ``data_seed``. ``config``, when given, fixes the
    device.

    Under a field-axis ``mesh=`` passed to the solver the problem takes the
    gathered route (``solver/compiled.py``): its Wiener MAP and its
    log-likelihood, the quadform included, run on the whole field.
    """
    from ..ops.grf_spectrum import (pack_rfft2, pack_weights,
                                    spectrum_quadform,
                                    spectrum_quadform_plain,
                                    spectrum_quadforms,
                                    spectrum_quadforms_plain)

    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, False, device=device)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device
    dlogC = _dlogC(cfg)
    w_dlogC = torch.sum(cfg.herm_weight * dlogC, dim=(-2, -1))

    def sample_x_z(gen, theta):
        # draw order as in JAX: the white field u first, then the noise
        u = torch.randn((n, n), generator=gen, device=dev)
        z = cfg.apply_sqrtC(u, theta)
        x = z + cfg.sigma_noise * torch.randn((n, n), generator=gen,
                                              device=dev)
        return x, z

    _quadform = spectrum_quadform if use_pallas else spectrum_quadform_plain
    _quadforms = (spectrum_quadforms if use_pallas
                  else spectrum_quadforms_plain)

    def log_like(x, z, theta):
        C = cfg.spectrum(theta)
        invCw2 = pack_weights(cfg.herm_weight / C)
        quad = _quadform(pack_rfft2(z)[None], invCw2)[0] / n ** 2
        logdet = torch.sum(cfg.herm_weight * torch.log(C))
        r = x - z
        return -0.5 * (torch.sum(r * r) / s2 + quad + logdet)

    def grad_theta(x, z, theta):
        """Analytic ∂θ log_like at any z (the ∇θ_logLike override): with
        d_α = ∂log C/∂θ_α (1, and −log(k+k₀) for the tilt),
          g_α = ½ Σ w d_α |ẑ|²/C / n² − ½ Σ w d_α,
        every component's quadform from one ``spectrum_quadforms`` call:
        one kernel launch per batched evaluation and no backward. For the
        amplitude the weight is log_like's own w/C."""
        C = cfg.spectrum(theta)
        q = _quadforms(pack_rfft2(z)[None],
                       pack_weights(cfg.herm_weight * dlogC / C))[0]
        return _theta_shaped(0.5 * q / n ** 2 - 0.5 * w_dlogC, theta)

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    def zhat_wiener(xs, Z0, th_flat, atol):
        """All lanes' MAPs at once: ẑ_k = C x̂_k / (C + σ²)."""
        C = cfg.spectrum(th_flat[0])
        Z = cfg.irfft2(C * cfg.rfft2(xs) / (C + s2))
        B = Z.shape[0]
        return Z.reshape(B, -1), {
            "converged": torch.ones(B, dtype=torch.bool, device=dev),
            "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=zhat_wiener,
                             grad_theta_log_like=grad_theta, device=dev)
    prob.name = "grf_field_problem"
    prob.grf_config = cfg
    return prob


@trace.spanned("muse.build.problem")
def grf_spectral_problem(config: Optional[GrfConfig] = None, *,
                         n: int = 256, sigma_noise: float = 1.0,
                         gamma: float = 2.0, k0: float = 1.0,
                         infer_tilt: bool = False, theta_true=None,
                         data_seed: int = 42, x_obs=None, solver: str = "cg",
                         cg_maxiter: int = 200, prior_std: float = 3.0,
                         mesh=None, noise: str = "marginal",
                         device="cuda") -> SimpleMuseProblem:
    """The whitened GRF with x AND z in packed-spectral coordinates.

    Counterpart of muse_tpu's ``grf_spectral_problem`` (grf.py:416-662):
    the observation and the white latent are carried in the isometric
    packing ṽ = pack(√w/n · rfft2(v)) of length L = 2·n·(n//2+1), where
    the MAP operator, the θ-score and the implicit-H preconditioner are
    all diagonal.

      * ``noise="marginal"`` (default): x̃ = √(C+σ²)·w₁ and the conditional
        ũ|x̃ = (√C/(C+σ²))·x̃ + √(σ²/(C+σ²))·w₂, with w₁, w₂ hermitian
        white draws (:func:`hermitian_white_packed`). x depends on w₁ alone
        (``x_white_parts = (0,)``), so the iteration neither draws nor
        keeps w₂ and never computes ũ. ``"direct"``: x̃ = √C·ũ + σ·ẽ from
        the same sampler. ``"fft"``: the two whites are packed rfft2s of
        pixel normals.
      * ``solver="cg"``: the batched PCG of ``ops/cg.py`` with A = 1 + C/σ²
        and M⁻¹ = 1/A; its operator and curvature (Ap, pᵀAp) come from the
        fused ``spectrum_quadform_and_grad`` kernel on a card.
        ``"direct"``: the closed form û = √C x̃/(σ²+C). ``"lbfgs"``: no
        ``custom_zhat``, so the MAPs take the generic batched L-BFGS
        (``ops/lbfgs.py``) on the log-likelihood.
      * ``grad_theta``: the analytic score ½Σ x̃²·∂C/(C+σ²)² through the
        ``spectrum_quadforms`` kernel, one launch per batched evaluation
        with one weight per θ component.

    ``x_obs`` may be a real (n, n) field (packed on the host in float64)
    or an already packed (L,) vector; without it the data are drawn at
    ``theta_true`` from ``data_seed``. ``prob.x_real`` holds the pixel
    field for closed-form oracles (:func:`grf_marginal_mle`). ``config``,
    when given, fixes the device.

    ``mesh``: a :class:`~muse_tpu_torch.parallel.SimsMesh`. Its sims axis
    is the solver's business. Under a field axis of size f this rank holds
    the rows ``mesh.field_rows(n)`` of the packed (n, 2m) grid, for every
    lane and every constant: x, z, the whites and C are (…, n/f · 2m)
    slices, the kernels run on (B, n/f, 2m), and the solver sums the
    θ-score and the PCG's dot products over the field axis. The whites are
    each lane's generator's draw cut to the rank's rows, so every sim is the
    one drawn without a mesh; the data are drawn whole too.
    ``solver="lbfgs"`` cannot take a field axis.

    On a card, ``prob.sample_whites_batched`` (noise ``"marginal"`` and
    ``"direct"``) draws the whites of every lane of a
    ``CompiledProblem.sample_whites`` call at once: one launch of
    ``csrc/herm_white.cu``, bitwise the lanes' own generators
    (``ops/herm_white.py``). On the CPU the lanes are drawn one by one.

    ``grf_spectral_problem.host_syncs`` counts the blocking device→host
    reads of the build and of ``prob.unpack_field``: the packing weights
    and the pixel field ``prob.x_real``, and an ``x_obs`` tensor twice
    more (three times for a real (n, n) one).
    """
    from ..ops.grf_spectrum import spectrum_quadforms

    def read(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            grf_spectral_problem.host_syncs += 1
        return _host(a)

    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt,
                              device=device)
    s2 = cfg.sigma_noise ** 2
    # ∂log C/∂θ per θ component, tiled over (re, im)
    dlogC = _dlogC(cfg).flatten(1).repeat(1, 2)

    def model_on(cols, grid):
        dlogC2 = dlogC[:, cols]

        def C2(theta):
            """Spectrum per packed coordinate of this rank: C_k tiled over
            (re, im)."""
            return cfg.spectrum(theta).reshape(-1).repeat(2)[cols]

        def grad_theta(xt, ut, theta):
            """Analytic ∂θ log_like at the exact MAP: ½Σ x̃²·∂C/(C+σ²)²,
            every θ component's sum from one ``spectrum_quadforms`` call."""
            C = C2(theta)
            wq = C / (C + s2) ** 2
            g = 0.5 * spectrum_quadforms(xt.reshape((1,) + grid),
                                         (dlogC2 * wq).reshape((-1,)
                                                               + grid))[0]
            return _theta_shaped(g, theta)

        return C2, grad_theta, {}

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    if theta_true is None:
        theta_true = np.zeros(2) if cfg.infer_tilt else 0.0
    return _packed_spectral_problem(
        "grf_spectral_problem", cfg, model_on, log_prior, theta_true,
        noise=noise, solver=solver, x_obs=x_obs, data_seed=data_seed,
        cg_maxiter=cg_maxiter, mesh=mesh, read=read)


trace.declare(grf_spectral_problem, "host_syncs")


def grf_marginal_mle(x_obs, cfg: GrfConfig, theta0=0.0,
                     iters: int = 200) -> Tuple[float, float]:
    """Exact marginal MLE θ̂ and Fisher width(s) for the GRF problem.

    Marginally x̂_k ~ CN(0, n²(C_k(θ)+σ²)) per rfft mode (hermitian
    weights w_k), so with p_k = |x̂_k|²/n² and d_α = ∂C/∂θ_α:
      ∂ nll/∂θ_α = ½ Σ w_k (d_α/(C+σ²)) (1 − p_k/(C+σ²))
      I_αβ       = ½ Σ w_k d_α d_β / (C+σ²)²     (expected Fisher)
    Solved by damped Fisher-scoring Newton in float64 on the host.

    Amplitude-only configs return ``(θ̂, 1/√I)`` as floats; with
    ``cfg.infer_tilt`` the return is ``(θ̂ (2,), Σ (2,2))`` with Σ = I⁻¹.
    Raises ``RuntimeError`` if Fisher scoring has not converged after
    ``iters`` damped steps (e.g. an MLE at the θ→−∞ boundary).
    """
    xf = np.fft.rfft2(np.asarray(_host(x_obs), np.float64))
    p = (np.abs(xf) ** 2) / (cfg.n ** 2)
    w = np.asarray(_host(cfg.herm_weight), np.float64)
    kk = np.asarray(_host(cfg.k), np.float64)
    s2 = cfg.sigma_noise ** 2
    logk = np.log(kk + cfg.k0)
    nth = 2 if cfg.infer_tilt else 1

    th = np.zeros(nth)
    th[:] = np.atleast_1d(np.asarray(theta0, np.float64))[:nth]
    for _ in range(iters):
        gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
        C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
        D = C + s2
        d = np.stack([C, -logk * C][:nth])
        dn = 0.5 * np.einsum("kl,akl->a", w * (1.0 - p / D), d / D)
        I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
        step = -np.linalg.solve(I, dn)
        nrm = np.linalg.norm(step)
        if nrm > 1.0:
            step *= 1.0 / nrm
        th += step
        if nrm < 1e-12:
            break
    else:
        raise RuntimeError(
            f"grf_marginal_mle: Fisher scoring did not converge in "
            f"{iters} iterations (last |step| = {nrm:.3g}, θ = {th}); "
            "the marginal MLE may be at the θ→−∞ boundary (data "
            "consistent with zero signal amplitude).")
    gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
    C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
    D = C + s2
    d = np.stack([C, -logk * C][:nth])
    I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
    if not cfg.infer_tilt:
        return float(th[0]), float(1.0 / np.sqrt(I[0, 0]))
    return th, np.linalg.inv(I)
