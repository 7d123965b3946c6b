"""The lens operator's elementwise passes around the FFTs, for many lanes.

The lensing model's VarPro solve (``models/lensing.py``) evaluates the lens
map at a fixed deflection d = (dx, dy),

    G z̃ = Σ_j D_j · irfft2(S_j · c · unpack(z̃)),

with spectral diagonals S_j ∈ {1, ikx, iky, −kx², −ky², −kx·ky}, pixel
diagonals D_j ∈ {1, dx, dy, ½dx², ½dy², dx·dy}, the real spectral scale c
and the packed-Fourier coordinates z̃ of ``models/grf.py``'s
``_pack_spectrum``, and its exact adjoint
Gᵀw = pack(herm_sym(Σ_j conj(S_j)·c·rfft2(D_j·w))). Four passes, one of
them in two forms, hold every elementwise step of both, so that the FFTs
are the only other work:

  * :func:`lens_expand` (z̃, c) → (B, 6, n, n//2+1) complex: the six
    spectra c·S_j·herm_sym(unpack(z̃)), the ``irfft2`` input of G;
  * :func:`lens_combine` (P, d) → F = Σ_j D_j·P_j;
  * :func:`lens_residual` (P, d, x), combine's residual form: r = x − F
    (or no r, where the caller needs none), Σr² a lane and the deflection
    cotangents (r·∂F/∂dx, r·∂F/∂dy) = (r·(P₁ + dx·P₃ + dy·P₅),
    r·(P₂ + dy·P₄ + dx·P₅)), which is all the reduced gradient needs of the
    six planes;
  * :func:`lens_spread` (W, d) → (B, 6, n, n): D_j·W, the ``rfft2`` input
    of Gᵀ;
  * :func:`lens_contract` (F̂, c) → (B, 2·n·(n//2+1)):
    pack(herm_sym(Σ_j conj(S_j)·c·F̂_j)).

Each dispatches on its input's device: the hand-written kernel
``csrc/lens_planes.cu`` for a CUDA tensor (float32; it launches or the call
raises), the plain version (``*_plain``, any float type) for a CPU one. The
plain versions take the steps of the formulas above in the order
``models/lensing.py``'s ``obs_op`` takes them. Lane b's six planes lie
contiguous at (b·6 + j)·n² (or ·n·(n//2+1) for spectra), its deflection
planes at (b·2 + j)·n². ``lens_*_cuda.launches`` count the launches, one
counter a form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import trace

__all__ = ["k_grids", "herm_sym", "derivative_diagonals", "lens_expand",
           "lens_combine", "lens_residual", "lens_spread", "lens_contract",
           "lens_expand_plain", "lens_combine_plain", "lens_residual_plain",
           "lens_spread_plain", "lens_contract_plain", "lens_expand_cuda",
           "lens_combine_cuda", "lens_residual_cuda", "lens_spread_cuda",
           "lens_contract_cuda"]


def k_grids(n: int, device) -> tuple:
    """(ky (n, 1), kx (1, n//2+1)) in radians per pixel, float32."""
    ky = np.fft.fftfreq(n)[:, None] * 2 * np.pi
    kx = np.fft.rfftfreq(n)[None, :] * 2 * np.pi
    return (torch.tensor(ky, dtype=torch.float32, device=device),
            torch.tensor(kx, dtype=torch.float32, device=device))


def herm_sym(zf: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection of (…, n, n//2+1) half-spectra onto the
    hermitian-consistent ones.

    The rfft2 layout's self-conjugate columns (0 and, for even n, the
    axis-1 Nyquist) store both members of each conjugate pair, so the
    half-spectrum has ~2n redundant coordinates. ``irfft2`` annihilates
    the inconsistent directions on a CPU, but its exact adjoint does not
    land back in the consistent subspace; the off-subspace energy would
    accumulate in the CG iterates and inflate the ½‖z̃‖² prior, corrupting
    the objective and the convergence certificate. Symmetrizing makes the
    redundant directions invisible to the whole operator chain. (The
    projection commutes with the column-constant √w scaling.)"""
    n, nr = zf.shape[-2], zf.shape[-1]

    def sym(col):                     # (…, n): rows r and (n − r) % n
        mirror = torch.conj(torch.roll(col.flip(-1), 1, -1))
        return (0.5 * (col + mirror))[..., None]
    if n % 2 == 0:
        return torch.cat([sym(zf[..., 0]), zf[..., 1:nr - 1],
                          sym(zf[..., nr - 1])], -1)
    return torch.cat([sym(zf[..., 0]), zf[..., 1:]], -1)


def derivative_diagonals(n: int, device) -> torch.Tensor:
    """The (6, n, n//2+1) complex spectral diagonals of (1, ∂x, ∂y, ∂xx,
    ∂yy, ∂xy): {1, ikx, iky, −kx², −ky², −kx·ky}, made hermitian-consistent.

    At the Nyquist frequencies of an even n an odd multiplier (ikx in the
    last column, iky at row n/2 of the self-conjugate columns, kx·ky in the
    last column) turns a consistent spectrum into one that no real field
    has. A CPU ``irfft2`` drops exactly those entries (they become the
    imaginary part of a self-conjugate coefficient), but cuFFT's
    complex-to-real transform is undefined on such input and answers
    differently from one batch width to the next. Projecting the diagonals
    themselves (:func:`herm_sym`) zeroes the entries the CPU transform
    drops, so both devices compute the same real field."""
    ky, kx = k_grids(n, device)
    one = torch.ones((n, n // 2 + 1), device=device)
    zero = torch.zeros_like(one)
    return herm_sym(torch.stack([torch.complex(one, zero),
                                 torch.complex(zero, kx * one),
                                 torch.complex(zero, ky * one),
                                 torch.complex(-(kx ** 2) * one, zero),
                                 torch.complex(-(ky ** 2) * one, zero),
                                 torch.complex(-(kx * ky), zero)]))


@functools.lru_cache(maxsize=None)
def _kernel_tables(n: int, device: torch.device) -> tuple:
    """(kx (n//2+1,), ky (n,)) at n on ``device``, made once a process: the
    kernels form every diagonal and scale from them in registers."""
    ky, kx = k_grids(n, device)
    return kx.reshape(-1).contiguous(), ky.reshape(-1).contiguous()


@functools.lru_cache(maxsize=None)
def _plain_tables(n: int, device: torch.device) -> tuple:
    """(the (6, n, n//2+1) diagonals, the pack scale √w/n (n, n//2+1)) at n
    on ``device``, made once a process at the plain versions' first call
    there (so a card that runs the kernels holds no copy)."""
    w = np.full((n, n // 2 + 1), 2.0)
    w[:, 0] = 1.0
    if n % 2 == 0:
        w[:, -1] = 1.0
    sqw_n = torch.sqrt(torch.tensor(w, dtype=torch.float32,
                                    device=device)) / n
    return derivative_diagonals(n, device), sqw_n


def _grid(c: torch.Tensor) -> tuple:
    """(n, n//2+1) of the spectral scale ``c``."""
    if c.dim() != 2 or c.shape[1] != c.shape[0] // 2 + 1:
        raise ValueError(f"the spectral scale must be (n, n//2+1), got "
                         f"{tuple(c.shape)}")
    return c.shape[0], c.shape[1]


# ---- plain versions -------------------------------------------------- #

def lens_expand_plain(zt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, 2·n·nr) packed z̃ → (B, 6, n, nr): c·S_j·herm_sym(unpack(z̃))."""
    n, nr = _grid(c)
    K6, sqw_n = _plain_tables(n, zt.device)
    re, im = zt.chunk(2, -1)
    zf = torch.complex(re, im).reshape(zt.shape[:-1] + (n, nr)) / sqw_n
    return (c * herm_sym(zf))[..., None, :, :] * K6


def lens_combine_plain(P6: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, 6, n, n) planes, (B, 2, n, n) deflection → F = Σ_j D_j·P_j,
    (B, n, n)."""
    p0, p1, p2, p3, p4, p5 = P6.unbind(-3)
    dx, dy = d.unbind(-3)
    return (p0 + dx * p1 + dy * p2 + (0.5 * dx * dx) * p3
            + (0.5 * dy * dy) * p4 + (dx * dy) * p5)


def lens_residual_plain(P6: torch.Tensor, d: torch.Tensor, x: torch.Tensor,
                        keep_r: bool = True) -> tuple:
    """(r = x − F or None, Σr² a lane, the cotangents (B, 2, n, n))."""
    _, p1, p2, p3, p4, p5 = P6.unbind(-3)
    dx, dy = d.unbind(-3)
    r = x - lens_combine_plain(P6, d)
    return (r if keep_r else None), (r * r).sum((-2, -1)), torch.stack(
        [r * (p1 + dx * p3 + dy * p5), r * (p2 + dy * p4 + dx * p5)], -3)


def lens_spread_plain(W: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, n, n) → (B, 6, n, n): D_j·W."""
    dx, dy = d.unbind(-3)
    return torch.stack([W, dx * W, dy * W, (0.5 * dx * dx) * W,
                        (0.5 * dy * dy) * W, (dx * dy) * W], -3)


def lens_contract_plain(F6: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, 6, n, nr) → (B, 2·n·nr): pack(herm_sym(Σ_j conj(S_j)·c·F̂_j))."""
    n, _ = _grid(c)
    K6, sqw_n = _plain_tables(n, F6.device)
    y = herm_sym(c * (F6 * K6.conj()).sum(-3)) * sqw_n
    return torch.cat([y.real.flatten(-2), y.imag.flatten(-2)], -1)


# ---- the kernels ----------------------------------------------------- #

def _check(name: str, t: torch.Tensor, shape: tuple, dtype, dev) -> None:
    if not (t.is_cuda and t.device == dev):
        raise ValueError(f"{name} must lie on {dev}, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lens_expand_cuda(zt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`lens_expand`: float32 on one card."""
    from .kernels import load_library

    n, nr = _grid(c)
    dev = zt.device
    B = zt.shape[0]
    _check("zt", zt, (B, 2 * n * nr), torch.float32, dev)
    _check("c", c, (n, nr), torch.float32, dev)
    out = torch.empty((B, 6, n, nr), dtype=torch.complex64, device=dev)
    if B == 0:
        return out
    kx, ky = _kernel_tables(n, dev)
    _launched(load_library().muse_lens_expand_f32(
        zt.data_ptr(), c.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        out.data_ptr(), B, n, _stream(dev)), "lens_expand")
    lens_expand_cuda.launches += 1
    return out


def _combine_launch(P6: torch.Tensor, d: torch.Tensor, x, out, A, rr):
    """One launch of the combine kernel: the plain form where ``x`` is
    None, else the residual form (``out`` None: no r)."""
    from .kernels import load_library

    B, n = P6.shape[0], P6.shape[-1]
    lib = load_library()
    partial = None
    if x is not None:
        S = -(-n * n // lib.muse_lens_slab())
        partial = torch.empty((B, S), dtype=torch.float32, device=P6.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _launched(lib.muse_lens_combine_f32(
        P6.data_ptr(), d.data_ptr(), ptr(x), ptr(out), ptr(A), ptr(partial),
        ptr(rr), B, n, _stream(P6.device)), "lens_combine")


def lens_combine_cuda(P6: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`lens_combine`: float32 on one card."""
    dev = P6.device
    B, n = P6.shape[0], P6.shape[-1]
    _check("P6", P6, (B, 6, n, n), torch.float32, dev)
    _check("d", d, (B, 2, n, n), torch.float32, dev)
    out = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    if B > 0:
        _combine_launch(P6, d, None, out, None, None)
        lens_combine_cuda.launches += 1
    return out


def lens_residual_cuda(P6: torch.Tensor, d: torch.Tensor, x: torch.Tensor,
                       keep_r: bool = True) -> tuple:
    """The kernel of :func:`lens_residual`: float32 on one card."""
    dev = P6.device
    B, n = P6.shape[0], P6.shape[-1]
    _check("P6", P6, (B, 6, n, n), torch.float32, dev)
    _check("d", d, (B, 2, n, n), torch.float32, dev)
    _check("x", x, (B, n, n), torch.float32, dev)
    r = (torch.empty((B, n, n), dtype=torch.float32, device=dev)
         if keep_r else None)
    A = torch.empty((B, 2, n, n), dtype=torch.float32, device=dev)
    rr = torch.empty((B,), dtype=torch.float32, device=dev)
    if B > 0:
        _combine_launch(P6, d, x, r, A, rr)
        lens_residual_cuda.launches += 1
    return r, rr, A


def lens_spread_cuda(W: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`lens_spread`: float32 on one card."""
    from .kernels import load_library

    dev = W.device
    B, n = W.shape[0], W.shape[-1]
    _check("W", W, (B, n, n), torch.float32, dev)
    _check("d", d, (B, 2, n, n), torch.float32, dev)
    out = torch.empty((B, 6, n, n), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    _launched(load_library().muse_lens_spread_f32(
        W.data_ptr(), d.data_ptr(), out.data_ptr(), B, n, _stream(dev)),
        "lens_spread")
    lens_spread_cuda.launches += 1
    return out


def lens_contract_cuda(F6: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel of :func:`lens_contract`: float32 on one card."""
    from .kernels import load_library

    n, nr = _grid(c)
    dev = F6.device
    B = F6.shape[0]
    _check("F6", F6, (B, 6, n, nr), torch.complex64, dev)
    _check("c", c, (n, nr), torch.float32, dev)
    out = torch.empty((B, 2 * n * nr), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    kx, ky = _kernel_tables(n, dev)
    _launched(load_library().muse_lens_contract_f32(
        F6.data_ptr(), c.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        out.data_ptr(), B, n, _stream(dev)), "lens_contract")
    lens_contract_cuda.launches += 1
    return out


for _fn in (lens_expand_cuda, lens_combine_cuda, lens_residual_cuda,
            lens_spread_cuda, lens_contract_cuda):
    trace.declare(_fn, "launches")


# ---- the dispatch ---------------------------------------------------- #

def _route(cuda, plain, t: torch.Tensor):
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"the lens planes have no kernel for {t.device}")


def lens_expand(zt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """c·S_j·herm_sym(unpack(z̃)) for the (B, 2·n·(n//2+1)) packed ``zt``
    and the (n, n//2+1) real spectral scale ``c``: (B, 6, n, n//2+1)
    complex."""
    return _route(lens_expand_cuda, lens_expand_plain, zt)(zt, c)


def lens_combine(P6: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Σ_j D_j·P_j of the (B, 6, n, n) planes ``P6`` at the (B, 2, n, n)
    deflection ``d``: (B, n, n)."""
    return _route(lens_combine_cuda, lens_combine_plain, P6)(P6, d)


def lens_residual(P6: torch.Tensor, d: torch.Tensor, x: torch.Tensor,
                  keep_r: bool = True) -> tuple:
    """Combine's residual form against the observation ``x`` (B, n, n):
    (r = x − Σ_j D_j·P_j, or None where not ``keep_r``; Σr² (B,); the
    cotangents (B, 2, n, n))."""
    return _route(lens_residual_cuda, lens_residual_plain, P6)(P6, d, x,
                                                               keep_r)


def lens_spread(W: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """D_j·W of the (B, n, n) ``W`` at the (B, 2, n, n) deflection ``d``:
    (B, 6, n, n)."""
    return _route(lens_spread_cuda, lens_spread_plain, W)(W, d)


def lens_contract(F6: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """pack(herm_sym(Σ_j conj(S_j)·c·F̂_j)) of the (B, 6, n, n//2+1)
    spectra ``F6``: (B, 2·n·(n//2+1))."""
    return _route(lens_contract_cuda, lens_contract_plain, F6)(F6, c)
