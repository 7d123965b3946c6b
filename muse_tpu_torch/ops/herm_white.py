"""The packed hermitian white draw of the spectral GRF models, for many lanes.

A lane's whites are what a fresh ``torch.Generator`` seeded with the lane's
seed gives: each part is two ``torch.randn((n, n//2 + 1))`` calls g and h,
combined by the masks of ``models/grf.py``'s ``_herm_white_coeffs`` into
pack(rfft2(white field)) (:func:`herm_white_draw`). Part p of a lane is the
generator's (p+1)-th such draw.

  * :func:`herm_white_batched` draws the chosen parts of B lanes: the
    hand-written kernel ``csrc/herm_white.cu`` for CUDA tensors (one launch,
    whatever B, bitwise the lanes' own generators: it replays torch's Philox
    stream), and :func:`herm_white_plain`, the per-lane generator loop, for
    CPU tensors. The kernel replaces no TPU kernel: muse_tpu draws its
    whites with ``jax.random`` under ``vmap``.
  * :func:`randn_policy` mirrors, on the host, how torch's CUDA ``randn``
    spreads a call over threads, which the kernel needs to replay it.

A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises.
"""

from __future__ import annotations

import torch

from ..utils.keys import lane_generator

__all__ = ["herm_white_draw", "herm_white_batched", "herm_white_plain",
           "herm_white_cuda", "randn_policy"]

#: threads a block of torch's distribution kernels (``block_size_bound``)
_TORCH_BLOCK = 256


def herm_white_draw(gen: torch.Generator, n: int, coeffs) -> torch.Tensor:
    """One packed (L,) hermitian white from ``gen``, L = 2·n·(n//2+1): two
    normal draws g, h, and re = a·g + b·flip(g), im = c·h + d·flip(h) with
    flip(v)[r] = v[(n − r) mod n] and ``coeffs`` = (a, b, c, d)."""
    a, b, c, d = coeffs
    shape = (n, n // 2 + 1)
    g = torch.randn(shape, generator=gen, device=a.device)
    h = torch.randn(shape, generator=gen, device=a.device)

    def flip(v):                              # r → (n − r) mod n
        return torch.roll(v.flip(0), 1, dims=0)

    re = a * g + b * flip(g)
    im = c * h + d * flip(h)
    return torch.cat([re.reshape(-1), im.reshape(-1)])


def randn_policy(numel: int, sm_count: int, threads_per_sm: int):
    """(T, S): the threads and grid-stride steps of torch's CUDA ``randn`` of
    ``numel`` float32s on a card with ``sm_count`` SMs of
    ``threads_per_sm`` threads (``calc_execution_policy``,
    ATen/native/cuda/DistributionTemplates.h). Thread t draws elements
    s·4T + k·T + t, k = 0..3, from Philox counter s of its subsequence, and
    the call advances the generator's offset by 4·S."""
    if numel < 1:
        raise ValueError(f"numel must be positive, got {numel}")
    grid = min(sm_count * (threads_per_sm // _TORCH_BLOCK),
               -(-numel // _TORCH_BLOCK))
    T = _TORCH_BLOCK * grid
    return T, (numel - 1) // (4 * T) + 1


def _parts_and_cols(n: int, parts, cols):
    """Check ``parts`` (consecutive part indices) and turn ``cols`` (a slice
    of the packed L coordinates) into (start, count)."""
    parts = tuple(int(p) for p in parts)
    if not parts or parts[0] < 0 or \
            parts != tuple(range(parts[0], parts[0] + len(parts))):
        raise ValueError(f"parts must be consecutive indices ≥ 0, got "
                         f"{parts}")
    span = range(2 * n * (n // 2 + 1))[cols]
    if span.step != 1 or len(span) == 0:
        raise ValueError(f"cols must be a non-empty slice of step 1, got "
                         f"{cols}")
    return parts, span.start, len(span)


def herm_white_plain(seeds, n: int, coeffs, parts=(0, 1),
                     cols=slice(None)) -> list:
    """The per-lane loop: for each seed a fresh generator on the
    coefficients' device, its draws up to the last of ``parts``, each cut to
    ``cols``. Returns one (B, count) tensor per part of ``parts``."""
    parts, _, _ = _parts_and_cols(n, parts, cols)
    dev = coeffs[0].device
    lanes = []
    for s in seeds:
        gen = lane_generator(s, dev)
        draws = [herm_white_draw(gen, n, coeffs)
                 for _ in range(parts[-1] + 1)]
        lanes.append([draws[p][cols] for p in parts])
    return [torch.stack(v) for v in zip(*lanes)]


def _seed_word(s) -> int:
    """A seed as the signed 64-bit word that holds torch's uint64 seed
    (``manual_seed`` takes it modulo 2⁶⁴)."""
    v = int(s) % (1 << 64)
    return v - (1 << 64) if v >= 1 << 63 else v


def herm_white_cuda(seeds, n: int, coeffs, parts=(0, 1),
                    cols=slice(None)) -> list:
    """Launch the kernel: every lane of ``seeds`` at once, the coefficient
    planes (a, b, c, d) (n, n//2+1) f32 on one card. Returns one (B, count)
    tensor per part of ``parts``, bitwise :func:`herm_white_plain` on the
    same card. ``herm_white_cuda.launches`` counts the launches."""
    from .kernels import load_library

    parts, start, count = _parts_and_cols(n, parts, cols)
    a = coeffs[0]
    dev = a.device
    nr = n // 2 + 1
    for v in coeffs:
        if not (v.is_cuda and v.device == dev):
            raise ValueError(f"herm_white_cuda takes coefficients on one "
                             f"card, got {[str(w.device) for w in coeffs]}")
        if v.dtype != torch.float32 or tuple(v.shape) != (n, nr) or \
                not v.is_contiguous():
            raise ValueError(f"coefficient planes must be contiguous float32 "
                             f"({n}, {nr}), got {v.dtype} "
                             f"{tuple(v.shape)}")
    B = len(seeds)
    if B == 0:
        raise ValueError("herm_white_cuda needs at least one lane")
    lib = load_library()
    props = torch.cuda.get_device_properties(dev)
    T, S = randn_policy(n * nr, props.multi_processor_count,
                        props.max_threads_per_multi_processor)
    words = torch.tensor([_seed_word(s) for s in seeds], dtype=torch.int64)
    seeds_dev = words.pin_memory().to(dev, non_blocking=True)
    outs = [torch.empty((B, count), dtype=torch.float32, device=dev)
            for _ in parts]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.muse_herm_white_f32(
        seeds_dev.data_ptr(), *(v.data_ptr() for v in coeffs),
        outs[0].data_ptr(), outs[-1].data_ptr(), B, n, T, S, 2 * parts[0],
        2 * len(parts), start, count, stream)
    if rc != 0:
        raise RuntimeError(f"herm_white kernel launch failed: CUDA error "
                           f"{rc}")
    herm_white_cuda.launches += 1
    return outs


herm_white_cuda.launches = 0


def herm_white_batched(seeds, n: int, coeffs, parts=(0, 1),
                       cols=slice(None)) -> list:
    """Parts ``parts`` (consecutive) of the hermitian whites of every lane
    of ``seeds``, cut to the packed coordinates ``cols``: one (B, count)
    tensor per part, on the coefficients' device. The kernel for CUDA
    coefficients, the per-lane loop for CPU ones; both equal, lane by lane,
    what ``herm_white_draw`` gives from each lane's own generator. No seeds
    give (0, count) tensors: a rank of a mesh may hold no lane of a
    chunk."""
    dev = coeffs[0].device
    if len(seeds) == 0:
        parts, _, count = _parts_and_cols(n, parts, cols)
        return [torch.empty((0, count), dtype=torch.float32, device=dev)
                for _ in parts]
    if dev.type == "cuda":
        return herm_white_cuda(seeds, n, coeffs, parts, cols)
    if dev.type == "cpu":
        return herm_white_plain(seeds, n, coeffs, parts, cols)
    raise ValueError(f"herm_white_batched has no kernel for {dev}")
