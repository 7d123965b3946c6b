"""The batched hermitian white draw (``ops/herm_white.py``,
``csrc/herm_white.cu``) and ``CompiledProblem.sample_whites``' use of it.

Tests marked ``cuda`` need a card and ``nvcc`` and skip elsewhere. This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_herm_white.py

The unmarked tests check, on the CPU, the host's mirror of torch's ``randn``
launch, the dispatch and the hook's parts and slices against the per-lane
loop.
"""

import numpy as np
import pytest
import torch

from muse_tpu_torch.models import (bandpower_problem, funnel_problem,
                                   grf_spectral_problem)
from muse_tpu_torch.models.grf import _herm_white_tensors, _herm_whites_hook
from muse_tpu_torch.ops import herm_white as hw
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.theta import ThetaSpec
from muse_tpu_torch.utils import trace
from muse_tpu_torch.utils.keys import lane_generator, sim_seeds

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the H100's SMs and threads per SM
H100 = (132, 2048)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.parametrize("numel,T,S", [
    (1024 * 513, 270336, 1),      # the cells' (n, n//2+1) at n = 1024
    (2048 * 1025, 270336, 2),     # above 4T: two grid-stride steps
    (64 * 33, 2304, 1),           # fewer blocks than the card holds
    (1, 256, 1),
    (4 * 270336, 270336, 1),
    (4 * 270336 + 1, 270336, 2)])
def test_randn_policy_mirrors_torch(numel, T, S):
    assert hw.randn_policy(numel, *H100) == (T, S)


def test_randn_offsets_of_a_lane_at_1024():
    """A lane's four randn calls (two a part) start at Philox offsets
    0, 4, 8, 12 on the H100 at n = 1024, and 0, 8, 16, 24 at n = 2048."""
    for n, offsets in ((1024, (0, 4, 8, 12)), (2048, (0, 8, 16, 24))):
        _, S = hw.randn_policy(n * (n // 2 + 1), *H100)
        assert tuple(4 * S * call for call in range(4)) == offsets


def test_seed_words_are_torchs_uint64_seeds():
    assert hw._seed_word(5) == 5
    assert hw._seed_word(2 ** 63 - 1) == 2 ** 63 - 1
    assert hw._seed_word(2 ** 63) == -2 ** 63
    assert hw._seed_word(2 ** 64 - 1) == -1
    assert hw._seed_word(-1) == -1


def _bitwise(a, b) -> bool:
    """Equal bit for bit: -0 and +0 differ."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _coeffs(n):
    return _herm_white_tensors(n, CPU)


def _loop(seeds, n, part, cols=slice(None)):
    """Part ``part`` of each lane through its own generator, as the models'
    ``sample_white`` draws it."""
    out = []
    for s in seeds:
        gen = lane_generator(s, CPU)
        draws = [hw.herm_white_draw(gen, n, _coeffs(n))
                 for _ in range(part + 1)]
        out.append(draws[part][cols])
    return torch.stack(out)


@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("parts", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("cols", [slice(None), slice(3, 40), slice(50, None)])
def test_plain_draw_equals_the_loop(n, parts, cols):
    seeds = sim_seeds(3, 5)
    before = hw.herm_white_cuda.launches
    got = hw.herm_white_batched(seeds, n, _coeffs(n), parts, cols)
    assert hw.herm_white_cuda.launches == before
    assert len(got) == len(parts)
    for p, w in zip(parts, got):
        assert torch.equal(w, _loop(seeds, n, p, cols))


@pytest.mark.parametrize("parts", [(0,), (0, 1)])
def test_no_seeds_give_empty_parts(parts):
    """A mesh rank that holds no lane of a chunk draws for no seed: one
    (0, count) tensor a part, and no launch."""
    before = hw.herm_white_cuda.launches
    got = hw.herm_white_batched([], 8, _coeffs(8), parts, slice(10, 50))
    assert [tuple(w.shape) for w in got] == [(0, 40)] * len(parts)
    assert hw.herm_white_cuda.launches == before


def test_bad_parts_and_cols_are_refused():
    c = _coeffs(8)
    with pytest.raises(ValueError, match="consecutive"):
        hw.herm_white_batched([1], 8, c, (0, 2))
    with pytest.raises(ValueError, match="consecutive"):
        hw.herm_white_batched([1], 8, c, ())
    with pytest.raises(ValueError, match="step 1"):
        hw.herm_white_batched([1], 8, c, (0,), slice(0, 10, 2))
    with pytest.raises(ValueError, match="step 1"):
        hw.herm_white_batched([1], 8, c, (0,), slice(200, 300))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="card"):
        hw.herm_white_cuda([1], 8, _coeffs(8))


def test_hook_draws_only_the_parts_x_needs():
    """With x_only the hook draws the parts ``x_parts`` names and gives None
    for the rest; the parts it draws are the full draw's."""
    n, seeds, cols = 8, sim_seeds(5, 3), slice(10, 50)
    hook = _herm_whites_hook(n, _coeffs(n), cols, (0,))
    w1, w2 = hook(seeds, x_only=False)
    x1, none = hook(seeds, x_only=True)
    assert none is None and torch.equal(x1, w1)
    assert torch.equal(w1, _loop(seeds, n, 0, cols))
    assert torch.equal(w2, _loop(seeds, n, 1, cols))
    both = _herm_whites_hook(n, _coeffs(n), cols, None)(seeds, x_only=True)
    assert torch.equal(both[0], w1) and torch.equal(both[1], w2)


def _compiled(prob, theta0):
    spec = ThetaSpec.from_example(theta0)
    return CompiledProblem(prob, spec, spec.flatten(theta0))


def _problems():
    """Each model with the hook its build attaches on a card, built here
    for the CPU: (build, θ₀, the hook's x_parts)."""
    return {
        "marginal": (lambda: grf_spectral_problem(
            n=16, sigma_noise=0.1, device=CPU), 0.5, (0,)),
        "direct": (lambda: grf_spectral_problem(
            n=15, sigma_noise=0.1, noise="direct", device=CPU), 0.5, None),
        "bandpower": (lambda: bandpower_problem(
            n=16, nbands=3, sigma_noise=0.1, device=CPU), np.zeros(3),
            None)}


@pytest.mark.parametrize("model", ["marginal", "direct", "bandpower"])
def test_a_cpu_build_keeps_the_loop(model):
    """Only a card's build attaches the hook; on the CPU the problem draws
    its lanes one by one."""
    build, _, _ = _problems()[model]
    assert build().sample_whites_batched is None


@pytest.mark.parametrize("model", ["marginal", "direct", "bandpower"])
@pytest.mark.parametrize("x_only", [False, True])
def test_sample_whites_with_the_hook_equals_the_loop(model, x_only):
    build, theta0, x_parts = _problems()[model]
    prob = build()
    n = prob.grf_config.n
    # the hook a card's build attaches, here on the CPU's plain draw
    prob.sample_whites_batched = _herm_whites_hook(
        n, _coeffs(n), slice(None), x_parts)
    comp = _compiled(prob, theta0)
    seeds = sim_seeds(11, 6)
    c0 = trace.counters()
    W = comp.sample_whites(seeds, x_only=x_only)
    c1 = trace.counters()
    assert c1["sample_whites.batched_lanes"] - \
        c0["sample_whites.batched_lanes"] == len(seeds)
    assert c1["sample_whites.looped_lanes"] == \
        c0["sample_whites.looped_lanes"]
    # the loop the hook replaces, on the same problem
    prob.sample_whites_batched = None
    L = comp.sample_whites(seeds, x_only=x_only)
    assert trace.counters()["sample_whites.looped_lanes"] - \
        c1["sample_whites.looped_lanes"] == len(seeds)
    assert len(W) == len(L) == 2
    for w, v in zip(W, L):
        assert (w is None) == (v is None)
        assert w is None or torch.equal(w, v)
    assert (W[1] is None) == (x_only and model == "marginal")


@pytest.mark.parametrize("build,theta0", [
    (lambda: grf_spectral_problem(n=16, sigma_noise=0.1, noise="fft",
                                  device=CPU), 0.5),
    (lambda: funnel_problem(dim=8, device=CPU), 0.0)])
def test_a_model_without_the_hook_loops(build, theta0):
    prob = build()
    assert prob.sample_whites_batched is None
    comp = _compiled(prob, theta0)
    seeds = sim_seeds(2, 4)
    c0 = trace.counters()
    W = comp.sample_whites(seeds)
    c1 = trace.counters()
    assert c1["sample_whites.looped_lanes"] - \
        c0["sample_whites.looped_lanes"] == len(seeds)
    assert c1["sample_whites.batched_lanes"] == \
        c0["sample_whites.batched_lanes"]
    first = prob.sample_white(lane_generator(seeds[0], CPU))
    assert all(torch.equal(w[0], v) for w, v in zip(W, first))


# ------------------------------------------------------------------ #
# on the card: the kernel bitwise against the per-lane loop
# ------------------------------------------------------------------ #

@pytest.mark.cuda
@pytest.mark.parametrize("n,B,parts,cols", [
    (64, 3, (0, 1), slice(None)), (256, 5, (0,), slice(None)),
    (257, 4, (0, 1), slice(None)), (1024, 1, (0, 1), slice(None)),
    (1024, 9, (0,), slice(None)), (1024, 6, (1,), slice(None)),
    (1024, 5, (0, 1), slice(525312, None)),
    (1024, 5, (0,), slice(262656, 787968)), (2048, 2, (0, 1), slice(None))])
def test_kernel_is_bitwise_the_loop(cuda, n, B, parts, cols):
    coeffs = _herm_white_tensors(n, cuda)
    seeds = sim_seeds(n, B)
    before = hw.herm_white_cuda.launches
    got = hw.herm_white_cuda(seeds, n, coeffs, parts, cols)
    assert hw.herm_white_cuda.launches == before + 1
    want = hw.herm_white_plain(seeds, n, coeffs, parts, cols)
    for g, w in zip(got, want):
        assert _bitwise(g, w)


@pytest.mark.cuda
def test_no_seeds_launch_nothing_on_the_card(cuda):
    coeffs = _herm_white_tensors(64, cuda)
    before = hw.herm_white_cuda.launches
    got = hw.herm_white_batched([], 64, coeffs, (0, 1))
    assert [tuple(w.shape) for w in got] == [(0, 2 * 64 * 33)] * 2
    assert all(w.is_cuda for w in got)
    assert hw.herm_white_cuda.launches == before


@pytest.mark.cuda
def test_sample_whites_runs_the_kernel(cuda):
    prob = grf_spectral_problem(n=256, sigma_noise=0.01, device=cuda)
    comp = _compiled(prob, 0.5)
    seeds = sim_seeds(7, 17)
    before = hw.herm_white_cuda.launches
    W = comp.sample_whites(seeds, x_only=True)
    assert hw.herm_white_cuda.launches == before + 1 and W[1] is None
    loop = torch.stack([prob.sample_white(lane_generator(s, cuda))[0]
                        for s in seeds])
    assert _bitwise(W[0], loop)
