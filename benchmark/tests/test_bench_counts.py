"""The counting functions against counts made by hand at small shapes."""

from benchmark.counts import grf_spectral as counts


def test_packed_length():
    assert counts.packed_length({"n": 8}) == 2 * 8 * 5
    assert counts.packed_length({"n": 1024}) == 1050624


def test_step_by_hand():
    # 3 lanes of n = 4: L = 2·4·3 = 24 coordinates a lane, 72 in all.
    # With 2 PCG steps: whites → x (2 vectors), the start (4), two steps of
    # 8, the score (1) = 23 vectors of 4 bytes; operations 1 + 7 + 28 + 3.
    nbytes, ops = counts.step({"n": 4}, lanes=3, cg_steps=2)
    assert nbytes == 4 * 72 * 23
    assert ops == 72 * 39
    # no PCG step: 7 vectors, 1 + 7 + 3 operations
    assert counts.step({"n": 4}, 3, 0) == (4 * 72 * 7, 72 * 11)


def test_kernel_bytes_by_hand():
    # the fused kernel at B=2, (n, 2m) = (4, 6): z 48 floats in, the
    # half-gradient 48 out, w 24 in, 2 values out
    assert counts.kernel_bytes("quadform_and_grad", (2, 4, 6)) == \
        4 * (48 + 48 + 24 + 2)
    # the quadforms at B=2, K=3: z 48 in, 3 weights of 24 in, 6 values out
    assert counts.kernel_bytes("quadforms", (2, 3, 4, 6)) == \
        4 * (48 + 72 + 6)
    # the repo's kernel table: B=101 × 1024², K = 1 is bound at 0.1280 ms
    # and B=128 fused at 0.3224 ms on 3.35 TB/s
    L = 1024 * 1026
    assert abs(counts.kernel_bytes("quadforms", (101, 1, 1024, 1026))
               / 3.35e12 * 1e3 - 0.1280) < 5e-4
    assert abs(counts.kernel_bytes("quadform_and_grad", (128, 1024, 1026))
               / 3.35e12 * 1e3 - 0.3224) < 5e-4
    assert L == 1050624


def test_launch_shapes():
    import torch
    z = torch.zeros(5, 4, 6)
    assert counts.launch_shape("spectrum_quadform_and_grad_cuda",
                               (z, torch.zeros(4, 6))) == (5, 4, 6)
    assert counts.launch_shape("spectrum_quadforms_cuda",
                               (z, torch.zeros(2, 4, 6))) == (5, 2, 4, 6)
    assert counts.launch_shape("spectrum_quadform_cuda",
                               (z, torch.zeros(4, 6))) == (5, 1, 4, 6)
