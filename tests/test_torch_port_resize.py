"""The port's resampling (``qavit_tpu_torch/nn/resize.py``) and
``resize_pos_embed`` against ``jax.image.resize`` and the JAX package's
``resize_pos_embed``, on seed-made inputs.

Tolerance: float32, max|port - JAX| at most 1e-5 of max|JAX| (bicubic:
both build the same float32 weight matrices and the sums run in another
order; bilinear: ``F.interpolate`` computes the same triangle weights in
another order).  bf16: one bf16 ulp of max|JAX| (JAX rounds its weights
and its two contractions to bf16, the port resamples in float32 and
rounds the result, after rounding the bicubic weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qavit_tpu.nn.layers import resize_pos_embed as jax_resize_pos_embed
from qavit_tpu_torch.nn.layers import resize_pos_embed
from qavit_tpu_torch.nn.resize import resize, weight_matrix
from torch_port_common import one_thread  # noqa: F401

REL = 1e-5
BF16_ULP = 2.0 ** -7

CASES = {
    # name: (input shape, output shape, method)
    "bilinear_up_square": ((2, 8, 8, 16), (2, 24, 24, 16), "bilinear"),
    "bilinear_down_square": ((2, 24, 24, 16), (2, 8, 8, 16), "bilinear"),
    "bilinear_up_not_square": ((2, 6, 9, 5), (2, 15, 11, 5), "bilinear"),
    "bilinear_down_not_square": ((2, 16, 12, 5), (2, 7, 5, 5), "bilinear"),
    "bilinear_mixed": ((2, 9, 4, 6), (2, 4, 10, 6), "bilinear"),
    "bicubic_up_square": ((8, 8, 192), (24, 24, 192), "bicubic"),
    "bicubic_down_square": ((24, 24, 32), (8, 8, 32), "bicubic"),
    "bicubic_up_not_square": ((5, 7, 3), (11, 16, 3), "bicubic"),
    "bicubic_down_not_square": ((13, 20, 3), (6, 9, 3), "bicubic"),
    "bicubic_mixed": ((9, 4, 6), (4, 10, 6), "bicubic"),
}


def _input(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_resize_matches_jax(case):
    src, dst, method = CASES[case]
    a = _input(src)
    ref = np.asarray(jax.image.resize(jnp.asarray(a), dst, method=method))
    got = resize(torch.from_numpy(a), dst, method).numpy()
    assert got.shape == ref.shape == dst
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("case", ["bilinear_down_square",
                                  "bicubic_up_square"])
def test_resize_bf16_within_one_ulp(case):
    src, dst, method = CASES[case]
    a = _input(src, seed=1)
    ref = np.asarray(jax.image.resize(jnp.asarray(a, jnp.bfloat16), dst,
                                      method=method).astype(jnp.float32))
    got = resize(torch.from_numpy(a).bfloat16(), dst, method)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= BF16_ULP * np.abs(
        ref).max()


def test_weight_matrix_is_jax_own():
    """Each axis's bicubic matrix equals ``compute_weight_mat``'s: Keys'
    cubic with a = -0.5, the kernel widened when downsampling, columns
    renormalised over the taps inside the input."""
    from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                      compute_weight_mat)
    for m, n in ((8, 24), (24, 8), (7, 3), (3, 7)):
        ref = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                            _fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(weight_matrix(m, n), ref, rtol=0,
                                   atol=1e-6)


def test_interpolate_is_not_jax_bicubic():
    """Why the port builds its own matrices: ``F.interpolate``'s bicubic
    (a = -0.75, clamped borders) misses JAX's by far more than the
    tolerance on the 8 -> 24 position-embedding resize."""
    a = _input((8, 8, 192))
    ref = np.asarray(jax.image.resize(jnp.asarray(a), (24, 24, 192),
                                      method="bicubic"))
    lib = F.interpolate(torch.from_numpy(a).permute(2, 0, 1)[None],
                        size=(24, 24), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(lib - ref).max() > 100 * REL * np.abs(ref).max()


@pytest.mark.parametrize("n, grid", [(64, 24), (64, 8), (576, 8), (49, 7),
                                     (7, 3), (7, 2), (10, 4)])
def test_resize_pos_embed_matches_jax(n, grid):
    """The bicubic resize of a square grid (8 -> 24, the identity, 24 ->
    8) and the repeat / truncate fallback of a grid that is not square."""
    pe = _input((1, n, 12), seed=n)
    ref = np.asarray(jax_resize_pos_embed(jnp.asarray(pe), grid))
    got = resize_pos_embed(torch.from_numpy(pe), grid).numpy()
    assert got.shape == ref.shape == (1, grid * grid, 12)
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
