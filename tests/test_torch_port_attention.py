"""The port's attention dispatch and the flash kernel's plain version
(``qavit_tpu_torch/kernels/attention.py``, ``kernels/flash_attention.py``)
against the JAX package's ``kernels/attention.py`` and its Pallas flash
kernel in interpret mode, on the same seed-made inputs, at the 224 path's
shapes: the MSDA attention (196 queries, 80 keys) and the cross attention
(196 queries, 16 bank keys), 4 heads of 48."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.kernels.attention import xla_attention as jax_xla_attention
from qavit_tpu.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from qavit_tpu_torch.kernels import attention as A
from qavit_tpu_torch.kernels import flash_attention as FA
from qavit_tpu_torch.kernels import fused_ref as R
from torch_port_common import assert_close
from torch_port_common import one_thread  # noqa: F401 (autouse)

SHAPES = {"msda": (2, 196, 80, 4, 48), "cross": (2, 196, 16, 4, 48)}


def _inputs(shape, seed=0):
    b, nq, nkv, h, d = shape
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, nq, h, d)).astype(np.float32),
            rs.standard_normal((b, nkv, h, d)).astype(np.float32),
            rs.standard_normal((b, nkv, h, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", list(SHAPES))
def test_xla_attention_matches_jax(which, dtype):
    q, k, v = _inputs(SHAPES[which])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_xla_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)))
    got = A.xla_attention(*(torch.from_numpy(t).to(dtype) for t in (q, k, v)))
    assert got.dtype == dtype
    assert_close(got, want, dtype)


def test_plain_matches_the_pallas_kernel_in_interpret_mode():
    """The kernel's plain version against the TPU kernel itself (Pallas in
    interpret mode on the CPU) at dropout 0, at the 224 MSDA shape."""
    b, nq, nkv, h, d = SHAPES["msda"]
    q, k, v = _inputs(SHAPES["msda"], seed=1)

    def fold(t, n):
        return jnp.asarray(t).transpose(0, 2, 1, 3).reshape(b * h, n, d)

    want = jax_flash_attention(fold(q, nq), fold(k, nkv), fold(v, nkv),
                               interpret=True)
    want = np.asarray(want).reshape(b, h, nq, d).transpose(0, 2, 1, 3)
    got = FA.plain(*(torch.from_numpy(t) for t in (q, k, v)))
    assert_close(got, want)


def test_dropout_mask_is_the_counter_hash():
    """With dropout the plain version drops exactly the probabilities
    whose hashed bits fall below the threshold, and scales the rest."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(SHAPES["cross"], 2))
    rate, salt = 0.25, 77
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                          * FA.scale(q.shape[-1]), -1)
    keep = (R.mask_bits(salt, probs.numel()) >= R.threshold(rate)).reshape(
        probs.shape)
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.where(keep, probs / R.keep_f32(rate), 0.0), v)
    torch.testing.assert_close(FA.plain(q, k, v, rate, salt), want,
                               rtol=1e-5, atol=1e-6)
    assert 0.2 < 1.0 - keep.float().mean().item() < 0.3


def test_use_flash_gate():
    """The ``use_pallas`` gate with the card for the TPU: 196 queries of
    width 48 take the kernel; fewer than 128 queries, a head width below
    32, or any device other than the card do not."""
    assert A.use_flash((64, 196, 4, 48), "cuda")
    assert A.use_flash((64, 128, 4, 32), "cuda")
    assert not A.use_flash((64, 127, 4, 48), "cuda")      # SWA: 49 queries
    assert not A.use_flash((64, 196, 4, 4), "cuda")       # CGA: width 4
    assert not A.use_flash((64, 196, 4, 31), "cuda")
    assert not A.use_flash((64, 196, 4, 48), "cpu")
    assert not A.use_flash((64, 196, 4, 48), "meta")


def test_dispatch_on_the_cpu_is_plain():
    q, k, v = (torch.from_numpy(t) for t in _inputs(SHAPES["msda"], 3))
    before = dict(FA.LAUNCHES)
    want = A.xla_attention(q, k, v)
    for impl in ("auto", "xla", "pallas", "fused_block"):
        torch.testing.assert_close(A.attention(q, k, v, impl=impl), want,
                                   rtol=0, atol=0)
    assert FA.LAUNCHES == before


def test_auto_never_takes_the_kernel_when_training_with_dropout(monkeypatch):
    """Where the gate admits the shape, ``auto`` takes the kernel in eval
    and without dropout, and the plain path in training with dropout."""
    calls = []

    def fake_kernel(q, k, v, rate=0.0, salt=0):
        calls.append(rate)
        return FA.plain(q, k, v, rate, salt)

    monkeypatch.setattr(A, "use_flash", lambda shape, device: True)
    monkeypatch.setattr(FA, "flash_attention", fake_kernel)
    q, k, v = (torch.from_numpy(t) for t in _inputs(SHAPES["cross"], 4))
    A.attention(q, k, v)
    A.attention(q, k, v, dropout_rate=0.1, deterministic=True)
    A.attention(q, k, v, dropout_rate=0.0, deterministic=False)
    assert calls == [0.0, 0.0, 0.0]
    out = A.attention(q, k, v, dropout_rate=0.1, deterministic=False, rng=5)
    assert calls == [0.0, 0.0, 0.0]
    torch.testing.assert_close(out, FA.plain(q, k, v, 0.1, 5), rtol=0,
                               atol=0)


def test_unknown_impl_raises():
    q, k, v = (torch.from_numpy(t) for t in _inputs(SHAPES["cross"], 5))
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError, match="needs rng"):
        A.attention(q, k, v, dropout_rate=0.1, deterministic=False)


def test_pallas_backward_is_the_plain_recompute():
    """The kernel's autograd Function: its gradients are autograd through
    the plain path (the JAX package's XLA-recompute backward); with train
    dropout an explicit ``pallas`` request is forward-only."""
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _inputs(SHAPES["msda"], 6))
    ct = torch.from_numpy(np.random.RandomState(7).standard_normal(
        q.shape).astype(np.float32))
    got = torch.autograd.grad(A.attention(q, k, v, impl="pallas"), (q, k, v),
                              ct)
    want = torch.autograd.grad(A.xla_attention(q, k, v), (q, k, v), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    out = A.attention(q, k, v, dropout_rate=0.1, deterministic=False, rng=8,
                      impl="pallas")
    torch.testing.assert_close(out, FA.plain(q, k, v, 0.1, 8), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="forward-only"):
        out.sum().backward()


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error: on the
    meta device, an error."""
    q = torch.empty(2, 196, 4, 48, device="meta")
    k = torch.empty(2, 80, 4, 48, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        FA.flash_attention(q, k, k)


@pytest.mark.parametrize("bad", ["d", "nkv", "dtype", "heads", "stride"])
def test_launch_refuses_shapes_outside_the_kernel(bad):
    """The launch checks its inputs before it reaches the library."""
    b, nq, nkv, h, d = SHAPES["msda"]
    q, k, v = (torch.zeros(b, nq, h, d), torch.zeros(b, nkv, h, d),
               torch.zeros(b, nkv, h, d))
    if bad == "d":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif bad == "nkv":
        k, v = torch.zeros(b, 145, h, d), torch.zeros(b, 145, h, d)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "heads":
        k, v = k[:, :, :2], v[:, :, :2]
    else:
        q = torch.zeros(b, nq, h, 2 * d)[..., ::2]
    assert FA.input_error(q, k, v) is not None
    with pytest.raises(ValueError, match="flash_attention"):
        FA.launch(None, q, k, v)
    assert FA.input_error(*(torch.zeros(b, n, h, d) for n in (nq, nkv, nkv))
                          ) is None
    # a key set broadcast over the batch (stride 0) is a valid input
    kb = torch.zeros(1, nkv, h, d).expand(b, -1, -1, -1)
    assert FA.input_error(torch.zeros(b, nq, h, d), kb, kb) is None
