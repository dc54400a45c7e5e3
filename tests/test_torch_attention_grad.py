"""Gradients of the port's attention (CPU -> the plain versions of the CUDA
forward and backward kernels, under ``torch.autograd``) against the JAX
package's flash vjp, run in Pallas interpret mode.

Tolerances: f32 on both sides, atol 5e-4 as ``tests/test_ops.py`` holds the
JAX flash gradients to its XLA oracle (the two sum in different orders and
the JAX kernels round q * scale * log2(e) to the operand dtype)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

GRAD_ATOL = 5e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in shapes)


def _jax_grads(q, k, v, layout):
    def loss(q, k, v):
        o = jattn.attention(q, k, v, impl="flash", block_q=128, block_k=128, layout=layout)
        return jnp.sum(o * o)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _torch_grads(q, k, v, layout):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tattn.attention(qt, kt, vt, impl="flash", layout=layout)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    (o * o).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _assert_grads_match(q, k, v, layout, rtol=0.0):
    for got, want in zip(_torch_grads(q, k, v, layout), _jax_grads(q, k, v, layout)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=rtol)


def test_gradients_match_jax():
    """Counterpart of test_ops.py::test_gradients_match_reference."""
    s = (1, 2, 150, 32)
    _assert_grads_match(*_randn(2, s, s, s), "bhnd")


def test_gradients_on_extreme_logits_match_jax():
    """Counterpart of test_gradients_on_extreme_logits_use_stall_fallback_lse:
    a huge key in the last tile; rtol for the planted rows (grads ~1e2)."""
    s = (1, 2, 300, 64)
    q, k, v = _randn(13, s, s, s)
    k[:, :, -1, :] = 40.0
    _assert_grads_match(q, k, v, "bhnd", rtol=1e-5)


def test_bnhd_layout_gradients_match_jax():
    """Counterpart of test_bnhd_layout_gradients_match_reference."""
    s = (1, 150, 2, 32)
    _assert_grads_match(*_randn(7, s, s, s), "bnhd")


@pytest.mark.parametrize("nq,nk,d,layout", [
    (257, 257, 16, "bhnd"),
    (100, 220, 32, "bnhd"),
    (300, 64, 64, "bhnd"),
    (130, 37, 64, "bnhd"),
])
def test_ragged_and_cross_length_gradients_match_jax(nq, nk, d, layout):
    if layout == "bhnd":
        sq, skv = (1, 2, nq, d), (1, 2, nk, d)
    else:
        sq, skv = (1, nq, 2, d), (1, nk, 2, d)
    _assert_grads_match(*_randn(nq * nk + d, sq, skv, skv), layout)


@pytest.mark.parametrize("n_valid", [256, 200])
def test_bwd_reference_matches_flash_bwd_T(n_valid):
    """``flash_attn_bwd_reference`` fed O and LSE directly, against the JAX
    backward ``_flash_bwd_T`` on the same residuals. JAX pads the keys to a
    block multiple and masks those at or past n_valid; the port has no
    padding, so it gets the first n_valid keys, and JAX's gradients of the
    padded keys must be zero."""
    B, H, N, D = 1, 3, 256, 32
    q, k, v, do = _randn(31, *[(B, H, N, D)] * 4)
    k[:, :, n_valid:] = 0.0
    v[:, :, n_valid:] = 0.0
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    kt, vt = kt[:, :, :n_valid], vt[:, :, :n_valid]
    o, lse = tattn.flash_attn_fwd_reference(qt, kt, vt, layout="bhnd", with_lse=True)
    got = tattn.flash_attn_bwd_reference(qt, kt, vt, o, lse, dot, layout="bhnd")

    def bh(x):
        return jnp.asarray(np.asarray(x).reshape(B * H, N, D))

    lse_lanes = jnp.broadcast_to(jnp.asarray(lse.numpy()).reshape(B * H, N, 1),
                                 (B * H, N, jattn._LSE_LANES))
    res = (bh(q), bh(k), bh(v), bh(o.numpy()), lse_lanes, n_valid)
    want = [np.asarray(x).reshape(B, H, N, D)
            for x in jattn._flash_bwd_T(res, bh(do), 128, 128)]
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=GRAD_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w[:, :, :n_valid], atol=GRAD_ATOL)
        np.testing.assert_array_equal(w[:, :, n_valid:], 0.0)


def test_bwd_reference_layouts_agree():
    s = (2, 3, 70, 16)
    q, k, v, do = (torch.from_numpy(x) for x in _randn(5, s, s, s, s))
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    want = tattn.flash_attn_bwd_reference(q, k, v, o, lse, do, layout="bhnd")
    tr = [x.transpose(1, 2) for x in (q, k, v, o, do)]
    got = tattn.flash_attn_bwd_reference(*tr[:4], lse, tr[4], layout="bnhd")
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g.transpose(1, 2), w, atol=0, rtol=0)


def test_autograd_takes_the_backward_wrapper_only_when_needed(monkeypatch):
    calls = []
    real = tattn.flash_attn_bwd

    def counting(*args, **kwargs):
        calls.append(kwargs.get("layout"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attn_bwd", counting)
    x = torch.randn(1, 40, 2, 16)
    # no operand requires grad, or grad disabled: the plain forward call
    assert tattn.attention(x, x, x, layout="bnhd").grad_fn is None
    w = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert tattn.attention(w, x, x, layout="bnhd").grad_fn is None
    # only k requires grad: the Function, whose backward is flash_attn_bwd
    o = tattn.attention(x, w, x, layout="bnhd")
    o.sum().backward()
    assert calls == ["bnhd"] and w.grad is not None and w.grad.abs().sum() > 0
    torch.testing.assert_close(o.detach(), tattn.attention(x, x, x, layout="bnhd"),
                               atol=0, rtol=0)


def test_bwd_rejects_bad_layout():
    x = torch.randn(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        tattn.flash_attn_bwd(x, x, x, x, lse, x, layout="nbhd")
