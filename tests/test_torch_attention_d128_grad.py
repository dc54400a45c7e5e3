"""The attention backward at head_dim 128 (K7): its plain version against the
JAX package's ``_flash_bwd`` (``_dq_kernel`` / ``_dkv_kernel``) in Pallas
interpret mode, ``attention()``'s gradients against ``jax.grad`` through the
flash kernels at D = 128, and the routing of ``attention()`` to K6 and K7.

Tolerances: f32 on both sides, atol 5e-4 as ``tests/test_ops.py`` holds the
JAX flash gradients to its XLA oracle (the two sum in different orders and
the JAX kernels round q * scale * log2(e) to the operand dtype)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import _kernels
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

GRAD_ATOL = 5e-4
D = 128


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


def _shapes(nq, nk, layout, H=2):
    if layout == "bhnd":
        return (1, H, nq, D), (1, H, nk, D), (1, H, nk, D)
    return (1, nq, H, D), (1, nk, H, D), (1, nk, H, D)


@pytest.mark.parametrize("nq,nk,layout", [
    (256, 256, "bhnd"),   # equal lengths, whole blocks
    (150, 150, "bhnd"),   # ragged: padded to the block, keys past n_valid masked
    (100, 220, "bhnd"),   # cross lengths
    (300, 64, "bnhd"),    # cross lengths the other way, projection-natural layout
    (130, 130, "bnhd"),
])
def test_d128_gradients_match_jax(nq, nk, layout):
    q, k, v = _randn(nq * nk, *_shapes(nq, nk, layout))
    for got, want in zip(_torch_grads(q, k, v, layout), _jax_grads(q, k, v, layout)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_d128_gradients_on_extreme_logits_match_jax():
    """A huge key in the last tile; rtol for the planted rows (grads ~1e2)."""
    q, k, v = _randn(13, *_shapes(300, 300, "bhnd"))
    k[:, :, -1, :] = 40.0
    for got, want in zip(_torch_grads(q, k, v, "bhnd"), _jax_grads(q, k, v, "bhnd")):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=1e-5)


@pytest.mark.parametrize("nq,nk_pad,n_valid", [(256, 256, 256), (256, 256, 200), (128, 384, 300)])
def test_bwd_reference_matches_flash_bwd_at_d128(nq, nk_pad, n_valid):
    """``flash_attn_bwd_reference`` (K7's plain version) fed O and LSE
    directly, against the JAX backward ``_flash_bwd`` at D = 128 on the same
    residuals. JAX pads the keys to a block multiple and masks those at or
    past n_valid; the port has no padding, so it gets the first n_valid keys,
    and JAX's gradients of the padded keys must be zero."""
    B, H = 1, 2
    q, do = _randn(31, *[(B, H, nq, D)] * 2)
    k, v = _randn(32, *[(B, H, nk_pad, D)] * 2)
    k[:, :, n_valid:] = 0.0
    v[:, :, n_valid:] = 0.0
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    kt, vt = kt[:, :, :n_valid], vt[:, :, :n_valid]
    o, lse = tattn.flash_attn_fwd_d128(qt, kt, vt, layout="bhnd", with_lse=True)
    got = tattn.flash_attn_bwd_d128(qt, kt, vt, o, lse, dot, layout="bhnd")

    def bh(x):
        x = np.asarray(x)
        return jnp.asarray(x.reshape(B * H, x.shape[2], D))

    lse_lanes = jnp.broadcast_to(jnp.asarray(lse.numpy()).reshape(B * H, nq, 1),
                                 (B * H, nq, jattn._LSE_LANES))
    res = (bh(q), bh(k), bh(v), bh(o.numpy()), lse_lanes, n_valid)
    dq, dk, dv = (np.asarray(x) for x in jattn._flash_bwd(res, bh(do), 128, 128))
    np.testing.assert_allclose(got[0].numpy(), dq.reshape(B, H, nq, D), atol=GRAD_ATOL)
    for g, w in zip(got[1:], (dk, dv)):
        w = w.reshape(B, H, nk_pad, D)
        np.testing.assert_allclose(g.numpy(), w[:, :, :n_valid], atol=GRAD_ATOL)
        np.testing.assert_array_equal(w[:, :, n_valid:], 0.0)


def test_bwd_d128_layouts_agree():
    sq, skv = (2, 3, 70, D), (2, 3, 45, D)
    q, k, v, do = (torch.from_numpy(x) for x in _randn(5, sq, skv, skv, sq))
    o, lse = tattn.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
    want = tattn.flash_attn_bwd_d128(q, k, v, o, lse, do, layout="bhnd")
    tr = [x.transpose(1, 2) for x in (q, k, v, o, do)]
    got = tattn.flash_attn_bwd_d128(*tr[:4], lse, tr[4], layout="bnhd")
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g.transpose(1, 2), w, atol=0, rtol=0)


def _spy(monkeypatch, calls):
    for name in ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_fwd_d128",
                 "flash_attn_bwd_d128", "flash_attn_fwd_f32", "flash_attn_short"):
        real = getattr(tattn, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, bool(kw.get("with_lse", False))))
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, name, spy)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_with_grad_at_d128_takes_k6_with_lse_then_k7(monkeypatch, layout, dtype):
    calls = []
    _spy(monkeypatch, calls)
    shape = (1, 2, 40, D) if layout == "bhnd" else (1, 40, 2, D)
    x = torch.randn(shape).to(dtype)
    w = x.clone().requires_grad_(True)
    o = tattn.attention(x, w, x, layout=layout)  # only k requires grad
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert calls == [("flash_attn_fwd_d128", True)]
    o.float().sum().backward()
    assert calls == [("flash_attn_fwd_d128", True), ("flash_attn_bwd_d128", False)]
    assert w.grad is not None and w.grad.shape == w.shape and w.grad.abs().sum() > 0


def test_attention_without_grad_at_d128_takes_k6_only(monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    x = torch.randn(1, 2, 40, D).to(torch.bfloat16)
    w = x.clone().requires_grad_(True)
    assert tattn.attention(x, x, x).grad_fn is None
    with torch.no_grad():
        assert tattn.attention(w, x, x).grad_fn is None
    assert calls == [("flash_attn_fwd_d128", False)] * 2


def test_attention_with_grad_below_d128_is_unchanged(monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    x = torch.randn(1, 40, 2, 64, requires_grad=True)
    tattn.attention(x, x, x, layout="bnhd").sum().backward()
    assert calls == [("flash_attn_fwd", True), ("flash_attn_bwd", False)]


def test_bwd_d128_rejects_bad_layout_and_stays_off_the_kernel_on_cpu(monkeypatch):
    def boom(name):
        raise AssertionError(f"CUDA kernel {name} requested for CPU tensors")

    monkeypatch.setattr(_kernels, "kernel", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    x = torch.randn(1, 2, 8, D)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        tattn.flash_attn_bwd_d128(x, x, x, x, lse, x, layout="nbhd")
    before = tattn.flash_attn_bwd_d128.launches
    grads = tattn.flash_attn_bwd_d128(x, x, x, x, lse, x, layout="bhnd")
    assert [g.shape for g in grads] == [x.shape] * 3
    assert tattn.flash_attn_bwd_d128.launches == before


def test_k7_is_registered_with_k3s_c_interface():
    source, symbol, argtypes = _kernels._SIGNATURES["flash_attn_bwd_d128"]
    assert source == "flash_attn_bwd_d128" and symbol == "videogpa_flash_attn_bwd_d128"
    assert argtypes == _kernels._SIGNATURES["flash_attn_bwd"][2]
    assert _kernels.SOURCES[source].name == "flash_attn_bwd_d128.cu"
    assert _kernels.SOURCES[source].exists()
    assert symbol in _kernels.SOURCES[source].read_text()
    path = _kernels.library_path(source)
    assert path.parent == _kernels.BUILD_DIR and path.name.startswith(source + "-")
