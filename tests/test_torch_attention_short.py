"""K4 (short-row attention) and K6 (head_dim 128 / f32 attention): their
plain versions against the JAX package's Pallas kernels in interpret mode,
and ``attention()``'s routing against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import _kernels
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def _qkv(seed, sq, skv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(sq, dtype=np.float32).astype(dtype),
            rng.standard_normal(skv, dtype=np.float32).astype(dtype),
            rng.standard_normal(skv, dtype=np.float32).astype(dtype))


# --- K4: mirrors test_ops.py::test_flash_short_{matches_reference,n_valid_mask,bf16}

@pytest.mark.parametrize("nq,nk", [(300, 300), (1374, 1374), (64, 500)])
def test_flash_short_plain_matches_jax_kernel(nq, nk):
    q, k, v = _qkv(nq + nk, (2, nq, 4, 64), (2, nk, 4, 64))
    want = jattn._flash_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nk)
    got = tattn.flash_attn_short(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == (2, nq, 4, 64) and got.is_contiguous()
    # f32 on both sides; the orders of the f32 sums differ
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


def test_flash_short_n_valid_masks_nan_rows_like_jax():
    q, k, v = _qkv(7, (1, 200, 2, 64), (1, 256, 2, 64))
    k[:, 200:] = np.nan  # rows past n_valid may hold anything
    v[:, 200:] = np.nan
    want = jattn._flash_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 200)
    got = tattn.flash_attn_short(*(torch.from_numpy(x) for x in (q, k, v)), n_valid=200)
    sliced = tattn.flash_attn_short(torch.from_numpy(q), torch.from_numpy(k[:, :200]),
                                    torch.from_numpy(v[:, :200]))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), sliced.numpy(), atol=2e-6, rtol=1e-5)


def test_flash_short_bf16_matches_jax_kernel():
    q, k, v = _qkv(9, (2, 300, 4, 64), (2, 300, 4, 64))
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = np.asarray(jattn._flash_short(*bf, 300).astype(jnp.float32))
    got = tattn.flash_attn_short(*(torch.from_numpy(np.array(x.astype(jnp.float32)))
                                   .to(torch.bfloat16) for x in bf))
    # bf16 output: the two round P and O at different points (JAX: unnormalised
    # P to bf16; here the normalised P), one bf16 ulp of |O| <= 2 apart
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_flash_short_rejects_bad_n_valid():
    x = torch.zeros(1, 8, 2, 16)
    for n_valid in (0, 9):
        with pytest.raises(ValueError, match="n_valid"):
            tattn.flash_attn_short(x, x, x, n_valid=n_valid)


# --- K6: mirrors test_ops.py::test_head_dim_128_{matches_reference,extreme_logits}

@pytest.mark.parametrize("n", [256, 300])
def test_d128_plain_matches_jax_kernel(n):
    q, k, v = _qkv(n, (1, 2, n, 128), (1, 2, n, 128))
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash",
                           block_q=128, block_k=128)
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    for wrapper in (tattn.flash_attn_fwd_d128, tattn.flash_attn_fwd_f32):
        o, lse = wrapper(*(torch.from_numpy(x) for x in (q, k, v)), layout="bhnd",
                         with_lse=True)
        torch.testing.assert_close(o, got, atol=0, rtol=0)
        assert lse.shape == (1, 2, n) and lse.dtype == torch.float32


def test_d128_extreme_logits_match_jax_kernel():
    q, k, v = _qkv(10, (1, 2, 300, 128), (1, 2, 300, 128))
    k[:, :, -1, :] = 40.0  # a huge logit jump in the last key block
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash",
                           block_q=128, block_k=128)
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_d128_bnhd_matches_jax_bnhd_route():
    """JAX sends bnhd at D >= 128 through a transpose pair to the same kernel."""
    q, k, v = _qkv(11, (2, 37, 3, 128), (2, 53, 3, 128))
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash",
                           layout="bnhd", block_q=128, block_k=128)
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)), layout="bnhd")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# --- attention() routing

_CASES = [
    # (layout, D, Nk, H, dtype, grad) -> wrapper; "d128" is K6, whose float32
    # entry is flash_attn_fwd_f32
    ("bnhd", 64, 1374, 16, torch.bfloat16, False, "short"),   # VGGT frame / DINOv2 rows
    ("bnhd", 16, 300, 2, torch.bfloat16, False, "short"),
    ("bnhd", 64, 2049, 4, torch.bfloat16, False, "fwd"),      # padded row > 2,048 keys
    ("bnhd", 64, 1374, 64, torch.bfloat16, False, "fwd"),     # K and V row > 16 MB
    ("bhnd", 64, 300, 4, torch.bfloat16, False, "fwd"),       # the short kernel is bnhd only
    ("bnhd", 128, 10, 16, torch.bfloat16, False, "d128"),
    ("bhnd", 128, 300, 2, torch.bfloat16, False, "d128"),
    ("bnhd", 128, 10, 16, torch.float32, False, "d128"),      # the f32 camera head
    ("bnhd", 16, 21, 2, torch.float32, False, "d128"),        # f32 operands at any D
    ("bnhd", 64, 300, 2, torch.float32, True, "autograd"),
    ("bnhd", 64, 300, 2, torch.bfloat16, True, "autograd"),
]


@pytest.mark.parametrize("layout,D,Nk,H,dtype,grad,want", _CASES)
def test_attention_routes_like_the_jax_package(monkeypatch, layout, D, Nk, H, dtype, grad,
                                               want):
    calls = []
    wrappers = {"short": "flash_attn_short", "fwd": "flash_attn_fwd",
                "d128": "flash_attn_fwd_f32" if dtype == torch.float32 else "flash_attn_fwd_d128",
                "autograd": "flash_attn_fwd"}
    for name in ("flash_attn_short", "flash_attn_fwd", "flash_attn_fwd_d128",
                 "flash_attn_fwd_f32"):
        real = getattr(tattn, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, name, spy)
    shape = (1, Nk, H, D) if layout == "bnhd" else (1, H, Nk, D)
    q = torch.randn(shape).to(dtype).requires_grad_(grad)
    o = tattn.attention(q, q.detach(), q.detach(), layout=layout)
    assert o.shape == q.shape
    if want == "autograd":
        assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert calls == [wrappers[want]]
    if want == "short" or (layout == "bnhd" and D < 128 and dtype == torch.bfloat16):
        # the eligibility rule is the JAX package's, constant for constant
        assert tattn.short_eligible(Nk, H, D, 2) == jattn._short_eligible(Nk, H, D, 2)


def test_d128_backward_is_a_later_kernel():
    """The backward at head_dim 128 is a kernel of its own, later than K3:
    K7 (``flash_attn_bwd_d128``), behind K6 with LSE."""
    q = torch.randn(1, 10, 2, 128, requires_grad=True)
    k3, k7 = tattn.flash_attn_bwd.launches, tattn.flash_attn_bwd_d128.launches
    o = tattn.attention(q, q, q, layout="bnhd")
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.sum().backward()
    want = tattn.flash_attn_bwd_d128(
        q.detach(), q.detach(), q.detach(),
        *tattn.flash_attn_fwd_d128(q.detach(), q.detach(), q.detach(), with_lse=True),
        torch.ones_like(o), layout="bnhd")
    torch.testing.assert_close(q.grad, sum(want), atol=0, rtol=0)
    # CPU tensors: the plain versions, no launch counted on either backward
    assert (tattn.flash_attn_bwd.launches, tattn.flash_attn_bwd_d128.launches) == (k3, k7)


@pytest.mark.parametrize("nk,h,d,itemsize", [(1374, 16, 64, 2), (2048, 16, 64, 2),
                                             (2049, 16, 64, 2), (1374, 64, 64, 2),
                                             (1374, 32, 64, 4), (300, 4, 16, 4)])
def test_short_eligibility_equals_jax(nk, h, d, itemsize):
    assert tattn.short_eligible(nk, h, d, itemsize) == jattn._short_eligible(nk, h, d, itemsize)


def test_cpu_tensors_never_reach_the_new_kernels(monkeypatch):
    def boom(name):
        raise AssertionError(f"CUDA kernel {name} requested for CPU tensors")

    monkeypatch.setattr(_kernels, "kernel", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    x = torch.randn(1, 40, 2, 64).to(torch.bfloat16)
    w = torch.randn(1, 10, 2, 128)
    wrappers = (tattn.flash_attn_short, tattn.flash_attn_fwd_d128, tattn.flash_attn_fwd_f32)
    before = [f.launches for f in wrappers]
    assert tattn.attention(x, x, x, layout="bnhd").shape == x.shape
    assert tattn.attention(w, w, w, layout="bnhd").shape == w.shape
    assert tattn.attention(w.bfloat16(), w.bfloat16(), w.bfloat16(), layout="bnhd").shape == w.shape
    assert [f.launches for f in wrappers] == before
    for name in ("flash_attn_short", "flash_attn_fwd_d128", "zbuffer_scatter_min"):
        path = _kernels.library_path(name)
        assert path.parent == _kernels.BUILD_DIR and path.name.startswith(name + "-")
