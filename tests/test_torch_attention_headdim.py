"""``attention()`` at head dims no kernel takes (8, 40, 80, 96).

On CUDA the port zero-pads D to the next kernel width (16, 32, 64, 128),
passes the original D's softmax scale to the kernel and slices O back
(``ops/attention.py::_attention_padded``). Here on the CPU the padded route
runs with the kernels' plain versions and is held against the JAX
``attention(impl="xla")`` at the original D, forward and gradients, f32 and
bf16; the unpadded CPU route too. On ``meta`` operands, with the C entry
points recorded, the padded route launches the kernel of the padded width
with the original D's scale and hands back O and the gradients at D.

Tolerances: f32, atol 1e-5 (forward) and 5e-5 (gradients): the same
formulas summed in another order; bf16, atol and rtol 2e-2: one bf16 ulp of
O (2^-7) on both sides plus the order of the f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

HEAD_DIMS = (8, 40, 80, 96)
TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in shapes)


def _shapes(layout, B, Nq, Nk, H, D):
    if layout == "bnhd":
        return (B, Nq, H, D), (B, Nk, H, D)
    return (B, H, Nq, D), (B, H, Nk, D)


def _jax_attention(q, k, v, layout, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jattn.attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), impl="xla",
                           layout=layout)


def _port(route):
    if route == "padded":
        return lambda q, k, v, layout: tattn._attention_padded(q, k, v, "flash", layout)
    return lambda q, k, v, layout: tattn.attention(q, k, v, impl="flash", layout=layout)


@pytest.mark.parametrize("route", ["padded", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_forward_matches_jax_at_any_head_dim(D, dtype, route):
    layout = "bnhd" if D in (8, 80) else "bhnd"
    sq, sk = _shapes(layout, 1, 70, 90, 2, D)
    q, k, v = _randn(D, sq, sk, sk)
    got = _port(route)(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), layout)
    want = np.asarray(_jax_attention(q, k, v, layout, dtype).astype(jnp.float32))
    assert got.shape == sq and got.dtype == dtype
    atol = TOL[dtype][0]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=0 if dtype == torch.float32 else atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_gradients_through_the_padded_route_match_jax(D, dtype):
    layout = "bnhd" if D in (40, 96) else "bhnd"
    sq, sk = _shapes(layout, 1, 60, 75, 2, D)
    q, k, v = _randn(100 + D, sq, sk, sk)
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    o = tattn._attention_padded(*ts, "flash", layout)
    assert o.shape == sq and type(o.grad_fn).__name__ == "SliceBackward0"
    (o.float() * o.float()).sum().backward()

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(q, k, v):
        out = jattn.attention(q, k, v, impl="xla", layout=layout).astype(jnp.float32)
        return jnp.sum(out * out)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    atol = TOL[dtype][1]
    for t, w in zip(ts, want):
        assert t.grad.shape == t.shape
        w = np.asarray(jnp.asarray(w, jnp.float32))
        scale = 1.0 if dtype == torch.float32 else max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=atol * scale,
                                   rtol=0 if dtype == torch.float32 else atol)


@pytest.mark.parametrize("D", [40, 80])
def test_int8_padded_route_equals_the_unpadded_int8_function(D):
    """Zero columns add nothing to the integer scores, leave each row's
    absolute max and K's mean alone: q8, k8's live columns, the scales and
    so O are the same bits. D = 40 pads to K8's width 64, D = 80 to 128
    (K9's entry, the same kernel body)."""
    sq, _ = _shapes("bhnd", 2, 300, 300, 2, D)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _randn(7 + D, sq, sq, sq))
    got = tattn._attention_padded(q, k, v, "flash_int8", "bhnd")
    want = tattn.attention(q, k, v, impl="flash_int8", layout="bhnd")
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # and that function is the JAX int8 route's up to its quantisation
    exact = np.asarray(_jax_attention(*(x.float().numpy() for x in (q, k, v)), "bhnd",
                                      torch.float32))
    np.testing.assert_allclose(got.float().numpy(), exact, atol=5e-2)


def test_padded_head_dim():
    assert [tattn.padded_head_dim(d) for d in (1, 8, 16, 17, 40, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 64, 64, 128, 128, 128]
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        tattn.padded_head_dim(129)


# ---- the card's route on meta operands, the C entry points recorded ----

@pytest.fixture
def card_route(monkeypatch):
    """Meta tensors take the wrappers' kernel route; each launch records its
    entry point and arguments."""
    calls = []
    monkeypatch.setattr(tattn, "_on_card", lambda x: x.device.type == "meta")
    monkeypatch.setattr(tattn, "_call",
                        lambda fn_name, entry, device, *args: calls.append((entry, args)))
    return calls


def _scale_arg(arg):
    return arg.value if hasattr(arg, "value") else arg


def _meta(shape, dtype, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("D,dtype,layout,fwd,bwd", [
    (8, torch.bfloat16, "bhnd", "flash_attn_fwd", "flash_attn_bwd"),
    (40, torch.bfloat16, "bnhd", "flash_attn_fwd", "flash_attn_bwd"),
    (80, torch.bfloat16, "bnhd", "flash_attn_fwd_d128_bf16", "flash_attn_bwd_d128"),
    (96, torch.float32, "bhnd", "flash_attn_fwd_f32", "flash_attn_bwd_f32"),
    (40, torch.float32, "bnhd", "flash_attn_fwd_f32", "flash_attn_bwd_f32"),
])
def test_padded_launch_passes_the_original_scale_and_slices_back(card_route, D, dtype,
                                                                  layout, fwd, bwd):
    shape = (2, 3000, 4, D) if layout == "bnhd" else (2, 4, 3000, D)
    q, k, v = (_meta(shape, dtype, grad=True) for _ in range(3))
    o = tattn.attention(q, k, v, impl="flash", layout=layout)
    assert o.shape == shape and o.dtype == dtype
    o.sum().backward()
    for x in (q, k, v):
        assert x.grad.shape == shape
    (e_fwd, a_fwd), (e_bwd, a_bwd) = card_route
    assert (e_fwd, e_bwd) == (fwd, bwd)
    width = tattn.padded_head_dim(D)
    # the forward entries take scale * log2(e) as an f32, the backward ones the scale
    assert _scale_arg(a_fwd[-1]) == pytest.approx(D ** -0.5 * tattn._LOG2E, rel=1e-7)
    assert _scale_arg(a_bwd[-1]) == pytest.approx(D ** -0.5, rel=1e-7)
    # pointers q, k, v, o, lse, then B, H, Nq, Nk and the padded D
    assert _scale_arg(a_fwd[9]) == width


@pytest.mark.parametrize("D,entry", [(8, "flash_attn_short"), (40, "flash_attn_fwd"),
                                     (96, "flash_attn_fwd_d128_bf16")])
def test_inference_route_reads_the_padded_width(card_route, D, entry):
    """Short VGGT-like rows of 1,374 keys go to K4 at widths < 128; long rows
    to K1; D 65-128 to K6."""
    n = 1374 if entry == "flash_attn_short" else 5000
    q = _meta((4, n, 16, D), torch.bfloat16)
    o = tattn.attention(q, q, q, layout="bnhd")
    assert o.shape == q.shape
    [(got, args)] = card_route
    assert got == entry
    assert _scale_arg(args[-1]) == pytest.approx(D ** -0.5 * tattn._LOG2E, rel=1e-7)


@pytest.mark.parametrize("D,entry", [(40, "flash_attn_int8"), (80, "flash_attn_int8_d128")])
def test_int8_route_pads_after_choosing_int8_by_the_original_head_dim(card_route, D, entry):
    q = _meta((2, 5000, 8, D), torch.bfloat16)
    o = tattn.attention(q, q, q, impl="flash_int8", layout="bnhd")
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert [e for e, _ in card_route] == [entry]


def test_head_dim_above_128_raises_on_the_card_route(card_route):
    q = _meta((1, 64, 2, 160), torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        tattn.attention(q, q, q, layout="bnhd")
    f = _meta((1, 5000, 2, 40), torch.float32)  # long rows: the int8 route
    with pytest.raises(NotImplementedError, match="bf16 operands"):
        tattn.attention(f, f, f, impl="flash_int8", layout="bnhd")
    assert card_route == []
