"""``attention()`` at head dims no kernel takes (8, 40, 80, 96), and above
128 (160, 256).

On CUDA the port zero-pads D to the next kernel width (16, 32, 64, 128, then
every multiple of 64), passes the original D's softmax scale to the kernel
and slices O back (``ops/attention.py::_attention_padded``). Here on the CPU
the padded route runs with the kernels' plain versions and is held against
the JAX ``attention(impl="xla")`` at the original D, forward and gradients,
f32 and bf16; the unpadded CPU route too; above 128 also against the JAX
``attention(impl="flash")`` vjp in Pallas interpret mode, with a plain
emulation of the wide forward's tiling (slices of O, S summed over 64-column
chunks once a key tile for each slice, P rounded to the operands' dtype: the
wide entries' slices of up to 256 columns, and 64-column slices) against the
JAX ``_flash_fwd``; ``tests/test_torch_attention_wide.py`` holds the wide
entries' tilings at more head dims. The int8 route with f32
operands (``flash_attn_int8_f32``'s plain version, and an emulation of its
tiling: integer S over k-steps of 32 bytes, 64-key tiles, P V key by key in
the register tile) is held against the JAX ``attention(impl="flash_int8")``
in interpret mode, the emulation also at head dims 16-128 against its kernel
and with S bit for bit against the plain version's scores. On ``meta``
operands, with the C entry points recorded, the padded route launches the
kernel of the padded width with the original D's scale and hands back O and
the gradients at D; above 128 and for f32 int8 it launches the new entries.

Tolerances: f32, atol 1e-5 (forward) and 5e-5 (gradients): the same
formulas summed in another order; bf16, atol and rtol 2e-2: one bf16 ulp of
O (2^-7) on both sides plus the order of the f32 sums; the int8 route in
f32, atol 2e-5 on JAX's own quantised operands, as
``tests/test_torch_attention_int8.py`` holds K8's plain version to it (the
emulated tiling, 1e-5).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

HEAD_DIMS = (8, 40, 80, 96, 160, 256)
TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}
# the whole int8 route in f32 against JAX's: each side quantises, and K's
# mean sums in another order, so an entry a tie apart rounds one step off
# (< 0.1 % of them, ``test_quantize_qk_int8_matches_jax``); one such step
# moves O by up to ~1e-3 of its scale
INT8_F32_ATOL = 1e-3
# XLA without its costly LLVM passes, for the jitted JAX references (as
# tests/test_torch_vggt_track.py compiles them)
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}
# keys a tile of ``flash_attn_int8_f32`` (csrc/flash_attn_int8_f32.cu)
INT8_F32_BLOCK = int(re.search(
    r"constexpr int kBlockN = (\d+);",
    (Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_attn_int8_f32.cu").read_text()
).group(1))


@pytest.fixture
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


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
    layout = "bnhd" if D in (8, 80, 160) else "bhnd"
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
    layout = "bnhd" if D in (40, 96, 256) else "bhnd"
    sq, sk = _shapes(layout, 1, 60, 75, 2, D)
    q, k, v = _randn(100 + D, sq, sk, sk)
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    o = tattn._attention_padded(*ts, "flash", layout)
    # a width no kernel takes is sliced back; 256 is a width of its own
    sliced = tattn.padded_head_dim(D) != D
    assert o.shape == sq and type(o.grad_fn).__name__ == (
        "SliceBackward0" if sliced else "_FlashAttentionBackward")
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
    """Every head dim has a width: 16, 32, 64, 128, then the next multiple of
    64, which the wide entries take."""
    dims = (1, 8, 16, 17, 40, 64, 65, 96, 128, 129, 160, 192, 200, 256, 512, 513)
    assert [tattn.padded_head_dim(d) for d in dims] == [
        16, 16, 16, 32, 64, 64, 128, 128, 128, 192, 192, 192, 256, 256, 512, 576]
    for d in range(1, 1100):
        w = tattn.padded_head_dim(d)
        assert w >= d and (w in tattn.HEAD_DIM_WIDTHS or w in tattn.WIDE_HEAD_DIMS)
        assert (w in tattn.WIDE_HEAD_DIMS) == (d > 128)


def _jax_flash_vjp(q, k, v, do, layout, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    o, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, impl="flash", block_q=128,
                                                     block_k=128, layout=layout),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (o, *grads)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [160, 256])
def test_wide_head_dims_match_the_jax_flash_vjp(interpret_mode, D, dtype):
    """Above 128 the JAX package runs ``_fwd_kernel`` and ``_dq_kernel`` /
    ``_dkv_kernel`` at any D (the ones-column at D % 128 != 0); the port's
    padded route (160 -> 192) with the wide entries' plain versions gives
    the same O and gradients."""
    layout = "bhnd" if D == 160 else "bnhd"
    sq, sk = _shapes(layout, 1, 70, 90, 2, D)
    q, k, v, do = _randn(300 + D, sq, sk, sk, sq)
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    o = tattn._attention_padded(*ts, "flash", layout)
    o.backward(torch.from_numpy(do).to(dtype))
    want_o, *want_g = _jax_flash_vjp(q, k, v, do, layout, dtype)
    atol_o, atol_g = TOL[dtype]
    rtol = 0 if dtype == torch.float32 else atol_o
    np.testing.assert_allclose(o.detach().float().numpy(), want_o, atol=atol_o, rtol=rtol)
    for t, w in zip(ts, want_g):
        scale = 1.0 if dtype == torch.float32 else max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=atol_g * scale, rtol=rtol)


def _wide_fwd_emulated(q, k, v, scale, dtype, slice_cols=64):
    """A wide forward's tiling on (B, H, N, D) f32 images of operands of
    ``dtype``: one CTA a (64-query tile, slice of ``slice_cols`` columns of
    O, the last one possibly narrower), S summed over 64-column chunks of Q
    and K once for each 64-key tile, an online softmax in the log2 domain, P
    rounded to ``dtype`` before P V, the row sum of the unrounded P. The wide
    entries cut O into slices of up to 256 columns."""
    block = 64
    Nq, Nk, D = q.shape[2], k.shape[2], q.shape[3]
    o = torch.zeros_like(q)
    for q0 in range(0, Nq, block):
        qt = q[:, :, q0:q0 + block]
        for c0 in range(0, D, slice_cols):  # one CTA a slice of O's columns
            c1 = min(c0 + slice_cols, D)
            m = torch.full(qt.shape[:3] + (1,), -float("inf"))
            l = torch.zeros_like(m)
            acc = torch.zeros(qt.shape[:3] + (c1 - c0,))
            for k0 in range(0, Nk, block):
                s = torch.zeros(qt.shape[:3] + (min(block, Nk - k0),))
                for d0 in range(0, D, block):  # chunks of the contraction
                    s = s + qt[..., d0:d0 + block] @ k[:, :, k0:k0 + block, d0:d0 + block].mT
                s = s * (scale * tattn._LOG2E)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(dtype).float() @ v[:, :, k0:k0 + block, c0:c1]
                m = m_new
            o[:, :, q0:q0 + block, c0:c1] = acc / l
    return o.to(dtype)


@pytest.mark.parametrize("slice_cols", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_forward_tiling_matches_jax_flash_fwd(interpret_mode, dtype, slice_cols):
    """The emulated tiling at D = 256, ragged in both lengths, with 64-column
    slices of O and with the wide entries' one slice of 256 (S once a key
    tile), against the JAX ``_flash_fwd`` (``_fwd_kernel`` in interpret
    mode) and the plain version."""
    D, jdt = 256, (jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    q, k, v = _randn(17, (1, 2, 100, D), (1, 2, 70, D), (1, 2, 70, D))
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = _wide_fwd_emulated(tq.float(), tk.float(), tv.float(), D ** -0.5, dtype, slice_cols)
    pad = lambda x, n: np.pad(x.reshape(2, -1, D), ((0, 0), (0, n - x.shape[2]), (0, 0)))  # noqa: E731
    want, _ = jattn._flash_fwd(jnp.asarray(pad(q, 128), jdt), jnp.asarray(pad(k, 128), jdt),
                               jnp.asarray(pad(v, 128), jdt), 70, 128, 128, with_lse=False)
    want = np.asarray(jnp.asarray(want, jnp.float32))[:, :100].reshape(1, 2, 100, D)
    atol = TOL[dtype][0]
    rtol = 0 if dtype == torch.float32 else atol
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)
    plain = tattn.flash_attn_fwd_wide(tq, tk, tv, layout="bhnd")[0]  # CPU: plain version
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=atol, rtol=rtol)


def _int8_f32_emulated(q8, sq, k8, sk, v):
    """``flash_attn_int8_f32``'s tiling on (B, H, N, D) operands: for each
    key tile (``INT8_F32_BLOCK`` keys, read from the source) the integer
    scores summed over k-steps of 32 bytes (exact, as the s8 wgmma sums
    them), S = (s * sq) * sk, the base-2 online softmax, O rescaled and then
    P V accumulated key by key into each thread's 8-query register tile (an
    f32 FMA chain: emulated in f64, rounded once a key), O / l. Returns (O,
    S), S over all keys."""
    m = torch.full(q8.shape[:3] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q8.shape[:3] + (v.shape[-1],))
    scores = []
    for k0 in range(0, k8.shape[2], INT8_F32_BLOCK):
        kt = k8[:, :, k0:k0 + INT8_F32_BLOCK].double()
        si = sum(q8[..., d:d + 32].double() @ kt[..., d:d + 32].mT
                 for d in range(0, q8.shape[-1], 32))
        s = si.float() * sq[..., None] * sk[:, :, None, k0:k0 + INT8_F32_BLOCK]
        scores.append(s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for kk in range(p.shape[-1]):
            acc = (acc.double() + p[..., kk:kk + 1].double()
                   * v[:, :, k0 + kk, None, :].double()).float()
        m = m_new
    return acc / l, torch.cat(scores, -1)


@pytest.mark.parametrize("D,Nq,Nk", [(40, 333, 200), (64, 130, 517)])
def test_int8_f32_route_matches_jax_flash_int8(interpret_mode, D, Nq, Nk):
    """The int8 route with f32 operands (``_fwd_kernel_T8`` on f32, which
    keeps P in f32). ``_flash_int8`` quantises inside, so on JAX's own q8, sq,
    k8, sk the plain version of ``flash_attn_int8_f32`` and the emulation of
    its online softmax match it within f32 summation order and exp2 (atol
    2e-5, as ``tests/test_torch_attention_int8.py`` holds K8's plain version
    to it); the port's padded route (40 -> 64 zero columns, D's scale) gives
    the unpadded int8 function within 1e-6, and JAX's whole route within
    ``INT8_F32_ATOL`` (the two quantisers may round a K entry a tie apart)."""
    B, H = 1, 2
    q, k, v = _randn(40 + D, (B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D))
    k = k + 0.5
    jq, jk, jv = (jnp.asarray(x).reshape(B * H, -1, D) for x in (q, k, v))
    bq, bk, Nq_p, Nk_p = jattn._block_geometry(Nq, Nk, 128, 128, D)
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0)))  # noqa: E731
    want = np.asarray(jattn._flash_int8(pad(jq, Nq_p), pad(jk, Nk_p), pad(jv, Nk_p), Nk, bq, bk)
                      )[:, :Nq].reshape(B, H, Nq, D)
    # the operands ``_flash_int8`` quantises: padded to whole blocks (K's mean
    # sums the zero rows too, so its last bits follow the padding)
    q8, sq, k8, sk = (torch.from_numpy(np.array(x)) for x in jattn._quantize_qk_int8(
        pad(jq, Nq_p), pad(jk, Nk_p), Nk))
    ops = (q8[:, :Nq].reshape(B, H, Nq, D), sq[:, :Nq].reshape(B, H, Nq),
           k8[:, :Nk].reshape(B, H, Nk, D), sk[:, :Nk].reshape(B, H, Nk))
    tv = torch.from_numpy(v)
    plain = tattn.flash_attn_int8_f32(*ops, tv, layout="bhnd")  # CPU: the plain version
    emulated = _int8_f32_emulated(*ops, tv)[0]
    assert plain.dtype == torch.float32 and plain.shape == (B, H, Nq, D)
    for got in (plain, emulated):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    unpadded = tattn.flash_attn_int8_f32(*tattn.quantize_qk_int8(tq, tk, "bhnd"), tv,
                                         layout="bhnd")
    padded = tattn._attention_padded(tq, tk, tv, "flash_int8", "bhnd")
    np.testing.assert_allclose(padded.numpy(), unpadded.numpy(), atol=1e-6)
    route = np.asarray(jattn.attention(*(jnp.asarray(x) for x in (q, k, v)), impl="flash_int8",
                                       block_q=128, block_k=128))
    np.testing.assert_allclose(padded.numpy(), route, atol=INT8_F32_ATOL)


@pytest.mark.parametrize("D,Nq,Nk,layout", [(16, 150, 200, "bnhd"), (32, 70, 130, "bhnd"),
                                          (64, 130, 190, "bnhd"), (128, 100, 140, "bhnd")])
def test_int8_f32_tiling_matches_the_plain_version_and_jax(interpret_mode, D, Nq, Nk, layout):
    """The tiling of ``flash_attn_int8_f32`` (integer S over k-steps of 32
    bytes, 64-key tiles, P V in the 8-query register tile) on JAX's own
    quantised operands: S bit for bit against the plain version's scores
    (``_int8_scores``), O against ``flash_attn_int8_reference`` and against
    the JAX ``_flash_int8`` (``attention(impl="flash_int8")``'s kernel at D
    < 128) or ``_flash_int8_128`` (the same function at D = 128), each
    jitted, in interpret mode, atol 1e-5 (f32 sums in another order)."""
    B, H = 1, 2
    q, k, v = _randn(D + Nq + Nk, (B * H, Nq, D), (B * H, Nk, D), (B * H, Nk, D))
    k = k + 0.5
    bq, bk, Nq_p, Nk_p = jattn._block_geometry(Nq, Nk, 128, 128, D)
    pad = lambda x, n: jnp.pad(jnp.asarray(x), ((0, 0), (0, n - x.shape[1]), (0, 0)))  # noqa: E731
    flash = jattn._flash_int8 if D < 128 else jattn._flash_int8_128
    want = np.asarray(jax.jit(flash, static_argnums=(3, 4, 5), compiler_options=FAST_COMPILE)(
        pad(q, Nq_p), pad(k, Nk_p), pad(v, Nk_p), Nk, bq, bk))[:, :Nq].reshape(B, H, Nq, D)
    q8, sq, k8, sk = (torch.from_numpy(np.array(x)) for x in jattn._quantize_qk_int8(
        pad(q, Nq_p), pad(k, Nk_p), Nk))
    ops = (q8[:, :Nq].reshape(B, H, Nq, D), sq[:, :Nq].reshape(B, H, Nq),
           k8[:, :Nk].reshape(B, H, Nk, D), sk[:, :Nk].reshape(B, H, Nk))
    tv = torch.from_numpy(v).reshape(B, H, Nk, D)
    got, scores = _int8_f32_emulated(*ops, tv)
    assert torch.equal(scores, tattn._int8_scores(*ops))
    if layout == "bnhd":  # the plain version in the other layout
        plain = tattn.flash_attn_int8_f32(*(x.transpose(1, 2) for x in ops), tv.transpose(1, 2),
                                          layout="bnhd").transpose(1, 2)
    else:
        plain = tattn.flash_attn_int8_f32(*ops, tv, layout="bhnd")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


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
    width = tattn.padded_head_dim(D)
    # the f32 backward's wrapper launches the cluster kernel at width 128
    if bwd == "flash_attn_bwd_f32" and width == 128:
        bwd = "flash_attn_bwd_wide_f32"
    assert (e_fwd, e_bwd) == (fwd, bwd)
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
    """Nothing raises any more: D > 128 (inference, under grad and under
    ``flash_int8``, which takes the exact route at D >= 128 as in the JAX
    package) launches the wide entries at the padded width with D's scale,
    and the int8 route with f32 operands launches ``flash_attn_int8_f32``."""
    before = (tattn.flash_attn_fwd_wide.launches, tattn.flash_attn_bwd_wide.launches,
              tattn.flash_attn_int8_f32.launches)
    q = _meta((1, 64, 2, 160), torch.bfloat16)
    assert tattn.attention(q, q, q, layout="bnhd").shape == q.shape
    assert tattn.attention(q, q, q, impl="flash_int8", layout="bnhd").shape == q.shape
    g = _meta((2, 3, 700, 256), torch.float32, grad=True)
    o = tattn.attention(g, g, g)
    assert o.dtype == torch.float32 and type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.sum().backward()
    assert g.grad.shape == g.shape
    f = _meta((1, 5000, 2, 40), torch.float32)  # long rows: the int8 route
    assert tattn.attention(f, f, f, impl="flash_int8", layout="bnhd").dtype == torch.float32
    assert [e for e, _ in card_route] == [
        "flash_attn_fwd_wide_bf16", "flash_attn_fwd_wide_bf16", "flash_attn_fwd_wide_f32",
        "flash_attn_bwd_wide_f32", "flash_attn_int8_f32"]
    (_, a_inf), (_, a_i8), (_, a_fwd), (_, a_bwd), (_, a_f32i8) = card_route
    for args in (a_inf, a_i8):  # pointers q, k, v, o, lse, then B, H, Nq, Nk and the padded D
        assert _scale_arg(args[9]) == 192
        assert _scale_arg(args[-1]) == pytest.approx(160 ** -0.5 * tattn._LOG2E, rel=1e-7)
    assert _scale_arg(a_fwd[9]) == 256
    # twelve pointers (the last three the scratch), then B, H, Nq, Nk, D
    assert tuple(_scale_arg(x) for x in a_bwd[12:17]) == (2, 3, 700, 700, 256)
    assert _scale_arg(a_bwd[-1]) == pytest.approx(256 ** -0.5, rel=1e-7)
    assert a_f32i8[6:11] == (1, 2, 5000, 5000, 64)  # six pointers, then B, H, Nq, Nk, D
    assert (tattn.flash_attn_fwd_wide.launches, tattn.flash_attn_bwd_wide.launches,
            tattn.flash_attn_int8_f32.launches) == (before[0] + 3, before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("D,width", [(40, 64), (96, 128), (16, 16)])
def test_int8_route_with_f32_operands_launches_the_f32_entry(card_route, D, width):
    """f32 operands under ``flash_int8`` on the card's route: quantised with
    D's scale, zero-padded to the width, through ``flash_attn_int8_f32``."""
    q = _meta((2, 5000, 8, D), torch.float32)
    o = tattn.attention(q, q, q, impl="flash_int8", layout="bnhd")
    assert o.shape == q.shape and o.dtype == torch.float32
    [(entry, args)] = card_route
    assert entry == "flash_attn_int8_f32" and args[6:11] == (2, 8, 5000, 5000, width)


@pytest.mark.parametrize("D,width,dtype", [(129, 192, torch.bfloat16), (200, 256, torch.float32),
                                           (512, 512, torch.bfloat16)])
def test_wide_launch_allocates_the_slices_scratch(card_route, D, width, dtype):
    """Under grad above 128, 130 queries and 65 keys: the forward launches
    the wide entry of the dtype at the padded width with an LSE; the bf16
    backward (``csrc/flash_attn_bwd_wide.cu``) gets one f32 scratch, the
    base-2 LSE and delta over the query rows padded to whole 64-row tiles;
    the f32 backward (``csrc/flash_attn_bwd_wide_f32.cu``, one CTA of a
    cluster a 64-column chunk) gets delta, the dQ partial sums over whole
    query tiles (a query tile has two key tiles) and a turn counter per
    (head, 64-column chunk, 64-query tile) with the work counter. On traced
    operands the same calls launch nothing."""
    shape = (2, 3, 130, D)
    q = _meta(shape, dtype, grad=True)
    k = _meta((2, 3, 65, D), dtype, grad=True)
    before = (tattn.flash_attn_fwd_wide.launches, tattn.flash_attn_bwd_wide.launches)
    tattn._GEOMETRY.clear()
    o = tattn.attention(q, k, k)
    o.sum().backward()
    assert q.grad.shape == shape and k.grad.shape == (2, 3, 65, D)
    (e_fwd, a_fwd), (e_bwd, a_bwd) = card_route
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    assert (e_fwd, e_bwd) == (f"flash_attn_fwd_wide_{suffix}", f"flash_attn_bwd_wide_{suffix}")
    assert a_fwd[4] is not None and _scale_arg(a_fwd[9]) == width  # the LSE, the padded D
    if dtype == torch.bfloat16:
        # nine operand pointers and the scratch, then B, H, Nq, Nk, D
        assert len(a_bwd) == 10 + 5 + 24 + 1
        assert tuple(_scale_arg(x) for x in a_bwd[10:15]) == (2, 3, 130, 65, width)
    else:
        n_delta = -(-2 * 3 * 130 // 4) * 4
        n_acc = 2 * 3 * 3 * 64 * width
        assert a_bwd[10] - a_bwd[9] == 4 * n_delta and a_bwd[11] - a_bwd[10] == 4 * n_acc
        assert tattn.bwd_f32_slices(width) == width // 64
        [geo] = [g for key, g in tattn._GEOMETRY.items() if key[0] == "flash_attn_bwd_wide_f32"]
        assert geo[0] == (n_delta, n_acc, 2 * 3 * (width // 64) * 3 + 1)
    assert (tattn.flash_attn_fwd_wide.launches, tattn.flash_attn_bwd_wide.launches) == (
        before[0] + 1, before[1] + 1)
    with FakeTensorMode():
        fq, fk = (torch.empty(x.shape, dtype=dtype, device="meta") for x in (q, k))
        fq, fk = (tattn._pad_head_dim(x, width) for x in (fq, fk))
        fo, flse = tattn.flash_attn_fwd_wide(fq, fk, fk, layout="bhnd", with_lse=True)
        grads = tattn.flash_attn_bwd_wide(fq, fk, fk, fo, flse, fo, layout="bhnd")
    assert [g.shape for g in grads] == [fq.shape, fk.shape, fk.shape]
    assert len(card_route) == 2 and (
        tattn.flash_attn_fwd_wide.launches, tattn.flash_attn_bwd_wide.launches) == (
        before[0] + 1, before[1] + 1)
