"""The float32 entry of K3/K7 (``csrc/flash_attn_bwd_f32.cu``,
``ops/attention.py::flash_attn_bwd_f32``) on the CPU.

The kernel cannot run here, so its tiling is emulated in plain PyTorch:
delta = rowsum(O * dO) in a prologue, dK/dV over 64-key tiles walking the
query tiles, dQ over 64-query tiles walking the key tiles, with ragged last
tiles on both sides (the tile is read from the source). The emulation is
held against ``flash_attn_bwd_reference`` and against the JAX package's
``_flash`` vjp in float32 (its Pallas backward in interpret mode), at head
dims 16-128, Nq != Nk, both layouts. On ``meta`` operands with the C entry
recorded, the wrapper launches at B*H = 70,000, and ``attention()`` under
grad takes K6's f32 entry and this one on the card's route.

Tolerances: atol 2e-5 between the emulation and the plain version (the
same f32 formulas, other summation orders); 5e-4 against JAX, as
``tests/test_torch_attention_grad.py`` holds the port's gradients to the
JAX flash vjp.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

_SRC = Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_attn_bwd_f32.cu"
BLOCK = int(re.search(r"constexpr int kBlock = (\d+);", _SRC.read_text()).group(1))


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in shapes)


def _f32_bwd_emulated(q, k, v, o, lse, do, scale):
    """The kernel's three passes on (B, H, N, D) f32 operands."""
    Nq, Nk = q.shape[2], k.shape[2]
    delta = (o * do).sum(-1)  # prologue
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, Nk, BLOCK):  # dK/dV: one CTA a key tile
        kt, vt = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for q0 in range(0, Nq, BLOCK):
            sl = slice(q0, q0 + BLOCK)
            s_t = kt @ q[:, :, sl].transpose(-1, -2)  # S^T, keys x queries
            p_t = torch.exp(s_t * scale - lse[:, :, None, sl])
            dp_t = vt @ do[:, :, sl].transpose(-1, -2)
            ds_t = p_t * (dp_t - delta[:, :, None, sl])
            acc_v += p_t @ do[:, :, sl]
            acc_k += ds_t @ q[:, :, sl]
        dk[:, :, k0:k0 + BLOCK], dv[:, :, k0:k0 + BLOCK] = acc_k * scale, acc_v
    for q0 in range(0, Nq, BLOCK):  # dQ: one CTA a query tile
        sl = slice(q0, q0 + BLOCK)
        acc = torch.zeros_like(q[:, :, sl])
        for k0 in range(0, Nk, BLOCK):
            kt, vt = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
            p = torch.exp(q[:, :, sl] @ kt.transpose(-1, -2) * scale - lse[:, :, sl, None])
            ds = p * (do[:, :, sl] @ vt.transpose(-1, -2) - delta[:, :, sl, None])
            acc += ds @ kt
        dq[:, :, sl] = acc * scale
    return dq, dk, dv


def _jax_vjp(q, k, v, do):
    """The JAX ``_flash`` vjp in f32 (``attention(impl="flash")``)."""
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention(a, b, c, impl="flash", block_q=128,
                                                     block_k=128),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("nq,nk,d", [(150, 150, 16), (70, 200, 32), (257, 129, 64),
                                     (64, 10, 128), (10, 10, 128)])
def test_emulated_tiling_matches_the_plain_version_and_jax(nq, nk, d):
    q, do = (torch.from_numpy(x) for x in _randn(d + nq, (1, 2, nq, d), (1, 2, nq, d)))
    k, v = (torch.from_numpy(x) for x in _randn(d + nk + 1, (1, 2, nk, d), (1, 2, nk, d)))
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    got = _f32_bwd_emulated(q, k, v, o, lse, do, d ** -0.5)
    want = tattn.flash_attn_bwd_f32(q, k, v, o, lse, do, layout="bhnd")  # CPU: plain version
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
    for g, w in zip(got, _jax_vjp(q.numpy(), k.numpy(), v.numpy(), do.numpy())):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4, rtol=0)


def test_bnhd_wrapper_and_a_non_default_scale_match_the_plain_formulas():
    """The wrapper's layouts and ``softmax_scale`` (what a padded head_dim
    passes): the emulation at the given scale equals the bnhd plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in _randn(3, *[(1, 90, 3, 32)] * 4))
    scale = 24 ** -0.5
    o, lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bnhd", with_lse=True,
                                            softmax_scale=scale)
    got = tattn.flash_attn_bwd_f32(q, k, v, o, lse, do, layout="bnhd", softmax_scale=scale)
    tr = [x.transpose(1, 2) for x in (q, k, v, o, do)]
    want = _f32_bwd_emulated(*tr[:4], lse, tr[4], scale)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g.transpose(1, 2), w, atol=2e-5, rtol=0)


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "_on_card", lambda x: x.device.type == "meta")
    monkeypatch.setattr(tattn, "_call",
                        lambda fn_name, entry, device, *args: calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_f32_backward_launches_at_70000_heads(monkeypatch, layout):
    calls = _record(monkeypatch)
    shape = (2, 8, 35000, 64) if layout == "bnhd" else (2, 35000, 8, 64)
    x = torch.empty(shape, device="meta")
    lse = torch.empty((2, 35000, 8), device="meta")
    before = tattn.flash_attn_bwd_f32.launches
    dq, dk, dv = tattn.flash_attn_bwd_f32(x, x, x, x, lse, x, layout=layout)
    assert dq.shape == dk.shape == dv.shape == x.shape and dq.dtype == torch.float32
    [(entry, args)] = calls
    assert entry == "flash_attn_bwd_f32" and tattn.flash_attn_bwd_f32.launches == before + 1
    # ten pointers, then B, H, Nq, Nk, D, 24 strides and the scale
    assert args[10:15] == (2, 35000, 8, 8, 64) and len(args) == 10 + 5 + 24 + 1
    with pytest.raises(TypeError, match="float32"):
        tattn.flash_attn_bwd_f32(*(t.to(torch.bfloat16) for t in (x, x, x, x)), lse,
                                 x.to(torch.bfloat16), layout=layout)


def test_attention_under_grad_takes_the_f32_entries_on_the_card_route(monkeypatch):
    calls = _record(monkeypatch)
    q = torch.empty((4, 10, 16, 128), device="meta", requires_grad=True)
    o = tattn.attention(q, q, q, layout="bnhd")
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.sum().backward()
    assert [e for e, _ in calls] == ["flash_attn_fwd_f32", "flash_attn_bwd_f32"]
    assert q.grad.shape == q.shape
