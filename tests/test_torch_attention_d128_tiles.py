"""K7's tiling (``csrc/flash_attn_bwd_d128.cu``) checked on the CPU before
the card sees it: the query-split choice of the wrapper, the 16-byte rule
that TMA puts on operands, the delta / base-2 LSE prologue, and a plain
emulation of the kernel's decomposition (128-key tiles, 64-query tiles,
query splits with dK / dV partials summed in split order, dQ summed over the
key tiles in f32, keys past Nk masked, padded queries given LSE2 = +inf)
against the JAX package's ``_flash_bwd`` in Pallas interpret mode.

Tolerances: f32 on both sides, atol 5e-4 as ``test_torch_attention_d128_grad``
holds K7's plain version to ``_flash_bwd``; the emulation against the port's
plain version (both f32, other summation orders) within 1e-4."""

import math

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
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


# ---- the query split ----

@pytest.mark.parametrize("bh,nq,nk", [
    (24, 18480, 18480),  # Wan self-attention: 145 key tiles x 24 heads
    (24, 18480, 512),    # Wan cross-attention: 4 x 24 = 96 CTAs
    (48, 18480, 512),    # the CFG pair
    (2, 1000, 37), (2, 333, 512), (4, 300, 300), (1, 1, 1), (1, 64, 5000), (600, 64, 128),
])
def test_query_splits_cover_every_tile_once(bh, nq, nk):
    splits, per = tattn.bwd_d128_splits(bh, nq, nk)
    n_qt = math.ceil(nq / 64)
    tiles = [t for z in range(splits) for t in range(z * per, min(n_qt, (z + 1) * per))]
    assert tiles == list(range(n_qt))  # in order, each once
    assert all(z * per < n_qt for z in range(splits))  # no empty split
    ctas = math.ceil(nk / 128) * bh
    if ctas >= 264:
        assert splits == 1
    else:
        assert ctas * splits >= 264 or splits == n_qt


def test_query_splits_at_the_wan_shapes():
    assert tattn.bwd_d128_splits(24, 18480, 18480) == (1, 289)
    # 4 x 24 CTAs a split: 4 splits of 73 tiles fill three waves of 132 SMs
    assert tattn.bwd_d128_splits(24, 18480, 512) == (4, 73)
    assert tattn.bwd_d128_splits(48, 18480, 512) == (2, 145)  # the CFG pair


# ---- the 16-byte rule ----

def test_16_byte_rule_on_strides_and_base():
    ok = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    tattn.check_16_bytes("f", "q", ok)
    for view in torch.zeros(1, 640, 3, 4, 64, dtype=torch.bfloat16).unbind(2):
        tattn.check_16_bytes("f", "q", view)  # packed qkv: n stride 1,536 B
    tattn.check_16_bytes("f", "q", torch.zeros(1, 8, 2, 4))  # f32 strides of 32 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        tattn.check_16_bytes("f", "q", torch.zeros(1, 8, 2, 130, dtype=torch.bfloat16)[..., :128])
    base = torch.zeros(1, 8, 2, 136, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.check_16_bytes("f", "q", base[..., 4:132])  # base 8 bytes in


def test_k7_launch_raises_on_unaligned_operands_without_a_kernel(monkeypatch):
    def boom(name):
        raise AssertionError(f"CUDA kernel {name} requested")

    monkeypatch.setattr(_kernels, "kernel", boom)
    x = torch.zeros(1, 70, 2, 136, dtype=torch.bfloat16)[..., 4:132]
    lse = torch.zeros(1, 2, 70)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._launch_bwd("flash_attn_bwd_d128", (128,), tattn.BWD_D128_QUERIES,
                          x, x, x, x, lse, x, "bnhd")


# ---- the prologue and the decomposition ----

def _prologue(o, do, lse, nq_pad):
    """delta = rowsum(O * dO) in f32 and LSE2 = LSE * log2(e), padded to whole
    query tiles: delta 0 and LSE2 = +inf on the padded rows."""
    B, H, Nq, _ = o.shape
    delta = torch.zeros(B, H, nq_pad)
    lse2 = torch.full((B, H, nq_pad), math.inf)
    delta[..., :Nq] = (o.float() * do.float()).sum(-1)
    lse2[..., :Nq] = lse * LOG2E
    return lse2, delta


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))  # TMA's zero fill


def _k7_emulated(q, k, v, o, lse, do, splits=None):
    """K7's decomposition in plain f32 PyTorch on (B, H, N, D) operands."""
    B, H, Nq, _ = q.shape
    Nk = k.shape[2]
    scale = D ** -0.5
    if splits is None:
        splits, per = tattn.bwd_d128_splits(B * H, Nq, Nk)
    else:
        per = math.ceil(math.ceil(Nq / 64) / splits)
    n_qt, n_kt = math.ceil(Nq / 64), math.ceil(Nk / 128)
    lse2, delta = _prologue(o, do, lse, n_qt * 64)
    q, do = _pad_rows(q, n_qt * 64), _pad_rows(do, n_qt * 64)
    k, v = _pad_rows(k, n_kt * 128), _pad_rows(v, n_kt * 128)
    dq_acc = torch.zeros(B, H, n_qt * 64, D)
    dk_part = torch.zeros(splits, B, H, n_kt * 128, D)
    dv_part = torch.zeros_like(dk_part)
    for kt in range(n_kt):
        ks = slice(128 * kt, 128 * kt + 128)
        key_ok = (torch.arange(128 * kt, 128 * kt + 128) < Nk)[:, None]
        for z in range(splits):
            for qt in range(z * per, min(n_qt, (z + 1) * per)):
                qs = slice(64 * qt, 64 * qt + 64)
                st = k[..., ks, :] @ q[..., qs, :].transpose(-1, -2)  # 128 keys x 64 queries
                p = torch.where(key_ok, torch.exp2(st * scale * LOG2E - lse2[..., None, qs]), 0.0)
                dpt = v[..., ks, :] @ do[..., qs, :].transpose(-1, -2)
                ds = p * (dpt - delta[..., None, qs])
                dv_part[z, ..., ks, :] += p @ do[..., qs, :]
                dk_part[z, ..., ks, :] += ds @ q[..., qs, :]
                dq_acc[..., qs, :] += ds.transpose(-1, -2) @ k[..., ks, :]
    dk, dv = dk_part[0], dv_part[0]
    for z in range(1, splits):  # split order
        dk, dv = dk + dk_part[z], dv + dv_part[z]
    return dq_acc[..., :Nq, :] * scale, dk[..., :Nk, :] * scale, dv[..., :Nk, :]


def _case(nq, nk, seed, H=2):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, H, nq, D), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, H, nk, D), dtype=np.float32))
            for _ in range(2))
    o, lse = tattn.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
    return q, k, v, o, lse, do


def _jax_flash_bwd(q, k, v, o, lse, do):
    """``_flash_bwd`` at D = 128 on the same residuals, operands padded to its
    128-row blocks: padded keys masked by n_valid, padded queries carry dO = 0
    and so contribute nothing."""
    B, H, Nq, _ = q.shape
    Nk = k.shape[2]
    nq_pad, nk_pad = 128 * math.ceil(Nq / 128), 128 * math.ceil(Nk / 128)

    def bh(x, n):
        return jnp.asarray(_pad_rows(x, n).numpy().reshape(B * H, n, D))

    lse_p = torch.nn.functional.pad(lse, (0, nq_pad - Nq)).numpy().reshape(B * H, nq_pad, 1)
    lse_lanes = jnp.broadcast_to(jnp.asarray(lse_p), (B * H, nq_pad, jattn._LSE_LANES))
    res = (bh(q, nq_pad), bh(k, nk_pad), bh(v, nk_pad), bh(o, nq_pad), lse_lanes, Nk)
    dq, dk, dv = (np.asarray(x) for x in jattn._flash_bwd(res, bh(do, nq_pad), 128, 128))
    return (dq.reshape(B, H, nq_pad, D)[:, :, :Nq], dk.reshape(B, H, nk_pad, D)[:, :, :Nk],
            dv.reshape(B, H, nk_pad, D)[:, :, :Nk])


def test_prologue_delta_matches_jax():
    q, k, v, o, lse, do = _case(333, 512, 3)
    lse2, delta = _prologue(o, do, lse, 384)
    want = np.asarray(jnp.sum(jnp.asarray(o.numpy()) * jnp.asarray(do.numpy()), -1))
    np.testing.assert_allclose(delta[..., :333].numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(delta[..., 333:].numpy(), 0.0)
    np.testing.assert_allclose(lse2[..., :333].numpy(), lse.numpy() * LOG2E, rtol=1e-6)
    assert torch.isinf(lse2[..., 333:]).all()
    # a padded query row gets P = exp2(0 * c - inf) = 0 exactly
    assert torch.exp2(torch.zeros(1) - lse2[0, 0, -1]).item() == 0.0


@pytest.mark.parametrize("nq,nk", [(1000, 37), (333, 512), (300, 300)])
def test_k7_decomposition_matches_jax_flash_bwd(nq, nk):
    case = _case(nq, nk, nq + nk)
    splits, _ = tattn.bwd_d128_splits(2, nq, nk)
    assert splits > 1  # two heads: the split path with dK / dV partials
    got = _k7_emulated(*case)
    want = _jax_flash_bwd(*case)
    plain = tattn.flash_attn_bwd_reference(*case, layout="bhnd")
    for g, w, r in zip(got, want, plain):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_k7_decomposition_is_the_same_at_any_split(splits):
    case = _case(300, 200, 8)
    want = _k7_emulated(*case)
    got = _k7_emulated(*case, splits=splits)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_k7_decomposition_masks_keys_past_nk_at_extreme_logits():
    """Keys past Nk sit in the last 128-key tile as TMA's zero rows: S = 0
    there, so without the mask a very negative LSE would make P overflow."""
    q, k, v, o, lse, do = _case(100, 37, 21)
    q = q * 1e3
    o, lse = tattn.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
    got = _k7_emulated(q, k, v, o, lse, do)
    want = tattn.flash_attn_bwd_reference(q, k, v, o, lse, do, layout="bhnd")
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
