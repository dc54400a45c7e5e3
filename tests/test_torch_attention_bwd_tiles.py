"""K3's tiling (``csrc/flash_attn_bwd.cu``, head_dim 16-64) checked on the CPU
before the card sees it: the query-split choice of the wrapper, the delta /
base-2 LSE prologue, a plain emulation of the kernel's decomposition
(128-key tiles of two 64-key warpgroups, 128-query tiles, dQ computed per
64-query half over the tile's 128 keys and summed over the key tiles in f32,
query splits with dK / dV partials summed in split order, keys past Nk
masked, padded queries given LSE2 = +inf) against the JAX package's
``_flash_bwd_T`` in Pallas interpret mode, and the B*H limits of the
wrappers (CUDA's grid y limit binds the kernels that still put b*h on
``blockIdx.y``; K1, K3 and both K6 entries take any B*H).

Tolerances: f32 on both sides, atol 5e-4 as ``test_torch_attention_grad``
holds K3's plain version to ``_flash_bwd_T``; the emulation against the
port's plain version (both f32, other summation orders) within 1e-4."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

GRAD_ATOL = 5e-4
KEYS = QUERIES = 128
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


# ---- the query split ----

@pytest.mark.parametrize("bh,nq,nk", [
    (48, 17776, 17776),  # CogVideoX-5B training: 139 key tiles x 48 heads
    (48, 17776, 226),    # its 226 text keys alone: 2 x 48 = 96 CTAs
    (2, 1000, 37), (2, 333, 512), (4, 300, 300), (1, 1, 1), (1, 64, 5000), (600, 64, 128),
])
def test_query_splits_cover_every_tile_once(bh, nq, nk):
    splits, per = tattn.bwd_splits(bh, nq, nk, QUERIES)
    n_qt = math.ceil(nq / QUERIES)
    tiles = [t for z in range(splits) for t in range(z * per, min(n_qt, (z + 1) * per))]
    assert tiles == list(range(n_qt))  # in order, each once
    assert all(z * per < n_qt for z in range(splits))  # no empty split
    ctas = math.ceil(nk / KEYS) * bh
    if ctas >= 264:
        assert splits == 1
    else:
        assert ctas * splits >= 264 or splits == n_qt


def test_query_splits_at_the_cogvideox_shape():
    # 139 key tiles x 48 heads = 6,672 CTAs: one split of 139 query tiles
    assert tattn.bwd_splits(48, 17776, 17776, QUERIES) == (1, 139)
    # K7's 64-query tiles are the same function
    assert tattn.bwd_d128_splits(24, 18480, 512) == tattn.bwd_splits(24, 18480, 512, 64)


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


def _k3_emulated(q, k, v, o, lse, do, splits=None):
    """K3's decomposition in plain f32 PyTorch on (B, H, N, D) operands."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    scale = D ** -0.5
    if splits is None:
        splits, per = tattn.bwd_splits(B * H, Nq, Nk, QUERIES)
    else:
        per = math.ceil(math.ceil(Nq / QUERIES) / splits)
    n_qt, n_kt = math.ceil(Nq / QUERIES), math.ceil(Nk / KEYS)
    lse2, delta = _prologue(o, do, lse, n_qt * QUERIES)
    q, do = _pad_rows(q, n_qt * QUERIES), _pad_rows(do, n_qt * QUERIES)
    k, v = _pad_rows(k, n_kt * KEYS), _pad_rows(v, n_kt * KEYS)
    dq_acc = torch.zeros(B, H, n_qt * QUERIES, D)
    dk_part = torch.zeros(splits, B, H, n_kt * KEYS, D)
    dv_part = torch.zeros_like(dk_part)
    for kt in range(n_kt):
        key_ok = (torch.arange(KEYS * kt, KEYS * kt + KEYS) < Nk)[:, None]
        for z in range(splits):
            for qt in range(z * per, min(n_qt, (z + 1) * per)):
                qs = slice(QUERIES * qt, QUERIES * qt + QUERIES)
                dst = torch.zeros(B, H, KEYS, QUERIES)  # dS^T of both warpgroups
                for wg in range(2):  # each warpgroup's 64 keys x 128 queries
                    ks = slice(KEYS * kt + 64 * wg, KEYS * kt + 64 * wg + 64)
                    st = k[..., ks, :] @ q[..., qs, :].transpose(-1, -2)
                    p = torch.where(key_ok[64 * wg:64 * wg + 64],
                                    torch.exp2(st * scale * LOG2E - lse2[..., None, qs]), 0.0)
                    dpt = v[..., ks, :] @ do[..., qs, :].transpose(-1, -2)
                    ds = p * (dpt - delta[..., None, qs])
                    dv_part[z, ..., ks, :] += p @ do[..., qs, :]
                    dk_part[z, ..., ks, :] += ds @ q[..., qs, :]
                    dst[..., 64 * wg:64 * wg + 64, :] = ds
                ks = slice(KEYS * kt, KEYS * kt + KEYS)
                for half in range(2):  # warpgroup `half` takes dQ's 64-query half
                    rows = slice(QUERIES * qt + 64 * half, QUERIES * qt + 64 * half + 64)
                    dq_acc[..., rows, :] += (dst[..., 64 * half:64 * half + 64].transpose(-1, -2)
                                             @ k[..., ks, :])
    dk, dv = dk_part[0], dv_part[0]
    for z in range(1, splits):  # split order
        dk, dv = dk + dk_part[z], dv + dv_part[z]
    return dq_acc[..., :Nq, :] * scale, dk[..., :Nk, :] * scale, dv[..., :Nk, :]


def _case(nq, nk, seed, H=2, D=64):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, H, nq, D), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, H, nk, D), dtype=np.float32))
            for _ in range(2))
    o, lse = tattn.flash_attn_fwd(q, k, v, layout="bhnd", with_lse=True)
    return q, k, v, o, lse, do


def _jax_flash_bwd_T(q, k, v, o, lse, do):
    """``_flash_bwd_T`` on the same residuals, operands padded to its 128-row
    blocks: padded keys masked by n_valid, padded queries carry dO = 0 and so
    contribute nothing."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    nq_pad, nk_pad = 128 * math.ceil(Nq / 128), 128 * math.ceil(Nk / 128)

    def bh(x, n):
        return jnp.asarray(_pad_rows(x, n).numpy().reshape(B * H, n, D))

    lse_p = torch.nn.functional.pad(lse, (0, nq_pad - Nq)).numpy().reshape(B * H, nq_pad, 1)
    lse_lanes = jnp.broadcast_to(jnp.asarray(lse_p), (B * H, nq_pad, jattn._LSE_LANES))
    res = (bh(q, nq_pad), bh(k, nk_pad), bh(v, nk_pad), bh(o, nq_pad), lse_lanes, Nk)
    dq, dk, dv = (np.asarray(x) for x in jattn._flash_bwd_T(res, bh(do, nq_pad), 128, 128))
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
def test_k3_decomposition_matches_jax_flash_bwd_T(nq, nk):
    case = _case(nq, nk, nq + nk)
    splits, _ = tattn.bwd_splits(2, nq, nk, QUERIES)
    assert splits > 1  # two heads: the split path with dK / dV partials
    got = _k3_emulated(*case)
    want = _jax_flash_bwd_T(*case)
    plain = tattn.flash_attn_bwd_reference(*case, layout="bhnd")
    for g, w, r in zip(got, want, plain):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d", [16, 32])
def test_k3_decomposition_at_every_head_dim(d):
    case = _case(300, 200, 40 + d, D=d)
    got = _k3_emulated(*case)
    want = _jax_flash_bwd_T(*case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_k3_decomposition_is_the_same_at_any_split(splits):
    case = _case(300, 200, 8)
    want = _k3_emulated(*case)
    got = _k3_emulated(*case, splits=splits)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_k3_decomposition_masks_keys_past_nk_at_extreme_logits():
    """Keys past Nk sit in the last 128-key tile as TMA's zero rows: S = 0
    there, so without the mask a very negative LSE would make P overflow."""
    q, k, v, o, lse, do = _case(100, 37, 21)
    q = q * 1e3
    o, lse = tattn.flash_attn_fwd(q, k, v, layout="bhnd", with_lse=True)
    got = _k3_emulated(q, k, v, o, lse, do)
    want = tattn.flash_attn_bwd_reference(q, k, v, o, lse, do, layout="bhnd")
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)


# ---- B*H past CUDA's grid y limit ----

def _record_launches(monkeypatch):
    """Replace the C entry points by a recorder; operands on the meta device
    take no memory at B*H = 70,000."""
    calls = []

    def fake_call(fn_name, entry, device, *args):
        calls.append(entry)

    monkeypatch.setattr(tattn, "_call", fake_call)
    return calls


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_k1_k3_and_k6_launch_at_70000_heads_and_k7_raises(monkeypatch, layout):
    calls = _record_launches(monkeypatch)

    def operands(D, n=8, dtype=torch.bfloat16):
        shape = (2, n, 35000, D) if layout == "bnhd" else (2, 35000, n, D)
        return torch.empty(shape, dtype=dtype, device="meta")

    x = operands(64)
    lse = torch.empty((2, 35000, 8), device="meta")
    dq, dk, dv = tattn._launch_bwd("flash_attn_bwd", tattn.KERNEL_HEAD_DIMS, tattn.BWD_QUERIES,
                                   None, x, x, x, x, lse, x, layout)
    assert dq.shape == dk.shape == dv.shape == x.shape
    y = operands(128)
    o, lse128 = tattn._launch_fwd("flash_attn_fwd_d128", "flash_attn_fwd_d128_bf16", y, y, y,
                                  layout, True, torch.bfloat16, (128,))
    assert o.shape == y.shape and lse128.shape == (2, 35000, 8)
    # K1 (persistent grid) and K6's f32 entry (flat grid) take any B*H too
    o1, lse1 = tattn._launch_fwd("flash_attn_fwd", "flash_attn_fwd", x, x, x, layout, True,
                                 torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
    assert o1.shape == x.shape and lse1.shape == (2, 35000, 8)
    z = operands(128, dtype=torch.float32)
    o32, _ = tattn._launch_fwd("flash_attn_fwd_f32", "flash_attn_fwd_f32", z, z, z, layout,
                               False, torch.float32, tattn.F32_HEAD_DIMS)
    assert o32.shape == z.shape and o32.dtype == torch.float32
    want = ["flash_attn_bwd", "flash_attn_fwd_d128_bf16", "flash_attn_fwd", "flash_attn_fwd_f32"]
    assert calls == want
    # K7 keeps b*h on blockIdx.y
    with pytest.raises(ValueError, match="B\\*H=70000"):
        tattn._launch_bwd("flash_attn_bwd_d128", (128,), tattn.BWD_D128_QUERIES,
                          tattn.GRID_Y_MAX, y, y, y, y, lse, y, layout)
    assert calls == want
