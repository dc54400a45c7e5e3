"""K1's schedule (``csrc/flash_attn_fwd.cu``, head_dim 16-64) and the tiling
of K6's float32 entry (``csrc/flash_attn_fwd_d128.cu``) checked on the CPU
before the card sees them.

K1: a persistent grid of one CTA an SM walking (query tile, head) items in
order, query tiles of 64 rows a consumer warpgroup (the warpgroup count is
read from the source), 128-key tiles, an online softmax in the log2 domain
with D^-0.5 log2 e folded into one multiply, keys past Nk masked to -inf on
the last tile only, TMA's zero rows past Nq and Nk, P rounded to bf16 before
P V, the base-2 LSE turned into the natural-log one. Its plain emulation is
held against the JAX package's ``_flash_fwd_guarded`` (the lagged-max
forward with its exact fallback) in Pallas interpret mode.

K6 f32: a flat grid of one CTA a (64-query tile, head), 64-key tiles, each
thread holding 4 rows x 16 strided keys of S and its share of each row sum,
the row sums reduced over the 16 lanes at the end. Its plain emulation is
held against ``_flash_fwd`` in f32.

Tolerances: an emulation with P in f32 against the JAX kernel in f32 (both
exact online softmaxes, other summation orders) within 2e-5; with P rounded
to bf16 as K1 rounds it, against the port's plain version within the bf16
rounding of P (atol 1e-2 on O, whose entries are of order 0.1)."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

_K1_SOURCE = Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_attn_fwd.cu"
CONSUMER_WGS = int(re.search(r"constexpr int kConsumerWGs = (\d+);",
                             _K1_SOURCE.read_text()).group(1))
K1_BLOCK_M = 64 * CONSUMER_WGS
K1_BLOCK_N = 128
F32_BLOCK = 64
SMS = tattn.H100_SMS
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def k1_work_order(bh, nq, block_m=K1_BLOCK_M, sms=SMS):
    """Each CTA's (head, query tile) items in the order it walks them: the
    kernel's ``for (item = blockIdx.x; item < n_items; item += gridDim.x)``
    over item = b*h * n_q_tiles + query tile, on a grid of min(items, SMs)."""
    n_qt = math.ceil(nq / block_m)
    n_items = bh * n_qt
    grid = min(n_items, sms)
    return [[divmod(item, n_qt) for item in range(c, n_items, grid)] for c in range(grid)]


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[1]))


def _k1_emulated(q, k, v, p_dtype=torch.float32):
    """K1's decomposition in plain PyTorch on (B, H, N, D) f32 operands;
    returns (O, natural-log LSE (B, H, Nq))."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    scale_log2 = D ** -0.5 * LOG2E
    n_kt = math.ceil(Nk / K1_BLOCK_N)
    qs, ks, vs = (x.reshape(B * H, x.shape[2], D) for x in (q, k, v))
    # TMA's zero rows past Nq and Nk
    qs = _pad_rows(qs, math.ceil(Nq / K1_BLOCK_M) * K1_BLOCK_M)
    ks, vs = (_pad_rows(x, n_kt * K1_BLOCK_N) for x in (ks, vs))
    o = torch.full((B * H, Nq, D), math.nan)
    lse = torch.full((B * H, Nq), math.nan)
    for cta in k1_work_order(B * H, Nq):
        for bh, qt in cta:
            q0 = K1_BLOCK_M * qt
            acc = torch.zeros(K1_BLOCK_M, D)
            mx = torch.full((K1_BLOCK_M, 1), -math.inf)
            l = torch.zeros(K1_BLOCK_M, 1)
            for j in range(n_kt):
                key0 = K1_BLOCK_N * j
                s = (qs[bh, q0:q0 + K1_BLOCK_M] @ ks[bh, key0:key0 + K1_BLOCK_N].T) * scale_log2
                if key0 + K1_BLOCK_N > Nk:  # the last tile only
                    s = torch.where(torch.arange(key0, key0 + K1_BLOCK_N) < Nk, s, -math.inf)
                mnew = torch.maximum(mx, s.amax(-1, keepdim=True))
                alpha = torch.exp2(mx - mnew)
                p = torch.exp2(s - mnew)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(p_dtype).float() @ vs[bh, key0:key0 + K1_BLOCK_N]
                mx = mnew
            n = min(K1_BLOCK_M, Nq - q0)  # queries past Nq are not stored
            o[bh, q0:q0 + n] = (acc / l)[:n]
            lse[bh, q0:q0 + n] = ((mx + torch.log2(l)) * LN2)[:n, 0]
    return o.reshape(B, H, Nq, D), lse.reshape(B, H, Nq)


def _f32_emulated(q, k, v):
    """K6's f32 tiling in plain PyTorch on (B, H, N, D) f32 operands: one CTA
    a (64-query tile, head) on a flat grid; thread column group cg holds keys
    cg + 16 j of each 64-key tile and its share of each row sum."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    scale_log2 = D ** -0.5 * LOG2E
    n_qt, n_kt = math.ceil(Nq / F32_BLOCK), math.ceil(Nk / F32_BLOCK)
    qs, ks, vs = (x.reshape(B * H, x.shape[2], D) for x in (q, k, v))
    qs = _pad_rows(qs, n_qt * F32_BLOCK)
    ks, vs = (_pad_rows(x, n_kt * F32_BLOCK) for x in (ks, vs))
    # the keys of column group cg, in the order its thread holds them
    cols = torch.arange(F32_BLOCK).reshape(4, 16).T.reshape(-1)
    o = torch.full((B * H, Nq, D), math.nan)
    lse = torch.full((B * H, Nq), math.nan)
    for item in range(B * H * n_qt):
        bh, qt = divmod(item, n_qt)
        q0 = F32_BLOCK * qt
        acc = torch.zeros(F32_BLOCK, D)
        mx = torch.full((F32_BLOCK, 1), -math.inf)
        l_part = torch.zeros(F32_BLOCK, 16)
        for j in range(n_kt):
            key0 = F32_BLOCK * j
            s = (qs[bh, q0:q0 + F32_BLOCK] @ ks[bh, key0:key0 + F32_BLOCK].T) * scale_log2
            s = torch.where(torch.arange(key0, key0 + F32_BLOCK) < Nk, s, -math.inf)
            mnew = torch.maximum(mx, s.amax(-1, keepdim=True))
            alpha = torch.exp2(mx - mnew)
            p = torch.exp2(s - mnew)
            l_part = l_part * alpha + p[:, cols].reshape(F32_BLOCK, 16, 4).sum(-1)
            acc = acc * alpha + p @ vs[bh, key0:key0 + F32_BLOCK]
            mx = mnew
        l = l_part.sum(-1, keepdim=True)
        n = min(F32_BLOCK, Nq - q0)
        o[bh, q0:q0 + n] = (acc / l)[:n]
        lse[bh, q0:q0 + n] = ((mx + torch.log2(l)) * LN2)[:n, 0]
    return o.reshape(B, H, Nq, D), lse.reshape(B, H, Nq)


def _case(nq, nk, D, seed, H=2, B=1):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, nq, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, H, nk, D), dtype=np.float32))
            for _ in range(2))
    return q, k, v


def _padded_bh(x, n):
    """(B, H, N, D) -> (B*H, n, D) jax array, rows past N zero."""
    B, H, N, D = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, n - N))
    return jnp.asarray(x.numpy().reshape(B * H, n, D))


def _jax_forward(fn, q, k, v, with_lse):
    """A JAX flash forward on 128-row blocks of the same operands: padded
    keys masked by n_valid, padded query rows dropped."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    nq_pad, nk_pad = 128 * math.ceil(Nq / 128), 128 * math.ceil(Nk / 128)
    o, lse = fn(_padded_bh(q, nq_pad), _padded_bh(k, nk_pad), _padded_bh(v, nk_pad), Nk, 128,
                128, with_lse=with_lse)
    o = np.asarray(o).reshape(B, H, nq_pad, D)[:, :, :Nq]
    if lse is not None:
        lse = np.asarray(lse)[..., 0].reshape(B, H, nq_pad)[:, :, :Nq]
    return o, lse


# ---- K1's work order ----

@pytest.mark.parametrize("bh,nq", [
    (96, 17776),   # CogVideoX-5B denoise: the CFG pair's 2 x 48 heads
    (48, 17776),   # its DPO forward, batch 1
    (64, 13740),   # VGGT-1B global blocks: 4 clips x 16 heads, 10 x 1,374 tokens
    (70000, 24),   # past CUDA's grid y limit
    (2, 1000), (1, 1),
])
def test_k1_work_order_covers_every_tile_and_head_once(bh, nq):
    n_qt = math.ceil(nq / K1_BLOCK_M)
    order = k1_work_order(bh, nq)
    assert len(order) == min(SMS, bh * n_qt)
    items = sorted(item for cta in order for item in cta)
    assert items == [(h, t) for h in range(bh) for t in range(n_qt)]
    sizes = {len(cta) for cta in order}
    assert max(sizes) - min(sizes) <= 1
    # the first wave: consecutive items, so neighbouring query tiles of one head
    assert [cta[0] for cta in order] == [divmod(i, n_qt) for i in range(len(order))]


@pytest.mark.parametrize("wgs", [2, 3])
def test_k1_work_order_for_either_item_size(wgs):
    """The design's choice between two and three consumer warpgroups moves
    the item size only; the cover holds for both."""
    for bh, nq in ((96, 17776), (64, 13740)):
        order = k1_work_order(bh, nq, block_m=64 * wgs)
        n_qt = math.ceil(nq / (64 * wgs))
        assert sorted(i for cta in order for i in cta) == [
            (h, t) for h in range(bh) for t in range(n_qt)]


# ---- K1's decomposition against the JAX kernel ----

@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("nq,nk", [(1000, 37), (333, 512), (300, 300)])
def test_k1_schedule_matches_jax_flash_fwd_guarded(nq, nk, D, with_lse):
    q, k, v = _case(nq, nk, D, nq + 7 * nk + D)
    o, lse = _k1_emulated(q, k, v)
    want_o, want_lse = _jax_forward(jattn._flash_fwd_guarded, q, k, v, with_lse)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=1e-5)
    if with_lse:
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=1e-6)
    else:
        assert want_lse is None


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("nq,nk", [(1000, 37), (333, 512), (300, 300)])
def test_k1_schedule_with_bf16_p_matches_the_plain_version(nq, nk, D):
    """P rounded to bf16 before P V (unnormalised, as the kernel rounds it)
    moves O by the rounding of P alone; the LSE does not see it."""
    q, k, v = _case(nq, nk, D, 3 * nq + nk + D)
    o, lse = _k1_emulated(q, k, v, p_dtype=torch.bfloat16)
    want_o, want_lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    torch.testing.assert_close(o, want_o, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("nq,nk", [(300, 300), (200, 37)])
def test_k1_schedule_at_extreme_logits(nq, nk):
    """q x 1e3: near one-hot rows, the case the TPU's clamp-free fallback
    exists for. The emulation stays finite and equals an independent f64
    softmax; at Nk 37, with every real score very negative, the zero keys
    past Nk would take the softmax without the last tile's mask."""
    q, k, v = _case(nq, nk, 64, nq + nk)
    q = q * 1e3
    if nk == 37:
        q, k = q.abs(), -k.abs()
    o, lse = _k1_emulated(q, k, v)
    s = (q.double() @ k.double().transpose(-1, -2)) * 64 ** -0.5
    want_o = torch.softmax(s, -1) @ v.double()
    want_lse = torch.logsumexp(s, -1)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # logits of order 1e4 carry f32 rounding of order 1e-3 into the weights
    torch.testing.assert_close(o.double(), want_o, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(lse.double(), want_lse, atol=1e-2, rtol=1e-5)


# ---- K6's float32 tiling against the JAX kernel ----

@pytest.mark.parametrize("case", ["camera_head", "ragged_long"])
def test_f32_tiling_matches_jax_flash_fwd(case):
    if case == "camera_head":  # (4, 10, 16, 128): one tile a head
        q, k, v = _case(10, 10, 128, 41, H=16, B=4)
    else:
        q, k, v = _case(300, 1000, 64, 43)
    o, lse = _f32_emulated(q, k, v)
    want_o, want_lse = _jax_forward(jattn._flash_fwd, q, k, v, True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=1e-6)


def test_f32_grid_covers_every_tile_and_head_once():
    """The flat grid's item = b*h * n_q_tiles + query tile, one CTA each, at
    the camera head, the f32 scorer's frame and global rows and past CUDA's
    grid y limit."""
    for bh, nq in ((64, 10), (640, 1374), (64, 13740), (70000, 24)):
        n_qt = math.ceil(nq / F32_BLOCK)
        items = [divmod(i, n_qt) for i in range(bh * n_qt)]
        assert len(set(items)) == bh * n_qt and items[-1] == (bh - 1, n_qt - 1)
        assert bh * n_qt < 2 ** 31


# ---- the forward wrappers' launch-geometry cache ----

def test_forward_geometry_cache_keeps_every_check(monkeypatch):
    """A hit of ``_launch_fwd``'s cache skips only checks that the same
    geometry already passed: the launch arguments are those of a miss, any
    change of dtype, stride or shape goes through the checks again, and a
    bf16 operand whose base address breaks TMA's 16-byte rule still raises."""
    calls = []
    monkeypatch.setattr(tattn, "_call", lambda fn, entry, device, *args: calls.append(args))
    monkeypatch.setattr(tattn, "_GEOMETRY", {})
    launch = tattn._launch_fwd
    q = torch.zeros(2, 40, 3, 64, dtype=torch.bfloat16)
    for _ in range(2):
        o, lse = launch("flash_attn_fwd", "flash_attn_fwd", q, q, q, "bnhd", True,
                        torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
        assert o.shape == q.shape and o.is_contiguous() and lse.shape == (2, 3, 40)
    assert len(tattn._GEOMETRY) == 1
    assert [a.value for a in calls[0][5:]] == [a.value for a in calls[1][5:]]
    # B, H, Nq, Nk, D and the (b, n, h) strides of q, k, v and O
    assert [a.value for a in calls[0][5:22]] == [2, 3, 40, 40, 64] + [7680, 192, 64] * 4
    with pytest.raises(TypeError):
        launch("flash_attn_fwd", "flash_attn_fwd", q, q, q.float(), "bnhd", False,
               torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
    with pytest.raises(ValueError, match="contiguous last dim"):
        launch("flash_attn_fwd", "flash_attn_fwd", q, q, q.transpose(2, 3), "bnhd", False,
               torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
    # the same geometry one element (2 bytes) off a 16-byte boundary
    buf = torch.zeros(q.numel() + 16, dtype=torch.bfloat16)
    aligned = buf[8 - buf.data_ptr() % 16 // 2:][:q.numel()].view(q.shape)
    shifted = buf[9 - buf.data_ptr() % 16 // 2:][:q.numel()].view(q.shape)
    launch("flash_attn_fwd", "flash_attn_fwd", aligned, aligned, aligned, "bnhd", False,
           torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
    with pytest.raises(ValueError, match="16-byte"):
        launch("flash_attn_fwd", "flash_attn_fwd", aligned, shifted, aligned, "bnhd", False,
               torch.bfloat16, tattn.KERNEL_HEAD_DIMS)
    assert len(calls) == 3
