"""K6's bf16 schedule (``csrc/flash_attn_fwd_d128.cu``) checked on the CPU
before the card sees it: a plain emulation of the kernel's decomposition
(a persistent grid of one CTA an SM walking (128-query tile, head) items in
order, 128-key tiles, an online softmax in the log2 domain with D^-0.5 log2 e
folded into one multiply, keys past Nk masked to -inf, P rounded to bf16
before P V, the base-2 LSE turned into the natural-log one) against the JAX
package's ``_flash_fwd`` in Pallas interpret mode, with and without LSE, and
the work order's cover of every (query tile, head).

Tolerances: the emulation with P in f32 against ``_flash_fwd`` in f32 (both
exact online softmaxes, other summation orders) within 2e-5; with P rounded
to bf16 as the kernel rounds it, against the port's plain version within the
bf16 rounding of P (atol 1e-2 on O, whose entries are of order 0.1)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from videogpa_torch.ops import attention as tattn

torch.set_num_threads(2)

D = 128
BLOCK_M = BLOCK_N = 128
SMS = tattn.H100_SMS
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def work_order(bh, nq, sms=SMS):
    """Each CTA's (head, query tile) items, in the order it walks them: the
    kernel's ``for (item = blockIdx.x; item < n_items; item += gridDim.x)``
    over item = b*h * n_q_tiles + query tile, on a grid of min(items, SMs)."""
    n_qt = math.ceil(nq / BLOCK_M)
    n_items = bh * n_qt
    grid = min(n_items, sms)
    return [[divmod(item, n_qt) for item in range(c, n_items, grid)] for c in range(grid)]


def _k6_emulated(q, k, v, p_dtype=torch.float32):
    """K6's decomposition in plain PyTorch on (B, H, N, D) f32 operands;
    returns (O, natural-log LSE (B, H, Nq))."""
    B, H, Nq, _ = q.shape
    Nk = k.shape[2]
    scale_log2 = D ** -0.5 * LOG2E
    n_kt = math.ceil(Nk / BLOCK_N)
    qs, ks, vs = (x.reshape(B * H, x.shape[2], D) for x in (q, k, v))
    # TMA's zero rows past Nq and Nk
    qs = torch.nn.functional.pad(qs, (0, 0, 0, math.ceil(Nq / BLOCK_M) * BLOCK_M - Nq))
    ks, vs = (torch.nn.functional.pad(x, (0, 0, 0, n_kt * BLOCK_N - Nk)) for x in (ks, vs))
    o = torch.full((B * H, Nq, D), math.nan)
    lse = torch.full((B * H, Nq), math.nan)
    for cta in work_order(B * H, Nq):
        for bh, qt in cta:
            rows = slice(BLOCK_M * qt, BLOCK_M * qt + BLOCK_M)
            acc = torch.zeros(BLOCK_M, D)
            mx = torch.full((BLOCK_M, 1), -math.inf)
            l = torch.zeros(BLOCK_M, 1)
            for j in range(n_kt):
                keys = slice(BLOCK_N * j, BLOCK_N * j + BLOCK_N)
                s = (qs[bh, rows] @ ks[bh, keys].T) * scale_log2
                key = torch.arange(BLOCK_N * j, BLOCK_N * j + BLOCK_N)
                s = torch.where(key < Nk, s, -math.inf)
                mnew = torch.maximum(mx, s.amax(-1, keepdim=True))
                alpha = torch.exp2(mx - mnew)
                p = torch.exp2(s - mnew)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(p_dtype).float() @ vs[bh, keys]
                mx = mnew
            n = min(BLOCK_M, Nq - BLOCK_M * qt)  # queries past Nq are not stored
            o[bh, BLOCK_M * qt:BLOCK_M * qt + n] = (acc / l)[:n]
            lse[bh, BLOCK_M * qt:BLOCK_M * qt + n] = ((mx + torch.log2(l)) * LN2)[:n, 0]
    return o.reshape(B, H, Nq, D), lse.reshape(B, H, Nq)


def _case(nq, nk, seed, H=2):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, H, nq, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, H, nk, D), dtype=np.float32))
            for _ in range(2))
    return q, k, v


def _jax_flash_fwd(q, k, v, with_lse):
    """``_flash_fwd`` at D = 128 on the same operands, padded to its 128-row
    blocks: padded keys masked by n_valid, padded query rows dropped."""
    B, H, Nq, _ = q.shape
    Nk = k.shape[2]
    nq_pad, nk_pad = 128 * math.ceil(Nq / 128), 128 * math.ceil(Nk / 128)

    def bh(x, n):
        x = torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))
        return jnp.asarray(x.numpy().reshape(B * H, n, D))

    o, lse = jattn._flash_fwd(bh(q, nq_pad), bh(k, nk_pad), bh(v, nk_pad), Nk, 128, 128,
                              with_lse=with_lse)
    o = np.asarray(o).reshape(B, H, nq_pad, D)[:, :, :Nq]
    if lse is not None:
        lse = np.asarray(lse)[..., 0].reshape(B, H, nq_pad)[:, :, :Nq]
    return o, lse


# ---- the work order ----

@pytest.mark.parametrize("bh,nq", [
    (24, 18480),   # Wan self- and cross-attention: 145 query tiles x 24 heads
    (48, 18480),   # the CFG pair
    (2, 1000), (2, 333), (1, 1), (3, 128), (70000, 24),
])
def test_work_order_covers_every_tile_and_head_once(bh, nq):
    n_qt = math.ceil(nq / BLOCK_M)
    order = work_order(bh, nq)
    assert len(order) == min(SMS, bh * n_qt)
    items = sorted(item for cta in order for item in cta)
    assert items == [(h, t) for h in range(bh) for t in range(n_qt)]
    # CTAs take turns: their loads stay within a few neighbouring heads
    sizes = {len(cta) for cta in order}
    assert max(sizes) - min(sizes) <= 1


def test_work_order_at_the_wan_shape():
    order = work_order(24, 18480)
    assert len(order) == 132 and [len(c) for c in order[:3]] == [27, 27, 27]
    assert sum(len(c) for c in order) == 24 * 145
    # the first wave: 132 consecutive items, query tiles of head 0
    assert {cta[0][0] for cta in order} == {0}
    assert order[0][:2] == [(0, 0), (0, 132)]


# ---- the decomposition against the JAX kernel ----

@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("nq,nk", [(1000, 37), (333, 512), (300, 300)])
def test_k6_schedule_matches_jax_flash_fwd(nq, nk, with_lse):
    q, k, v = _case(nq, nk, nq + 7 * nk)
    o, lse = _k6_emulated(q, k, v)
    want_o, want_lse = _jax_flash_fwd(q, k, v, with_lse)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=1e-5)
    if with_lse:
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=1e-6)
    else:
        assert want_lse is None


@pytest.mark.parametrize("nq,nk", [(1000, 37), (333, 512), (300, 300)])
def test_k6_schedule_with_bf16_p_matches_the_plain_version(nq, nk):
    """P rounded to bf16 before P V (unnormalised, as the kernel rounds it)
    moves O by the rounding of P alone; the LSE does not see it."""
    q, k, v = _case(nq, nk, 3 * nq + nk)
    o, lse = _k6_emulated(q, k, v, p_dtype=torch.bfloat16)
    want_o, want_lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    torch.testing.assert_close(o, want_o, atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_k6_schedule_masks_keys_past_nk_at_extreme_logits():
    """Keys past Nk are TMA's zero rows: S = 0 there, above every real score
    of a row whose logits are all very negative, so without the mask the
    padding would take the softmax."""
    q, k, v = _case(200, 37, 5)
    k = -k.abs()
    q = q.abs() * 1e3
    o, lse = _k6_emulated(q, k, v)
    want_o, want_lse = tattn.flash_attn_fwd_reference(q, k, v, layout="bhnd", with_lse=True)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o, want_o, atol=5e-3, rtol=1e-3)
    torch.testing.assert_close(lse, want_lse, atol=1e-2, rtol=1e-5)
