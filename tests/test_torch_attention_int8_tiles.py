"""K8's and K9's schedule (``csrc/flash_attn_int8.cu``, one template over
head_dim 16, 32, 64 and 128) checked on the CPU before the card sees it.

A persistent grid of one CTA an SM walks (query tile, head) items in order;
a query tile is 64 rows a consumer warpgroup (the warpgroup count is read
from the source: kConsumerWGs at head_dim <= 64, two at 128); keys come in
128-key tiles, each with its 128 key scales. Per tile: the s32 scores of
int8 rows (head_dim 16 rows zero-padded to 32 bytes, as the TMA box reads
them), converted to f32 (exact below 2^24), times the key scales, keys past
Nk at -inf on the last tile only; the row scale enters the exponent,
exp2(t * sq - running max of t * sq); P rounded to bf16 before P V; O
divided by the f32 row sum at the end. The integer-add conversion of
``kernel_ab.py``'s ``int8_magic`` variant is checked exact over the whole
score range, so that variant computes the same function.

The plain emulation is held against the JAX package's ``_flash_int8`` and
``_flash_int8_128`` in Pallas interpret mode on the same (JAX-quantised)
operands, and against the port's ``flash_attn_int8_reference``.

Tolerances: with P in f32 the emulation and the Pallas kernels differ by
f32 summation order and the order of the scale products (atol 2e-5 on O of
order 0.1, as the port's plain version is held to ``_flash_int8``); with P
rounded to bf16 as the kernel rounds it, atol 1e-2 (P's bf16 rounding)."""

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

_SOURCE = (Path(tattn.__file__).resolve().parents[1] / "csrc" / "flash_attn_int8.cu").read_text()
CONSUMER_WGS = int(re.search(r"constexpr int kConsumerWGs = (\d+);", _SOURCE).group(1))
D128_WGS = int(re.search(r"kWGs = D == 128 \? (\d+) : kConsumerWGs;", _SOURCE).group(1))
BLOCK_N = 128
SMS = tattn.H100_SMS
MAGIC_INT, MAGIC_FLOAT = 0x4B400000, np.float32(12582912.0)  # 1.5 * 2^23


def block_m(D):
    return 64 * (D128_WGS if D == 128 else CONSUMER_WGS)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jattn.INTERPRET
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = old


def work_order(bh, nq, bm, sms=SMS):
    """Each CTA's (head, query tile) items in the order it walks them: the
    kernel's ``for (item = blockIdx.x; item < n_items; item += gridDim.x)``
    over item = b*h * n_q_tiles + query tile, on a grid of min(items, SMs)."""
    n_qt = math.ceil(nq / bm)
    n_items = bh * n_qt
    grid = min(n_items, sms)
    return [[divmod(item, n_qt) for item in range(c, n_items, grid)] for c in range(grid)]


def magic_s32_to_f32(s):
    """The ``int8_magic`` variant's conversion: the bits 0x4B400000 + s as
    a float, minus 1.5 * 2^23 (exact for |s| < 2^22)."""
    s = np.asarray(s, dtype=np.int32)
    return (s + np.int32(MAGIC_INT)).view(np.float32) - MAGIC_FLOAT


def _emulated(q8, sq, k8, sk, v, p_dtype=torch.bfloat16):
    """K8 / K9's decomposition in plain PyTorch on (B, H, N, D) operands:
    q8, k8 int8, sq, sk (B, H, N) f32, v f32 (bf16 values where the card's
    are bf16). Returns O (B, H, Nq, D) f32."""
    B, H, Nq, D = q8.shape
    Nk = k8.shape[2]
    bm = block_m(D)
    row8 = max(D, 32)  # head_dim 16: the 32-byte box's zero half
    n_qt, n_kt = math.ceil(Nq / bm), math.ceil(Nk / BLOCK_N)
    q8, k8, v = (x.reshape(B * H, x.shape[2], D) for x in (q8, k8, v))
    sq, sk = sq.reshape(B * H, Nq), sk.reshape(B * H, Nk)
    # TMA's zero rows past Nq and Nk and zero columns past D
    q8 = torch.nn.functional.pad(q8, (0, row8 - D, 0, n_qt * bm - Nq)).long()
    k8 = torch.nn.functional.pad(k8, (0, row8 - D, 0, n_kt * BLOCK_N - Nk)).long()
    v = torch.nn.functional.pad(v, (0, 0, 0, n_kt * BLOCK_N - Nk))
    sk = torch.nn.functional.pad(sk, (0, n_kt * BLOCK_N - Nk))  # the producer's zero scales
    sq = torch.nn.functional.pad(sq, (0, n_qt * bm - Nq), value=1.0)
    o = torch.full((B * H, Nq, D), math.nan)
    for cta in work_order(B * H, Nq, bm):
        for bh, qt in cta:
            rows = slice(bm * qt, bm * qt + bm)
            sq_r = sq[bh, rows, None]
            acc = torch.zeros(bm, D)
            mx = torch.full((bm, 1), -math.inf)
            l = torch.zeros(bm, 1)
            for j in range(n_kt):
                keys = slice(BLOCK_N * j, BLOCK_N * j + BLOCK_N)
                s = q8[bh, rows] @ k8[bh, keys].T  # exact integer sums
                t = s.float() * sk[bh, keys]
                if BLOCK_N * (j + 1) > Nk:  # the last tile only
                    t = torch.where(torch.arange(BLOCK_N * j, BLOCK_N * j + BLOCK_N) < Nk, t,
                                    -math.inf)
                mnew = torch.maximum(mx, t.amax(-1, keepdim=True) * sq_r)
                alpha = torch.exp2(mx - mnew)
                p = torch.exp2(t * sq_r - mnew)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.to(p_dtype).float() @ v[bh, keys]
                mx = mnew
            n = min(bm, Nq - bm * qt)  # queries past Nq are not stored
            o[bh, bm * qt:bm * qt + n] = (acc / l)[:n]
    return o.reshape(B, H, Nq, D)


def _jax_case(seed, B, H, Nq, Nk, D):
    """f32 q, k (with a non-zero mean, which the centring removes) and v as
    numpy (B, H, N, D), and JAX's own quantised operands of them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Nq, D), dtype=np.float32)
    k = rng.standard_normal((B, H, Nk, D), dtype=np.float32) + 0.5
    v = rng.standard_normal((B, H, Nk, D), dtype=np.float32)
    jq, jk = (jnp.asarray(x.reshape(B * H, -1, D)) for x in (q, k))
    q8, sq, k8, sk = (torch.from_numpy(np.array(x)) for x in jattn._quantize_qk_int8(jq, jk, Nk))
    ops = (q8.reshape(B, H, Nq, D), sq.reshape(B, H, Nq), k8.reshape(B, H, Nk, D),
           sk.reshape(B, H, Nk))
    return q, k, v, ops


def _jax_int8(q, k, v):
    """``_flash_int8`` (D < 128) or ``_flash_int8_128`` on 128-row blocks of
    the same operands: padded keys masked by n_valid, padded queries dropped."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    nq_pad, nk_pad = 128 * math.ceil(Nq / 128), 128 * math.ceil(Nk / 128)
    pad = lambda x, n: jnp.pad(jnp.asarray(x.reshape(B * H, -1, D)),  # noqa: E731
                               ((0, 0), (0, n - x.shape[2]), (0, 0)))
    fn = jattn._flash_int8_128 if D == 128 else jattn._flash_int8
    o = fn(pad(q, nq_pad), pad(k, nk_pad), pad(v, nk_pad), Nk, 128, 128)
    return np.asarray(o).reshape(B, H, nq_pad, D)[:, :, :Nq]


# ---- the work order ----

@pytest.mark.parametrize("bh,nq,D", [
    (96, 17776, 64),    # CogVideoX-5B int8 denoise: the CFG pair's 2 x 48 heads
    (64, 13740, 64),    # VGGT-1B int8 global blocks: 4 clips x 16 heads
    (24, 18480, 128),   # K9 at the Wan self-attention shape
    (70000, 24, 64),    # past CUDA's grid y limit
    (70000, 24, 128),
    (2, 1000, 16), (1, 1, 32),
])
def test_work_order_covers_every_tile_and_head_once(bh, nq, D):
    bm = block_m(D)
    n_qt = math.ceil(nq / bm)
    order = work_order(bh, nq, bm)
    assert len(order) == min(SMS, bh * n_qt)
    items = sorted(item for cta in order for item in cta)
    assert items == [(h, t) for h in range(bh) for t in range(n_qt)]
    sizes = {len(cta) for cta in order}
    assert max(sizes) - min(sizes) <= 1
    # the first wave: consecutive items, so neighbouring query tiles of one head
    assert [cta[0] for cta in order] == [divmod(i, n_qt) for i in range(len(order))]


def test_item_sizes_read_from_the_source():
    assert (block_m(64), block_m(128)) == (64 * CONSUMER_WGS, 64 * D128_WGS)
    assert CONSUMER_WGS in (2, 3) and D128_WGS == 2


# ---- the integer-add s32 -> f32 conversion (variant int8_magic) ----

@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_magic_number_conversion_is_exact_over_the_score_range(D):
    """|q8 . k8| <= D * 127^2 < 2^22 at every head dim here: the conversion
    equals float() on every integer of the range (checked exhaustively)."""
    bound = D * 127 * 127
    assert bound < 2 ** 22
    s = np.arange(-bound, bound + 1, dtype=np.int32)
    got = magic_s32_to_f32(s)
    np.testing.assert_array_equal(got, s.astype(np.float32))
    assert got.dtype == np.float32


def test_magic_number_conversion_fails_past_its_range():
    """Outside |s| < 2^22 the exponent of 1.5 * 2^23 + s changes: the trick's
    range is a real limit, and head dims up to 128 stay inside it."""
    assert magic_s32_to_f32(np.array([2 ** 22 - 1]))[0] == 2 ** 22 - 1
    assert magic_s32_to_f32(np.array([-(2 ** 22) - 1]))[0] != -(2 ** 22) - 1


# ---- the emulation against the Pallas kernels and the plain version ----

CASES = [
    (16, 1, 2, 257, 64),    # head_dim 16: the half-empty 32-byte box; short keys
    (16, 1, 2, 300, 300),
    (32, 1, 2, 130, 517),   # cross lengths, ragged last key tile
    (64, 1, 2, 300, 300),   # ragged queries and keys
    (64, 2, 1, 200, 77),    # one key tile, Nk < 128
    (128, 1, 2, 300, 300),  # K9
    (128, 1, 1, 100, 333),
]


@pytest.mark.parametrize("D,B,H,Nq,Nk", CASES)
def test_emulation_matches_the_pallas_int8_kernels(D, B, H, Nq, Nk):
    q, k, v, ops = _jax_case(3 + D + Nq, B, H, Nq, Nk, D)
    want = _jax_int8(q, k, v)
    exact_p = _emulated(*ops, torch.from_numpy(v), p_dtype=torch.float32).numpy()
    np.testing.assert_allclose(exact_p, want, atol=2e-5)
    bf16_p = _emulated(*ops, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(bf16_p, want, atol=1e-2)
    assert np.abs(want).max() > 0.1  # O of order 0.1: the atol is meaningful


@pytest.mark.parametrize("D,B,H,Nq,Nk", CASES[::2])
def test_emulation_matches_the_plain_version_with_bf16_v(D, B, H, Nq, Nk):
    """V in bf16 as on the card: the plain version rounds P to bf16 against
    the row's global max, the kernel against each tile's running max."""
    _, _, v, ops = _jax_case(5 + D + Nk, B, H, Nq, Nk, D)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    want = tattn.flash_attn_int8_reference(*ops, vb, layout="bhnd").float()
    got = _emulated(*ops, vb.float())
    torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


def test_emulation_at_extreme_logits_stays_finite():
    """q x 1e3: scores spread over ~1e3 in the base-2 exponent; the running
    max in the exponent keeps every exp2 at most 1, as the plain version."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 300, 64), dtype=np.float32))
               for _ in range(3))
    ops = tattn.quantize_qk_int8(q * 1e3, k, "bhnd")
    got = _emulated(*ops, v, p_dtype=torch.float32)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tattn.flash_attn_int8_reference(*ops, v, layout="bhnd"),
                               atol=1e-3, rtol=0)


# ---- launches at B*H = 70,000 ----

@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("entry,D", [("flash_attn_int8", 64), ("flash_attn_int8_d128", 128),
                                     ("flash_attn_int8", 16)])
def test_k8_and_k9_launch_at_70000_heads(monkeypatch, layout, entry, D):
    calls = []
    monkeypatch.setattr(tattn, "_call", lambda fn_name, name, device, *args: calls.append(
        (name, args[6:11])))

    def operands(dtype, d=D):
        shape = (2, 24, 35000, d) if layout == "bnhd" else (2, 35000, 24, d)
        return torch.empty(shape[:4] if d else shape[:3], dtype=dtype, device="meta")

    q8, k8 = operands(torch.int8), operands(torch.int8)
    sq, sk = operands(torch.float32, 0), operands(torch.float32, 0)
    v = operands(torch.bfloat16)
    head_dims = (128,) if D == 128 else tattn.KERNEL_HEAD_DIMS
    o = tattn._launch_int8(entry, head_dims, q8, sq, k8, sk, v, layout)
    assert o.shape == q8.shape and o.dtype == torch.bfloat16
    assert calls == [(entry, (2, 35000, 24, 24, D))]  # B, H, Nq, Nk, D: B*H = 70,000


def test_int8_launch_rejects_what_tma_cannot_read(monkeypatch):
    def boom(*args):
        raise AssertionError("launched")

    monkeypatch.setattr(tattn, "_call", boom)
    q8 = torch.zeros(1, 70, 2, 64, dtype=torch.int8)
    s = torch.zeros(1, 70, 2)
    v = torch.zeros(1, 70, 2, 64, dtype=torch.bfloat16)
    bad = torch.zeros(1, 70, 2, 72, dtype=torch.int8)[..., 4:68]  # base 4 bytes in
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn._launch_int8("flash_attn_int8", (64,), bad, s, q8, s, v, "bnhd")
    with pytest.raises(NotImplementedError, match="head_dim 64"):
        tattn._launch_int8("flash_attn_int8_d128", (128,), q8, s, q8, s, v, "bnhd")
    with pytest.raises(TypeError, match="bfloat16"):
        tattn._launch_int8("flash_attn_int8", (64,), q8, s, q8, s, v.float(), "bnhd")
