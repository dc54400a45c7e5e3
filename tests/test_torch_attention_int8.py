"""The int8-QK attention of the port (``quantize_qk_int8``, the plain version
of K8 and K9, and ``attention(impl="flash_int8")``'s routing) against the JAX
package's (``_quantize_qk_int8``, ``_flash_int8`` and ``_flash_int8_128`` in
Pallas interpret mode) on the CPU in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
import videogpa_torch.ops.attention as tattn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    """The JAX package's Pallas kernels in interpret mode, restored after."""
    old = jattn.INTERPRET
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = old


def _qkv(seed, shape, k_shift=0.5, nk=None):
    rng = np.random.default_rng(seed)
    kshape = shape if nk is None else shape[:2] + (nk,) + shape[3:]
    q = rng.standard_normal(shape, dtype=np.float32)
    k = rng.standard_normal(kshape, dtype=np.float32) + k_shift  # non-zero mean: the centring
    v = rng.standard_normal(kshape, dtype=np.float32)
    return q, k, v


def _cos_rel(got, want):
    cos = np.sum(got * want) / np.sqrt(np.sum(got * got) * np.sum(want * want))
    return cos, np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# quantize_qk_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("D,dtype", [(64, torch.float32), (16, torch.float32),
                                     (64, torch.bfloat16)])
def test_quantize_qk_int8_matches_jax(layout, D, dtype):
    """Scales within f32 rounding (rtol 1e-6); integers equal but for +-1
    where ``x / s`` lands within an ulp of a rounding tie, on < 0.1 % of the
    entries (the sums of K's mean run in another order)."""
    B, H, Nq, Nk = 2, 3, 150, 211
    q, k, _ = _qkv(1, (B, H, Nq, D), nk=Nk)
    tq, tk = torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype)
    jq = jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    jk = jnp.asarray(tk.float().numpy()).astype(jq.dtype)
    want = jattn._quantize_qk_int8(jq.reshape(B * H, Nq, D), jk.reshape(B * H, Nk, D), Nk)
    if layout == "bnhd":
        tq, tk = tq.transpose(1, 2).contiguous(), tk.transpose(1, 2).contiguous()
    got = tattn.quantize_qk_int8(tq, tk, layout)
    if layout == "bnhd":
        got = [x.transpose(1, 2) for x in got]
    q8, sq, k8, sk = (x.numpy() for x in got)
    assert q8.dtype == np.int8 and k8.dtype == np.int8
    assert sq.dtype == np.float32 and sq.shape == (B, H, Nq) and sk.shape == (B, H, Nk)
    np.testing.assert_allclose(sq.reshape(B * H, Nq, 1), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(sk.reshape(B * H, Nk, 1), np.asarray(want[3]), rtol=1e-6)
    for mine, theirs in ((q8, want[0]), (k8, want[2])):
        d = np.abs(mine.reshape(theirs.shape).astype(np.int32) - np.asarray(theirs, np.int32))
        assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(), (d != 0).mean())
    assert np.abs(q8).max() == 127 and np.abs(k8).max() == 127


def test_quantize_qk_int8_centres_k_over_the_sequence_axis_of_either_layout():
    q, k, _ = _qkv(2, (1, 2, 40, 32), k_shift=3.0)
    _, _, k8, sk = tattn.quantize_qk_int8(torch.from_numpy(q), torch.from_numpy(k), "bhnd")
    centred = (k8.float() * sk[..., None]).mean(dim=2)
    assert centred.abs().max() < 0.05  # the shift of 3 is gone
    got = tattn.quantize_qk_int8(torch.from_numpy(q).transpose(1, 2),
                                 torch.from_numpy(k).transpose(1, 2), "bnhd")
    assert torch.equal(got[2].transpose(1, 2), k8) and torch.equal(got[3].transpose(1, 2), sk)
    with pytest.raises(ValueError):
        tattn.quantize_qk_int8(torch.from_numpy(q), torch.from_numpy(k), "nbhd")


# ---------------------------------------------------------------------------
# The plain version of K8 / K9 against the Pallas kernels
# ---------------------------------------------------------------------------

def test_int8_attention_matches_jax_flash_int8():
    """``tests/test_ops.py::test_int8_qk_close_to_reference``'s case, (1, 4,
    300, 64) with K + 0.5, f32: the port's ``attention(impl="flash_int8")``
    against the JAX one in interpret mode within atol 2e-4, and against exact
    attention with the JAX test's limits."""
    q, k, v = _qkv(8, (1, 4, 300, 64))
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      impl="flash_int8", block_q=128, block_k=128))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          impl="flash_int8").numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    exact = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v)).numpy()
    cos, rel = _cos_rel(got, exact)
    assert cos > 0.999 and rel < 0.02, (cos, rel)


@pytest.mark.parametrize("D,Nq,Nk", [(64, 300, 300), (32, 130, 517), (16, 257, 64)])
def test_int8_reference_on_jax_operands_matches_the_t8_kernel(D, Nq, Nk):
    """The same quantised operands through both: ``_flash_int8`` quantises
    inside, so the port's plain version takes JAX's own q8, sq, k8, sk. What
    is left is f32 summation order and exp2: atol 2e-5."""
    B, H = 1, 2
    q, k, v = _qkv(9, (B, H, Nq, D), nk=Nk)
    jq, jk, jv = (jnp.asarray(x).reshape(B * H, -1, D) for x in (q, k, v))
    bq, bk, Nq_p, Nk_p = jattn._block_geometry(Nq, Nk, 128, 128, D)
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0)))  # noqa: E731
    want = np.asarray(jattn._flash_int8(pad(jq, Nq_p), pad(jk, Nk_p), pad(jv, Nk_p), Nk, bq, bk)
                      )[:, :Nq].reshape(B, H, Nq, D)
    q8, sq, k8, sk = (torch.from_numpy(np.array(x)) for x in jattn._quantize_qk_int8(jq, jk, Nk))
    got = tattn.flash_attn_int8(q8.reshape(B, H, Nq, D), sq.reshape(B, H, Nq),
                                k8.reshape(B, H, Nk, D), sk.reshape(B, H, Nk),
                                torch.from_numpy(v), layout="bhnd")
    assert got.shape == (B, H, Nq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_int8_d128_matches_jax_flash_int8_128():
    """``tests/test_ops.py::test_int8_qk_head_dim_128_kernel``'s case: (2, 300,
    128) padded to 384 for the Pallas kernel, ragged and unpadded in the
    port. On JAX's own quantised operands the plain version agrees within
    atol 2e-5. Through the port's ``quantize_qk_int8`` an integer of k that
    flips at a rounding tie moves that key's weight in every row, by up to
    ~6e-4 here: 99 % of the entries within 2e-4, all within 1e-3. And the JAX
    test's limits against exact attention."""
    q, k, v = _qkv(10, (1, 2, 300, 128))
    pad = [(0, 0), (0, 384 - 300), (0, 0)]
    want = np.asarray(jattn._flash_int8_128(
        jnp.pad(jnp.asarray(q[0]), pad), jnp.pad(jnp.asarray(k[0]), pad),
        jnp.pad(jnp.asarray(v[0]), pad), 300, 128, 128))[:, :300]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    q8, sq, k8, sk = (torch.from_numpy(np.array(x))[None] for x in jattn._quantize_qk_int8(
        jnp.asarray(q[0]), jnp.asarray(k[0]), 300))
    same_ops = tattn.flash_attn_int8_d128(q8, sq[..., 0], k8, sk[..., 0], tv, layout="bhnd")
    np.testing.assert_allclose(same_ops.numpy()[0], want, atol=2e-5)
    got = tattn.flash_attn_int8_d128(*tattn.quantize_qk_int8(tq, tk, "bhnd"), tv,
                                     layout="bhnd").numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert (np.abs(got - want) <= 2e-4).mean() > 0.99
    cos, rel = _cos_rel(got, tattn.mha_reference(tq, tk, tv).numpy()[0])
    assert cos > 0.999 and rel < 0.02, (cos, rel)


@pytest.mark.parametrize("case", ["contiguous", "packed_qkv_views", "projection_views"])
def test_int8_reference_layouts_and_strided_operands_agree(case):
    """bnhd and bhnd give the same numbers, from contiguous tensors and from
    the strided views the models feed (no copy is asked of the caller)."""
    B, N, H, D = 2, 70, 3, 32
    rng = np.random.default_rng(11)
    if case == "packed_qkv_views":  # the ViT block: (B, N, 3, H, D).unbind(2)
        q, k, v = torch.from_numpy(rng.standard_normal((B, N, 3, H, D), dtype=np.float32)
                                   ).unbind(2)
    elif case == "projection_views":  # the Wan DiT: (B, N, H*D) viewed as (B, N, H, D)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, N, H * D), dtype=np.float32)
                                    ).reshape(B, N, H, D) for _ in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, N, H, D), dtype=np.float32))
                   for _ in range(3))
    a = tattn.flash_attn_int8(*tattn.quantize_qk_int8(q, k, "bnhd"), v, layout="bnhd")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b = tattn.flash_attn_int8(*tattn.quantize_qk_int8(qt, kt, "bhnd"), vt, layout="bhnd")
    assert a.shape == (B, N, H, D) and b.shape == (B, H, N, D)
    assert a.is_contiguous() and b.is_contiguous()
    np.testing.assert_allclose(a.numpy(), b.transpose(1, 2).numpy(), atol=1e-6)
    cos, rel = _cos_rel(a.numpy(), tattn.flash_attn_fwd_reference(q, k, v, "bnhd")[0].numpy())
    assert cos > 0.999 and rel < 0.02, (cos, rel)


@pytest.mark.parametrize("case", ["q_times_1e3", "one_huge_key"])
def test_int8_extreme_logits_stay_finite_and_equal_an_independent_softmax(case):
    """The port's int8 forward is a plain online softmax of the quantised
    scores: where the JAX package would leave its lagged-max kernel for the
    exact bf16 one (a jump above 2^110 between key blocks), the port returns
    the int8-QK result. It stays finite and equals a float64 softmax of the
    same quantised scores: atol 1e-5, and 1e-3 with q x 1e3, where the f32
    scores reach ~1e3 and carry ~6e-5 of rounding in the base-2 exponent."""
    q, k, v = _qkv(12, (1, 2, 300, 64))
    if case == "q_times_1e3":
        q = q * 1e3
    else:
        k[:, :, -1, :] = 40.0  # a huge jump in the last key block
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    q8, sq, k8, sk = tattn.quantize_qk_int8(tq, tk, "bhnd")
    got = tattn.attention(tq, tk, tv, impl="flash_int8")
    assert torch.isfinite(got).all()
    s = (q8.double() @ k8.double().transpose(-1, -2)) * sq.double()[..., None] \
        * sk.double()[..., None, :]
    want = torch.softmax(s * np.log(2.0), dim=-1) @ tv.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=1e-3 if case == "q_times_1e3" else 1e-5)
    if case == "q_times_1e3":  # scores spread over ~1e3 in the base-2 exponent
        assert (s.amax(-1) - s.amin(-1)).max() > 500


# ---------------------------------------------------------------------------
# Routing of attention(impl="flash_int8")
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Names of the kernel wrappers ``attention`` reaches, in order."""
    seen = []
    for name in ("flash_attn_fwd", "flash_attn_short", "flash_attn_fwd_d128",
                 "flash_attn_fwd_f32", "flash_attn_int8", "flash_attn_int8_d128"):
        inner = getattr(tattn, name)

        def spy(*args, _inner=inner, _name=name, **kwargs):
            seen.append(_name)
            return _inner(*args, **kwargs)

        monkeypatch.setattr(tattn, name, spy)
    return seen


@pytest.mark.parametrize("dtype,exact", [(torch.bfloat16, "flash_attn_fwd_d128"),
                                         (torch.float32, "flash_attn_fwd_f32")])
@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_flash_int8_at_head_dim_128_is_the_exact_kernel_bit_for_bit(calls, dtype, exact, layout):
    """``tests/test_ops.py::test_int8_head_dim_128_dispatches_exact``'s rule:
    K9 is not dispatched."""
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(13, (1, 2, 300, 128)))
    if layout == "bnhd":
        q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    got = tattn.attention(q, k, v, impl="flash_int8", layout=layout)
    want = tattn.attention(q, k, v, impl="flash", layout=layout)
    assert calls == [exact, exact]
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_int8_short_bnhd_rows_take_the_short_row_kernel(calls, dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(14, (2, 300, 4, 64)))  # bnhd
    got = tattn.attention(q, k, v, impl="flash_int8", layout="bnhd")
    assert torch.equal(got, tattn.flash_attn_short_reference(q, k, v))
    assert torch.equal(got, tattn.attention(q, k, v, impl="flash", layout="bnhd"))
    assert calls[0] == ("flash_attn_short" if dtype == torch.bfloat16 else "flash_attn_fwd_f32")
    assert "flash_attn_int8" not in calls


@pytest.mark.parametrize("layout,N", [("bnhd", 2100), ("bhnd", 300), ("bhnd", 2100)])
def test_flash_int8_long_or_bhnd_rows_take_the_int8_kernel(calls, layout, N):
    """Past the short-row limit of 2,048 keys in bnhd, and at any length in
    bhnd (the short-row kernel is a bnhd one), D < 128 goes to K8."""
    shape = (1, N, 2, 32) if layout == "bnhd" else (1, 2, N, 32)
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) for _ in range(3))
    got = tattn.attention(q, k, v, impl="flash_int8", layout=layout)
    assert calls == ["flash_attn_int8"]
    assert got.shape == q.shape and got.dtype == q.dtype
    exact = tattn.attention(q, k, v, impl="flash", layout=layout)
    cos, rel = _cos_rel(got.numpy(), exact.numpy())
    assert cos > 0.999 and rel < 0.02, (cos, rel)


def test_flash_int8_cross_attention_lengths(calls):
    q, k, v = _qkv(16, (1, 2, 333, 32), nk=77)
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)), impl="flash_int8")
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      impl="flash_int8", block_q=128, block_k=128))
    assert calls == ["flash_attn_int8"] and got.shape == (1, 2, 333, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_flash_int8_raises_under_grad_and_ring_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(17, (1, 2, 40, 32)))
    for needs in (q, k, v):
        needs.requires_grad_(True)
        with pytest.raises(RuntimeError, match="inference only"):
            tattn.attention(q, k, v, impl="flash_int8")
        with torch.no_grad():  # no graph is asked for: the forward runs
            assert torch.isfinite(tattn.attention(q, k, v, impl="flash_int8")).all()
        needs.requires_grad_(False)
    with pytest.raises(ValueError, match="ring"):  # no ambient mesh with a 'seq' axis
        tattn.attention(q, k, v, impl="ring")
    with pytest.raises(ValueError):
        tattn.flash_attn_int8(*tattn.quantize_qk_int8(q, k), v, layout="nbhd")


def test_int8_wrappers_count_no_launch_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(18, (1, 2, 40, 128)))
    before = (tattn.flash_attn_int8.launches, tattn.flash_attn_int8_d128.launches)
    ops = tattn.quantize_qk_int8(q, k)
    assert torch.equal(tattn.flash_attn_int8_d128(*ops, v, layout="bhnd"),
                       tattn.flash_attn_int8_reference(*ops, v, layout="bhnd"))
    tattn.flash_attn_int8(*tattn.quantize_qk_int8(q[..., :64], k[..., :64]), v[..., :64],
                          layout="bhnd")
    assert (tattn.flash_attn_int8.launches, tattn.flash_attn_int8_d128.launches) == before
