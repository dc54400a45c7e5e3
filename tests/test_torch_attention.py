"""The port's attention (CPU -> plain version of the CUDA kernel) against the
JAX package's flash attention, run in Pallas interpret mode."""

import jax
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


def _randn(seed, *shapes, scale_q=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in shapes)
    return q * np.float32(scale_q), k, v


def _both(q, k, v, layout):
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           impl="flash", layout=layout)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          impl="flash", layout=layout)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("n", [128, 257, 300])
def test_attention_matches_jax(n, d, layout):
    shape = (2, 4, n, d) if layout == "bhnd" else (2, n, 4, d)
    got, want = _both(*_randn(n * d, shape, shape, shape), layout)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("nq,nk", [(100, 220), (300, 64)])
def test_cross_lengths_match_jax(nq, nk, layout):
    if layout == "bhnd":
        sq, skv = (1, 2, nq, 32), (1, 2, nk, 32)
    else:
        sq, skv = (1, nq, 2, 32), (1, nk, 2, 32)
    got, want = _both(*_randn(nq + nk, sq, skv, skv), layout)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n_valid", [None, 200])
def test_mha_reference_matches_jax(n_valid):
    s = (2, 3, 257, 32)
    q, k, v = _randn(21, s, s, s)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_valid=n_valid)
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              n_valid=n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _planted_extreme_key():
    """The inputs of test_ops.py::test_lagged_max_fallback_on_extreme_logits."""
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(7), 3)
    q = jax.random.normal(kq, (1, 2, 300, 64))
    k = jax.random.normal(kk, (1, 2, 300, 64)).at[:, :, -1, :].set(40.0)
    v = jax.random.normal(kv, (1, 2, 300, 64))
    return tuple(np.array(x) for x in (q, k, v))


@pytest.mark.parametrize("case", ["planted_key", "q_times_1e3"])
def test_extreme_logits_match_jax(case):
    if case == "planted_key":
        q, k, v = _planted_extreme_key()
    else:
        shape = (1, 2, 300, 64)
        q, k, v = _randn(3, shape, shape, shape, scale_q=1e3)
    got, want = _both(q, k, v, "bhnd")
    # q x 1e3 gives logits ~1e4 whose f32 rounding (~1e-3) differs between
    # the two summation orders; softmax weights move by that much relatively
    atol = 2e-5 if case == "planted_key" else 2e-3
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.isfinite(got).all()


def _jax_lse(q, k, v):
    """LSE of ``_flash_fwd_guarded`` on operands padded as ``attention()`` pads them."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    bq, bk, Nq_p, Nk_p = jattn._block_geometry(Nq, Nk, 1024, 2048, D)

    def pad(x, n_to):
        x = jnp.asarray(x)
        return jnp.pad(x, ((0, 0), (0, 0), (0, n_to - x.shape[2]), (0, 0)))

    qp = pad(q, Nq_p).reshape(B * H, Nq_p, D)
    kp = pad(k, Nk_p).reshape(B * H, Nk_p, D)
    vp = pad(v, Nk_p).reshape(B * H, Nk_p, D)
    _, lse = jattn._flash_fwd_guarded(qp, kp, vp, Nk, bq, bk, with_lse=True)
    return np.asarray(lse)[:, :Nq, 0].reshape(B, H, Nq)


@pytest.mark.parametrize("case", ["self_300_d64", "cross_100_220_d32", "planted_key"])
def test_lse_matches_jax(case):
    if case == "self_300_d64":
        s = (2, 3, 300, 64)
        q, k, v = _randn(11, s, s, s)
    elif case == "cross_100_220_d32":
        q, k, v = _randn(12, (1, 2, 100, 32), (1, 2, 220, 32), (1, 2, 220, 32))
    else:
        q, k, v = _planted_extreme_key()
    want = _jax_lse(q, k, v)
    o, lse = tattn.flash_attn_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                  layout="bhnd", with_lse=True)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=1e-6)
    # the bnhd layout gives the same O (transposed) and LSE
    o2, lse2 = tattn.flash_attn_fwd(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                                    layout="bnhd", with_lse=True)
    assert o2.is_contiguous() and o2.shape == (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    torch.testing.assert_close(o2.transpose(1, 2), o, atol=0, rtol=0)
    torch.testing.assert_close(lse2, lse, atol=0, rtol=0)


def test_cpu_tensor_never_reaches_the_cuda_module(monkeypatch):
    def boom(name):
        raise AssertionError(f"CUDA kernel {name} requested for CPU tensors")

    monkeypatch.setattr(_kernels, "kernel", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    before = tattn.flash_attn_fwd.launches
    x = torch.randn(1, 70, 2, 16)
    o, lse = tattn.flash_attn_fwd(x, x, x, layout="bnhd", with_lse=True)
    o2 = tattn.attention(x, x, x, impl="auto", layout="bnhd")
    assert o.shape == x.shape and lse.shape == (1, 2, 70)
    torch.testing.assert_close(o2, o, atol=0, rtol=0)
    assert tattn.flash_attn_fwd.launches == before


def test_unported_impl_and_layout_raise():
    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="mesh"):  # ring needs an ambient mesh with 'seq'
        tattn.attention(x, x, x, impl="ring")
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(x, x, x, impl="xla")
    with pytest.raises(ValueError):
        tattn.flash_attn_fwd(x, x, x, layout="nbhd")


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU error path does not apply")
    from videogpa_torch import resolve_device
    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        dit_init(CogVideoXConfig.tiny())
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels._nvcc()
    path = _kernels.library_path("flash_attn_fwd")
    assert path.parent == _kernels.BUILD_DIR and path.name.startswith("flash_attn_fwd-")
    assert path == _kernels.library_path("flash_attn_fwd")
