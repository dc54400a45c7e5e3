"""The port's layer primitives and 3D RoPE against the JAX package, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.ops import layers as JL
from videogpa_tpu.ops import rope as JR
from videogpa_torch.ops import layers as TL
from videogpa_torch.ops import rope as TR

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    rng = _rng(0)
    x = rng.standard_normal((2, 7, 24), dtype=np.float32)
    kernel = rng.standard_normal((24, 40), dtype=np.float32)  # JAX (in, out)
    b = rng.standard_normal((40,), dtype=np.float32)
    p = {"kernel": jnp.asarray(kernel)}
    if bias:
        p["bias"] = jnp.asarray(b)
    want = np.asarray(JL.linear(p, jnp.asarray(x)))
    got = TL.linear(_t(x), _t(kernel.T), _t(b) if bias else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_linear_casts_weight_to_activation_dtype():
    """A bf16 weight applied to an f32 activation computes in f32 (the time
    embedding path): the output keeps the activation's dtype."""
    w = torch.randn(8, 4).to(torch.bfloat16)
    x = torch.randn(3, 4)
    y = TL.Linear(4, 8, dtype=torch.bfloat16)
    with torch.no_grad():
        y.weight.copy_(w)
    assert y(x).dtype == torch.float32
    torch.testing.assert_close(y(x), x @ w.float().T + y.bias.float())


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_matches_jax(eps, affine):
    rng = _rng(1)
    x = (rng.standard_normal((2, 5, 3, 16), dtype=np.float32) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)} if affine else {}
    want = np.asarray(JL.layernorm(p, jnp.asarray(x), eps=eps))
    got = TL.layernorm(_t(x), _t(scale) if affine else None,
                       _t(bias) if affine else None, eps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride,padding", [(2, 0), (1, 1)])
def test_conv2d_matches_jax(stride, padding):
    rng = _rng(2)
    x = rng.standard_normal((3, 4, 8, 12), dtype=np.float32)
    k_hwio = rng.standard_normal((2, 2, 4, 6), dtype=np.float32) if stride == 2 else \
        rng.standard_normal((3, 3, 4, 6), dtype=np.float32)
    b = rng.standard_normal(6, dtype=np.float32)
    want = np.asarray(JL.conv2d({"kernel": jnp.asarray(k_hwio), "bias": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride, padding=padding))
    got = TL.conv2d(_t(x), _t(k_hwio.transpose(3, 2, 0, 1)), _t(b),
                    stride=stride, padding=padding).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_gelu_tanh_matches_jax():
    x = _rng(3).standard_normal(1000, dtype=np.float32) * 4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(TL.gelu_tanh(_t(x)).numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("grid,hd", [((3, 4, 6), 16), ((2, 3, 5), 32), ((13, 3, 4), 64)])
def test_rope_3d_freqs_match_jax(grid, hd):
    jc, js = JR.rope_3d_freqs(grid, hd)
    tc, ts = TR.rope_3d_freqs(grid, hd)
    assert tc.shape == (grid[0] * grid[1] * grid[2], hd) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_apply_rope_interleaved_matches_jax(layout):
    grid, hd = (3, 4, 6), 32
    n = grid[0] * grid[1] * grid[2]
    shape = (2, 3, n, hd) if layout == "bhnd" else (2, n, 3, hd)
    x = _rng(4).standard_normal(shape, dtype=np.float32)
    jc, js = JR.rope_3d_freqs(grid, hd)
    tc, ts = TR.rope_3d_freqs(grid, hd)
    if layout == "bnhd":  # broadcast over the heads axis, as the DiT does
        jc, js, tc, ts = jc[:, None], js[:, None], tc[:, None], ts[:, None]
    want = np.asarray(JR.apply_rope_interleaved(jnp.asarray(x), jc, js))
    got = TR.apply_rope_interleaved(_t(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        TR.rotate_interleaved(_t(x)).numpy(), np.asarray(JR.rotate_interleaved(jnp.asarray(x))))
