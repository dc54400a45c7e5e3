"""The port's CogVideoX 3D-causal VAE against the JAX package's on the CPU, in
f32 with the same weights (a JAX ``vae_init``-shaped tree through the bridge)
and the same posterior draws: every primitive, ``vae_encode`` sampled and
deterministic, ``vae_decode``, both tiled paths, and the properties
``tests/test_cogvideox.py::TestVAE`` / ``TestVAETiling`` pin."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.models.cogvideox.vae as jv
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.cogvideox import CogVideoXConfig
from videogpa_torch.models.cogvideox import vae as tv
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)

CFG = CogVideoXConfig.tiny()
JCFG = JaxConfig(**dataclasses.asdict(CFG))
# f32 on both sides, one convolution stack: differences are summation order
RTOL, ATOL = 1e-4, 1e-4
# the JAX encode and decode jitted: eager, they run op by op
_j_vae_encode = jax.jit(jv.vae_encode, static_argnums=(2,), static_argnames=("sample",))
_j_vae_decode = jax.jit(jv.vae_decode, static_argnums=(2,))


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol * scale)


@pytest.fixture(scope="module")
def trees():
    jt = random_jax_tree(jv.vae_init, JCFG)
    return jt, load_jax_params(tv.CogVideoXVAE(CFG), jt).eval().requires_grad_(False)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_vae_init_tree_loads_and_random_init_is_bounded(trees):
    jt, m = trees  # the fixture loaded strictly: every key on both sides
    assert sum(p.numel() for p in m.parameters()) == sum(a.size for a in jax.tree.leaves(jt))
    r = tv.vae_init(CFG, torch.Generator().manual_seed(1), device="cpu")
    w = r.encoder.conv_in.weight
    assert float(w.abs().max()) <= (3 * 27) ** -0.5 and float(w.std()) > 0
    assert bool((r.decoder.norm_out.norm.weight == 1).all())


def test_causal_conv3d_matches_jax_and_is_causal(trees):
    jt, m = trees
    x = _rand((1, 3, 7, 8, 10), 1)
    _close(tv.causal_conv3d(m.encoder.conv_in, _t(x)),
           jv.causal_conv3d(jt["encoder"]["conv_in"], jnp.asarray(x)))
    x2 = x.copy()
    x2[:, :, 4:] = 0.0
    y1 = tv.causal_conv3d(m.encoder.conv_in, _t(x))
    y2 = tv.causal_conv3d(m.encoder.conv_in, _t(x2))
    torch.testing.assert_close(y1[:, :, :4], y2[:, :, :4], rtol=0, atol=1e-6)
    assert not torch.allclose(y1[:, :, 4:], y2[:, :, 4:])


@pytest.mark.parametrize("channels", [32, 12, 8])
def test_groupnorm_population_variance_matches_jax(channels):
    x = _rand((2, channels, 3, 5, 4), 2) * 3.0 + 1.5
    scale, bias = 1.0 + 0.1 * _rand((channels,), 3), 0.1 * _rand((channels,), 4)
    norm = torch.nn.GroupNorm(1, channels)
    norm.weight.data, norm.bias.data = _t(scale), _t(bias)
    want = jv.groupnorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                        jnp.asarray(x))
    _close(tv.groupnorm(norm, _t(x)), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [(5, 8, 12), (9, 7, 11), (3, 4, 6), (1, 3, 5)])
def test_resize_zq_picks_jax_indices(target):
    zq = _rand((1, 2, 3 if target[0] > 1 else 1, 4, 6), 5)
    got = tv._resize_zq(_t(zq), *target)
    want = np.asarray(jv._resize_zq(jnp.asarray(zq), *target))
    np.testing.assert_array_equal(got.numpy(), want)  # a gather: bit for bit


def test_spatial_norm_and_resnets_match_jax(trees):
    jt, m = trees
    z = _rand((1, 4, 2, 3, 4), 6)
    f = _rand((1, 32, 5, 6, 8), 7)
    _close(tv.spatial_norm(m.decoder.mid.resnets[0].norm1, _t(f), _t(z)),
           jv.spatial_norm(jt["decoder"]["mid"]["resnets"][0]["norm1"], jnp.asarray(f),
                           jnp.asarray(z)))
    _close(tv._resnet(m.decoder.mid.resnets[0], _t(f), _t(z)),
           jv._resnet(jt["decoder"]["mid"]["resnets"][0], jnp.asarray(f), jnp.asarray(z)))
    # a shortcut conv (8 -> 16 channels) without the z-conditioning
    h = _rand((1, 8, 5, 6, 8), 8)
    _close(tv._resnet(m.encoder.down[1].resnets[0], _t(h), None),
           jv._resnet(jt["encoder"]["down"][1]["resnets"][0], jnp.asarray(h), None))


@pytest.mark.parametrize("compress_time", [True, False])
def test_down_and_upsample_match_jax(trees, compress_time):
    jt, m = trees
    x = _rand((1, 8, 5, 6, 10), 9)
    _close(tv._downsample(m.encoder.down[0].downsample, _t(x), compress_time),
           jv._downsample(jt["encoder"]["down"][0]["downsample"], jnp.asarray(x),
                          compress_time))
    y = _rand((1, 32, 3, 3, 5), 10)
    _close(tv._upsample(m.decoder.up[0].upsample, _t(y), compress_time),
           jv._upsample(jt["decoder"]["up"][0]["upsample"], jnp.asarray(y), compress_time))


def _posterior_noise(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("invert", [False, True])
def test_vae_encode_sampled_and_deterministic_match_jax(trees, invert):
    jt, m = trees
    cfg = dataclasses.replace(CFG, vae_invert_scale_latents=invert)
    jcfg = dataclasses.replace(JCFG, vae_invert_scale_latents=invert)
    # one tiled-encode tile's shape (test_tiled_encode_matches_jax): the JAX
    # package's op-by-op compiles are shared
    vid = np.clip(_rand((1, 3, 5, 64, 64), 11), -1, 1)
    det = tv.vae_encode(m, _t(vid), cfg, sample=False)
    assert det.shape == (1, CFG.vae_latent_channels, 2, 8, 8)
    _close(det, _j_vae_encode(jt, jnp.asarray(vid), jcfg, sample=False))
    key = jax.random.PRNGKey(3)
    noise = _posterior_noise(key, det.shape)
    _close(tv.vae_encode(m, _t(vid), cfg, noise=_t(noise)),
           _j_vae_encode(jt, jnp.asarray(vid), jcfg, key=key, sample=True))
    # deterministic mode is deterministic; sampling needs a draw
    torch.testing.assert_close(tv.vae_encode(m, _t(vid), cfg, sample=False), det,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise or a generator"):
        tv.vae_encode(m, _t(vid), cfg)


def test_vae_decode_matches_jax_and_roundtrip_shapes(trees):
    jt, m = trees
    lat = _rand((1, CFG.vae_latent_channels, 2, 8, 8), 12)  # one tiled-decode tile
    got = tv.vae_decode(m, _t(lat), CFG)
    assert got.shape == (1, 3, 5, 64, 64)
    _close(got, _j_vae_decode(jt, jnp.asarray(lat), JCFG))
    vid = tv.vae_decode(m, tv.vae_encode(m, got, CFG, sample=False), CFG)
    assert vid.shape == got.shape and bool(torch.isfinite(vid).all())


def test_tiled_decode_matches_jax_and_the_per_tile_blend(trees):
    """The tile loop against JAX's single-program scan, and against the
    straightforward per-tile decode + numpy weighted blend."""
    jt, m = trees
    lat = _rand((1, CFG.vae_latent_channels, 2, 12, 16), 13)
    th = tw = 8
    overlap, sc = 4, CFG.spatial_compression_ratio
    got = tv.vae_decode_tiled(m, _t(lat), CFG, tile_latent=th, overlap_latent=overlap)
    assert got.dtype == torch.float32 and got.shape == (1, 3, 5, 96, 128)
    _close(got, jv.vae_decode_tiled(jt, jnp.asarray(lat), JCFG, tile_latent=th,
                                    overlap_latent=overlap))

    pos_h = tv._tile_positions(12, th, overlap)
    pos_w = tv._tile_positions(16, tw, overlap)
    acc = np.zeros(got.shape, np.float32)
    wacc = np.zeros(got.shape[-2:], np.float32)
    for hi, i0 in enumerate(pos_h):
        for wi, j0 in enumerate(pos_w):
            tile = tv.vae_decode(m, _t(lat[:, :, :, i0:i0 + th, j0:j0 + tw]), CFG).numpy()
            wh = tv._ramp_1d_np(th * sc, hi == 0, hi == len(pos_h) - 1)
            ww = tv._ramp_1d_np(tw * sc, wi == 0, wi == len(pos_w) - 1)
            wmap = wh[:, None] * ww[None, :]
            oi, oj = i0 * sc, j0 * sc
            acc[..., oi:oi + th * sc, oj:oj + tw * sc] += tile * wmap
            wacc[oi:oi + th * sc, oj:oj + tw * sc] += wmap
    np.testing.assert_allclose(got.numpy(), acc / np.maximum(wacc, 1e-8), rtol=1e-5, atol=1e-6)
    # a grid no larger than the tile decodes whole
    small = lat[:, :, :, :8, :8]
    torch.testing.assert_close(tv.vae_decode_tiled(m, _t(small), CFG, tile_latent=8),
                               tv.vae_decode(m, _t(small), CFG), rtol=0, atol=0)


def test_tile_helpers_equal_jax():
    for size, tile, overlap in [(60, 32, 8), (90, 32, 8), (90, 16, 8), (12, 8, 4), (7, 8, 2)]:
        assert tv._tile_positions(size, tile, overlap) == jv._tile_positions(size, tile, overlap)
    for first in (True, False):
        for last in (True, False):
            np.testing.assert_array_equal(tv._ramp_1d_np(40, first, last),
                                          jv._ramp_1d_np(40, first, last))
    grid = tv._tile_grid(60, 90, 32, 32, 8)
    assert grid == jv._tile_grid(60, 90, 32, 32, 8) and len(grid[2]) == 12


@pytest.mark.parametrize("sample", [False, True])
def test_tiled_encode_matches_jax(trees, sample):
    jt, m = trees
    vid = np.clip(_rand((1, 3, 5, 96, 128), 14), -1, 1)
    key = jax.random.PRNGKey(5)
    want = jv.vae_encode_tiled(jt, jnp.asarray(vid), JCFG, key=key, sample=sample,
                               tile_pixels=64, overlap_pixels=32)
    noise = None
    if sample:
        # one draw a tile in grid order, from JAX's per-tile keys
        n_tiles = len(tv._tile_positions(12, 8, 4)) * len(tv._tile_positions(16, 8, 4))
        keys = jax.random.split(key, n_tiles)
        noise = [_t(_posterior_noise(k, (1, CFG.vae_latent_channels, 2, 8, 8))) for k in keys]
    got = tv.vae_encode_tiled(m, _t(vid), CFG, noise=noise, sample=sample,
                              tile_pixels=64, overlap_pixels=32)
    assert got.shape == (1, CFG.vae_latent_channels, 2, 12, 16)
    _close(got, want)
