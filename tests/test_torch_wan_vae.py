"""The port's Wan2.2 VAE (``videogpa_torch/models/wan/vae.py``) against the
JAX package's ``wan_vae_encode`` / ``wan_vae_decode`` on ``WanConfig.tiny()``
(32 x 32 frames) in f32 on the CPU.

Both hold the same weights: the state dict of ``tests/test_wan_vae_parity.
py``'s streaming oracle (the upstream key layout), through the JAX
converter on one side and the port's on the other, with non-trivial latent
statistics. Encode (the posterior mean, and a sample with the JAX package's
draw injected) and decode at T = 1, 5 and 9, in the streaming form (chunks
of 1, 4, 4 frames; one latent frame) and in the full-sequence form. The
parameter-free shuffles match exactly; ``wan_vae_init`` has the JAX tree.

Tolerance: max |delta| <= 1e-4 (f32 on both sides; the convolutions sum in
other orders, a few 1e-6 through the tiny VAE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_wan_vae_parity import WanVAEOracle
from videogpa_tpu.models.wan import convert as jconvert
from videogpa_tpu.models.wan import vae as jvae
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.loader import _module_from_state_dict
from videogpa_torch.models.wan import WanConfig
from videogpa_torch.models.wan import vae as tvae
from videogpa_torch.models.wan.convert import convert_wan_vae

torch.set_num_threads(2)
CFG = WanConfig.tiny()
JCFG = JaxWanConfig(**dataclasses.asdict(CFG))
ATOL = 1e-4


@pytest.fixture(scope="module")
def vaes():
    """(JAX params, the port's WanVAE) holding the oracle's weights."""
    torch.manual_seed(0)
    oracle = WanVAEOracle(dim=CFG.vae_base_ch, dec_dim=CFG.vae_dec_base_ch, z_dim=CFG.vae_z_dim,
                          dim_mult=CFG.vae_dim_mult, n_res=CFG.vae_num_res_blocks,
                          t_down=CFG.vae_temporal_down)
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    rng = np.random.default_rng(0)
    mean = rng.standard_normal(CFG.vae_z_dim).astype(np.float32) * 0.3
    std = 1.0 + 0.2 * rng.standard_normal(CFG.vae_z_dim).astype(np.float32) ** 2
    params = jconvert.convert_wan_vae(sd, JCFG, latents_mean=mean, latents_std=std)
    model = _module_from_state_dict(tvae.WanVAE, CFG, convert_wan_vae(sd, CFG, mean, std),
                                    "cpu", torch.float32)
    return params, model


def _video(T, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, 3, T, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("T", [1, 5, 9])
def test_encode_matches_jax(vaes, T):
    params, model = vaes
    vid = _video(T, 10 + T)
    want = np.asarray(jvae.wan_vae_encode(params, jnp.asarray(vid), JCFG))
    assert want.shape == (1, CFG.vae_z_dim, 1 + (T - 1) // 4, 2, 2)
    for stream in (True, False):
        got = tvae.wan_vae_encode(model, torch.from_numpy(vid), CFG, stream=stream).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"stream={stream}")


@pytest.mark.parametrize("T", [1, 9])
def test_encode_sample_matches_jax_with_its_draw(vaes, T):
    params, model = vaes
    vid = _video(T, 20 + T)
    key = jax.random.PRNGKey(T)
    want = np.asarray(jvae.wan_vae_encode(params, jnp.asarray(vid), JCFG, key=key, sample=True))
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    mean = np.asarray(jvae.wan_vae_encode(params, jnp.asarray(vid), JCFG))
    assert np.abs(want - mean).max() > 1e-2  # the draw moves the latent
    for stream in (True, False):
        got = tvae.wan_vae_encode(model, torch.from_numpy(vid), CFG,
                                  noise=torch.from_numpy(noise), sample=True,
                                  stream=stream).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"stream={stream}")


def test_encode_sample_draws_from_the_generator_and_checks_its_inputs(vaes):
    _, model = vaes
    vid = torch.from_numpy(_video(5, 30))

    def run(seed):
        return tvae.wan_vae_encode(model, vid, CFG, sample=True,
                                   generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="noise or a generator"):
        tvae.wan_vae_encode(model, vid, CFG, sample=True)
    with pytest.raises(ValueError, match="4k"):
        tvae.wan_vae_encode(model, torch.from_numpy(_video(4, 31)), CFG)


@pytest.mark.parametrize("T_lat", [1, 2, 3])
def test_decode_matches_jax(vaes, T_lat):
    params, model = vaes
    lat = np.random.default_rng(40 + T_lat).standard_normal(
        (1, CFG.vae_z_dim, T_lat, 2, 2)).astype(np.float32)
    want = np.asarray(jvae.wan_vae_decode(params, jnp.asarray(lat), JCFG))
    assert want.shape == (1, 3, 1 + 4 * (T_lat - 1), 32, 32)
    assert (np.abs(want) < 0.999).mean() > 0.5  # the clamp hides little
    for stream in (True, False):
        got = tvae.wan_vae_decode(model, torch.from_numpy(lat), CFG, stream=stream).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"stream={stream}")


def test_streaming_decode_of_two_latent_frames_in_a_batch_of_two(vaes):
    """B = 2: each clip streams as it would alone."""
    _, model = vaes
    lat = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (2, CFG.vae_z_dim, 2, 2, 2)).astype(np.float32))
    both = tvae.wan_vae_decode(model, lat, CFG)
    for b in range(2):
        torch.testing.assert_close(both[b:b + 1], tvae.wan_vae_decode(model, lat[b:b + 1], CFG),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 3, 5, 8, 12), (2, 6, 1, 4, 4)])
def test_shuffles_match_jax_exactly(shape):
    x = np.random.default_rng(50).standard_normal(shape).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for ps in (1, 2):
        p = tvae._patchify(xt, ps).numpy()
        np.testing.assert_array_equal(p, np.asarray(jvae._patchify(xj, ps)))
        np.testing.assert_array_equal(tvae._unpatchify(torch.from_numpy(p), ps).numpy(), x)
        np.testing.assert_array_equal(tvae._unpatchify(torch.from_numpy(p), ps).numpy(),
                                      np.asarray(jvae._unpatchify(jnp.asarray(p), ps)))
    C = shape[1]
    for ft, fs, out_ch in ((1, 1, C), (2, 2, 2 * C), (2, 1, C), (1, 2, C)):
        np.testing.assert_array_equal(
            tvae._avg_down3d(xt, out_ch, ft, fs).numpy(),
            np.asarray(jvae._avg_down3d(xj, out_ch, ft, fs)))
        np.testing.assert_array_equal(
            tvae._dup_up3d(xt, out_ch, ft, fs, first=True).numpy(),
            np.asarray(jvae._dup_up3d(xj, out_ch, ft, fs)))
    # a later chunk keeps its leading frames
    up = tvae._dup_up3d(xt, C, 2, 2, first=False)
    assert up.shape[2] == 2 * shape[2]
    np.testing.assert_array_equal(up[:, :, 1:].numpy(),
                                  tvae._dup_up3d(xt, C, 2, 2, first=True).numpy())


def test_wan_vae_init_has_the_jax_tree_and_bridge_loads_it(vaes):
    params, model = vaes
    init = tvae.wan_vae_init(CFG, torch.Generator().manual_seed(0), device="cpu")
    # the JAX tree's structure and shapes (eval_shape: its initialisers take
    # most of a minute on the CPU)
    shapes = jax.eval_shape(lambda k: jvae.wan_vae_init(k, JCFG), jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = init.state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in got)
    assert torch.equal(init.latents_mean, torch.zeros(CFG.vae_z_dim))
    assert all(bool((m.gamma == 1).all()) for m in init.modules()
               if isinstance(m, tvae._RMSNorm))
    w = init.encoder.conv_in.weight
    assert float(w.abs().max()) <= w[0].numel() ** -0.5 and float(w.std()) > 0
    # the JAX tree through the bridge is the converter's module, key for key
    bridged = load_jax_params(tvae.WanVAE(CFG), jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        assert torch.equal(bridged.state_dict()[k], v), k
