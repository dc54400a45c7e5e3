"""The port's CogVideoX sampling slice against the JAX package's on the CPU,
in f32 with the same weights and the JAX draws injected: ``sample_t2v``,
``sample_i2v``, ``decode_latents`` (tiled through ``VIDEOGPA_VAE_TILE``, and
its shrink-and-retry on a CUDA out-of-memory error), ``video_to_uint8``, and
the I2V DPO train step's encoded first-frame conditioning."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.models.cogvideox.pipeline as jp
import videogpa_tpu.models.cogvideox.vae as jv
import videogpa_tpu.ops.attention as jattn
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.train import trainer as jtrainer
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from videogpa_torch.models.cogvideox import pipeline as tp
from videogpa_torch.models.cogvideox import vae as tv
from videogpa_torch.train import trainer as ttrainer
from test_torch_bridge import random_jax_tree
from test_torch_train import _STEP_KW, _batch, _lora_np, _lora_torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(i2v=False):
    cfg = CogVideoXConfig.tiny(i2v=i2v)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    dit = random_jax_tree(jax_dit_init, jcfg)
    vae = random_jax_tree(jv.vae_init, jcfg, seed=1)
    tdit = load_jax_params(CogVideoXTransformer(cfg), dit)
    tvae = load_jax_params(tv.CogVideoXVAE(cfg), vae)
    return cfg, jcfg, dit, vae, tdit.requires_grad_(False), tvae.eval()


@pytest.fixture(scope="module")
def models():
    """``_models`` of the T2V and the I2V config, each built once a module;
    the tests read them and train a separate LoRA (the DiT stays frozen)."""
    return {False: _models(), True: _models(i2v=True)}


def _embeds(cfg, seed):
    rng = np.random.default_rng(seed)
    txt = rng.standard_normal((1, cfg.max_text_seq_length, cfg.text_embed_dim),
                              dtype=np.float32)
    return txt, np.zeros_like(txt)


def _loop_draws(key, shape, n):
    """``denoise_loop``'s draws in the JAX package (pipeline.py:67-68, 113-115)."""
    k_init, k_steps = jax.random.split(key)
    init = _t(jax.random.normal(k_init, shape, jnp.float32))
    noise = [_t(jax.random.normal(jax.random.fold_in(k_steps, i), shape, jnp.float32))
             for i in range(n)]
    return init, noise


# the loop's f32 DiT agrees to ~1e-6 a step (test_torch_cogvideox); three
# DPM steps and a VAE decode keep the video within 1e-4
RTOL, ATOL = 1e-4, 1e-4


def test_sample_t2v_matches_jax(models):
    cfg, jcfg, dit, vae, tdit, tvae = models[False]
    txt, neg = _embeds(cfg, 2)
    key, n = jax.random.PRNGKey(3), 3
    settings = jp.SamplerSettings(num_inference_steps=n, guidance_scale=6.0)
    want = jp.sample_t2v(dit, vae, jnp.asarray(txt), jnp.asarray(neg), jcfg, key,
                         num_frames=9, height=64, width=64, settings=settings,
                         attn_impl="xla", compute_dtype=jnp.float32)
    init, noise = _loop_draws(key, (1, 3, cfg.vae_latent_channels, 8, 8), n)
    got = tp.sample_t2v(tdit, tvae, _t(txt), _t(neg), cfg, num_frames=9, height=64,
                        width=64, settings=tp.SamplerSettings(num_inference_steps=n),
                        init_latents=init, step_noise=noise, compute_dtype=torch.float32)
    assert got.shape == (1, 3, 9, 64, 64)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tp.video_to_uint8(got)[0].shape, (9, 64, 64, 3))
    np.testing.assert_array_equal(tp.video_to_uint8(_t(want)), jp.video_to_uint8(want))


# 9 frames: 3 latent frames -> 4; 13: 4 stay; 81 (the 1.5 recipe's): 21 -> 22
@pytest.mark.parametrize("num_frames, latent_frames", [(9, 4), (13, 4), (81, 22)])
def test_sample_t2v_rounds_latent_frames_up_to_patch_size_t(monkeypatch, num_frames,
                                                            latent_frames):
    cfg = dataclasses.replace(CogVideoXConfig.tiny(), patch_size_t=2)
    seen = {}

    def fake_loop(dit, txt, neg, settings, shape, **kw):
        seen["shape"] = shape
        return torch.zeros(shape)

    monkeypatch.setattr(tp, "denoise_loop", fake_loop)
    monkeypatch.setattr(tp, "decode_latents", lambda vae, lat, cfg: lat)
    tp.sample_t2v(None, None, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32), cfg,
                  num_frames=num_frames, height=64, width=96)
    assert seen["shape"] == (1, latent_frames, 4, 8, 12)
    assert tp.num_latent_frames(cfg, num_frames) == latent_frames


def test_sample_i2v_matches_jax(models):
    cfg, jcfg, dit, vae, tdit, tvae = models[True]
    txt, neg = _embeds(cfg, 4)
    image = np.random.default_rng(5).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    key, n = jax.random.PRNGKey(6), 2
    settings = jp.SamplerSettings(num_inference_steps=n, sampler="ddim")
    want = jp.sample_i2v(dit, vae, jnp.asarray(txt), jnp.asarray(neg), jnp.asarray(image),
                         jcfg, key, num_frames=9, settings=settings, attn_impl="xla",
                         compute_dtype=jnp.float32)
    k_img, k_noise = jax.random.split(key)
    posterior = _t(jax.random.normal(k_img, (1, cfg.vae_latent_channels, 1, 8, 8)))
    init, _ = _loop_draws(k_noise, (1, 3, cfg.vae_latent_channels, 8, 8), n)
    got = tp.sample_i2v(tdit, tvae, _t(txt), _t(neg), _t(image), cfg, num_frames=9,
                        settings=tp.SamplerSettings(num_inference_steps=n, sampler="ddim"),
                        posterior_noise=posterior, init_latents=init,
                        compute_dtype=torch.float32)
    assert got.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = CogVideoXConfig.tiny()
    jt = random_jax_tree(jv.vae_init, JaxConfig(**dataclasses.asdict(cfg)), seed=2)
    return cfg, jt, load_jax_params(tv.CogVideoXVAE(cfg), jt).eval()


def test_decode_latents_tiles_as_the_env_says(tiny_vae, monkeypatch):
    cfg, jt, m = tiny_vae
    # tiles of (3, 8, 8) latents: the shapes sample_t2v decodes above
    lat = np.random.default_rng(7).standard_normal((1, 3, cfg.vae_latent_channels, 8, 12),
                                                   dtype=np.float32) * 2.0
    monkeypatch.setenv("VIDEOGPA_VAE_TILE", "8")
    assert tp.decode_tile_sizes() == (8,)
    logged = []
    got = tp.decode_latents(m, _t(lat), cfg, log=logged.append)
    want = jp.decode_latents(jt, jnp.asarray(lat), JaxConfig(**dataclasses.asdict(cfg)))
    assert logged == ["decode tile 8: 8x12 latents"]
    assert got.shape == (1, 3, 9, 64, 96) and float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # a tile no smaller than the grid decodes the latents whole (60 x 90 at
    # tile 90: every operation of that decode takes its 4.3 G-element
    # tensors on the card, as chip_smoke.py's probe checks)
    monkeypatch.setenv("VIDEOGPA_VAE_TILE", "90")
    seen = []
    monkeypatch.setattr(tv, "vae_decode", lambda vae, z, cfg: seen.append(tuple(z.shape))
                        or torch.zeros(1, 3, 5, 480, 720))
    tp.decode_latents(m, torch.zeros(1, 2, cfg.vae_latent_channels, 60, 90), cfg,
                      log=logged.append)
    assert seen == [(1, cfg.vae_latent_channels, 2, 60, 90)]
    assert logged[-1] == "decode tile 90: 60x90 latents"
    monkeypatch.delenv("VIDEOGPA_VAE_TILE")
    assert tp.decode_tile_sizes() == (32, 16, 8)


def test_decode_latents_retries_only_on_cuda_oom(tiny_vae, monkeypatch):
    cfg, _, m = tiny_vae
    lat = torch.randn(1, 2, cfg.vae_latent_channels, 4, 6, generator=torch.Generator()
                      .manual_seed(8))
    real = tv.vae_decode_tiled
    calls = []

    def oom_once(vae, z, cfg, tile_latent):
        calls.append(tile_latent)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(vae, z, cfg, tile_latent=tile_latent)

    monkeypatch.setattr(tp, "vae_decode_tiled", oom_once)
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(True))
    logged = []
    got = tp.decode_latents(m, lat, cfg, log=logged.append)
    assert calls == [32, 16] and emptied == [True]
    assert logged == ["decode tile 32 out of memory; retrying with 16",
                      "decode tile 16: 4x6 latents"]
    torch.testing.assert_close(got, torch.clamp(real(m, lat.transpose(1, 2), cfg), -1, 1))

    def fails(vae, z, cfg, tile_latent):
        calls.append(tile_latent)
        raise RuntimeError("not a memory error")

    calls.clear()
    monkeypatch.setattr(tp, "vae_decode_tiled", fails)
    with pytest.raises(RuntimeError, match="not a memory error"):
        tp.decode_latents(m, lat, cfg, log=logged.append)
    assert calls == [32]  # re-raised at once, no retry

    def always_oom(vae, z, cfg, tile_latent):
        calls.append(tile_latent)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    calls.clear()
    monkeypatch.setattr(tp, "vae_decode_tiled", always_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tp.decode_latents(m, lat, cfg, log=logged.append)
    assert calls == [32, 16, 8]


def test_i2v_dpo_step_conditions_on_the_encoded_first_frame(models):
    """The JAX step with a VAE and ``image_emb`` against the port's, draws
    injected (trainer.py:165-174): metrics, then the LoRA after the update."""
    cfg, jcfg, dit, vae, tdit, tvae = models[True]
    lora_np = _lora_np(5, cfg.num_layers, cfg.hidden_dim, 4)
    batch = _batch(cfg, 6, B=1)
    batch["image_emb"] = np.random.default_rng(9).uniform(
        -1, 1, (1, 3, 40, 56)).astype(np.float32)  # resized to the 64 x 96 grid
    key = jax.random.PRNGKey(10)
    kw = dict(_STEP_KW, accumulate_grad_batches=1)

    jt = jtrainer.TrainerConfig(**kw, compute_dtype=jnp.float32, remat=False,
                                attn_impl="xla")
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, lora_np), jt)
    jstep, _ = jtrainer.make_dpo_train_step(dit, jcfg, jt, vae_params=vae)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)

    B, C, F, H, W = batch["x_win"].shape
    k_t, k_noise, k_img = jax.random.split(key, 3)
    timesteps = _t(jax.random.randint(k_t, (B,), 0, 1000))
    noise = _t(jax.random.normal(k_noise, (B, F, C, H, W), jnp.float32))
    posterior = _t(jax.random.normal(k_img, (B, cfg.vae_latent_channels, 1, H, W)))
    tt = ttrainer.TrainerConfig(**kw, compute_dtype=torch.float32, remat=False)
    tstate = ttrainer.init_train_state(_lora_torch(lora_np), tt)
    tstep, teval = ttrainer.make_dpo_train_step(tdit, cfg, tt, vae=tvae)
    draws = dict(timesteps=timesteps, noise=noise, posterior_noise=posterior)
    # without the VAE the image channels are zeros: another loss
    _, zero_eval = ttrainer.make_dpo_train_step(tdit, cfg, tt)
    zero_loss = float(zero_eval(tstate, batch, **draws)["loss"])
    tstate, tm = tstep(tstate, batch, **draws)

    for k in ("loss", "reward_margin", "winner_reward", "loser_reward", "grad_norm"):
        atol = 1e-5 * kw["beta"] if k == "loss" else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=atol,
                                   err_msg=k)
    assert abs(zero_loss - float(jm["loss"])) > 1e-3
    for n, ab in tstate.lora.items():
        for k, t in ab.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jstate.lora[n][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{n}.{k}")
    cond = ttrainer._i2v_condition(tvae, _t(batch["image_emb"]),
                                   _t(batch["x_win"]).transpose(1, 2), cfg, noise=posterior)
    assert cond.shape == (1, F, cfg.vae_latent_channels, H, W)
    assert bool((cond[:, 1:] == 0).all()) and float(cond[:, 0].abs().max()) > 0
