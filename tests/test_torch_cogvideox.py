"""The port's CogVideoX slice against the JAX package: DiT forward, scheduler,
and the whole denoise loop with the JAX random draws injected."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.ops.attention as jattn
from __graft_entry__ import _small_cfg
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.cogvideox.dit import dit_forward as jax_dit_forward
from videogpa_tpu.models.cogvideox.pipeline import SamplerSettings as JaxSettings
from videogpa_tpu.models.cogvideox.pipeline import denoise_loop as jax_denoise_loop
from videogpa_tpu.models.cogvideox.scheduler import CogVideoXScheduler as JaxScheduler
from videogpa_tpu.train.lora import lora_init
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.cogvideox import (
    CogVideoXConfig,
    CogVideoXScheduler,
    CogVideoXTransformer,
    SamplerSettings,
    denoise_loop,
    dit_forward,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = False


_CONFIGS = {
    "tiny": CogVideoXConfig.tiny(),
    "small": CogVideoXConfig(**dataclasses.asdict(_small_cfg())),
    "tiny_pt2_ofs": dataclasses.replace(
        CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4, ofs_embed_dim=16),
    "tiny_i2v_learned_pe": CogVideoXConfig.tiny(i2v=True),
}


def _models(cfg, seed=0):
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    params = jax_dit_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(CogVideoXTransformer(cfg), jax.tree.map(np.asarray, params))
    return jcfg, params, model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    """``_models`` of each (config, seed), built once a module (JAX's own
    ``dit_init`` runs eagerly, seconds a config); no test writes into them."""
    cache = {}

    def get(cfg, seed=0):
        if (cfg, seed) not in cache:
            cache[cfg, seed] = _models(cfg, seed)
        return cache[cfg, seed]

    return get


# the JAX forward jitted: eager, it runs op by op
_j_dit_forward = jax.jit(jax_dit_forward, static_argnums=(4,),
                         static_argnames=("attn_impl", "compute_dtype", "attn_layout",
                                          "lora_scaling"))


def _inputs(cfg, seed, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.sample_frames, cfg.in_channels,
                             cfg.sample_height, cfg.sample_width), dtype=np.float32)
    txt = rng.standard_normal((batch, cfg.max_text_seq_length, cfg.text_embed_dim),
                              dtype=np.float32)
    return x, txt


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("name", list(_CONFIGS))
def test_dit_forward_matches_jax(name, layout, models):
    cfg = _CONFIGS[name]
    jcfg, params, model = models(cfg)
    x, txt = _inputs(cfg, 1)
    t = np.array([100, 900])
    ofs = np.array([2.0, 2.0], np.float32) if cfg.ofs_embed_dim else None
    want = _j_dit_forward(
        params, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), jcfg,
        ofs=None if ofs is None else jnp.asarray(ofs), attn_impl="flash",
        compute_dtype=jnp.float32, attn_layout=layout)
    got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(t),
                      ofs=None if ofs is None else torch.from_numpy(ofs),
                      compute_dtype=torch.float32, attn_layout=layout)
    assert got.shape == x.shape[:2] + (cfg.out_channels,) + x.shape[3:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_dit_forward_with_lora_matches_jax(models):
    cfg = _CONFIGS["tiny"]
    jcfg, params, model = models(cfg)
    lora = lora_init(jax.random.PRNGKey(4), cfg.num_layers, cfg.hidden_dim, rank=4)
    rng = np.random.default_rng(5)  # PEFT starts B at 0; give it values
    lora = {n: {"lora_A": np.array(ab["lora_A"]),
                "lora_B": rng.standard_normal(ab["lora_B"].shape, dtype=np.float32) * 0.1}
            for n, ab in lora.items()}
    x, txt = _inputs(cfg, 6)
    t = np.array([10, 500])
    want = _j_dit_forward(
        params, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), jcfg, attn_impl="flash",
        compute_dtype=jnp.float32, lora=jax.tree.map(jnp.asarray, lora), lora_scaling=2.0,
        attn_layout="bnhd")
    got = dit_forward(
        model, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(t),
        compute_dtype=torch.float32,
        lora={n: {k: torch.from_numpy(v) for k, v in ab.items()} for n, ab in lora.items()},
        lora_scaling=2.0, attn_layout="bnhd")
    base = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(t),
                       compute_dtype=torch.float32, attn_layout="bnhd")
    assert (got - base).abs().max() > 1e-3  # the adapters are live
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_scheduler_matches_jax():
    js, ts = JaxScheduler(), CogVideoXScheduler()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    for n in (3, 50):
        np.testing.assert_array_equal(ts.timesteps(n), js.timesteps(n))
    rng = np.random.default_rng(7)
    shape = (2, 3, 4, 5, 6)
    sample, out, noise, old = (rng.standard_normal(shape, dtype=np.float32) for _ in range(4))
    steps = np.array([0, 999])
    j = {k: jnp.asarray(v) for k, v in dict(sample=sample, out=out, noise=noise, old=old).items()}
    t = {k: torch.from_numpy(v) for k, v in dict(sample=sample, out=out, noise=noise, old=old).items()}

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)

    close(ts.add_noise(t["sample"], t["noise"], torch.from_numpy(steps)),
          js.add_noise(j["sample"], j["noise"], jnp.asarray(steps)))
    close(ts.get_velocity(t["sample"], t["noise"], torch.from_numpy(steps)),
          js.get_velocity(j["sample"], j["noise"], jnp.asarray(steps)))
    # (t, t_prev, t_back): a middle step, the last step, the zero-SNR t=999
    # as timestep_back (the degenerate 2nd-order case)
    for step, prev, back in ((499, 332, 665), (332, -1, 499), (665, 332, 999)):
        close(ts.ddim_step(t["out"], step, prev, t["sample"]),
              js.ddim_step(j["out"], step, prev, j["sample"]))
        for a, b in zip(ts.dpm_step(t["out"], step, prev, t["sample"], t["noise"]),
                        js.dpm_step(j["out"], step, prev, j["sample"], j["noise"])):
            close(a, b)
        for a, b in zip(
                ts.dpm_step(t["out"], step, prev, t["sample"], t["noise"], old_x0=t["old"],
                            timestep_back=back),
                js.dpm_step(j["out"], step, prev, j["sample"], j["noise"], old_x0=j["old"],
                            timestep_back=jnp.asarray(back))):
            close(a, b)


@pytest.mark.parametrize("sampler,dynamic", [("ddim", False), ("dpm", False), ("dpm", True)])
def test_denoise_loop_matches_jax(sampler, dynamic, models):
    cfg = CogVideoXConfig.tiny()
    jcfg, params, model = models(cfg, seed=3)
    rng = np.random.default_rng(8)
    txt = rng.standard_normal((1, cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32)
    neg = rng.standard_normal(txt.shape, dtype=np.float32)
    shape = (1, cfg.sample_frames, cfg.vae_latent_channels, cfg.sample_height, cfg.sample_width)
    n = 3
    key = jax.random.PRNGKey(9)
    want = jax_denoise_loop(
        params, jnp.asarray(txt), jnp.asarray(neg), key, jcfg,
        JaxSettings(num_inference_steps=n, guidance_scale=6.0, use_dynamic_cfg=dynamic,
                    sampler=sampler),
        shape, attn_impl="xla", compute_dtype=jnp.float32)
    # the JAX loop's draws (pipeline.py:67-68, 113-115), handed to the port
    k_init, k_steps = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    noise = [torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(k_steps, i), shape, jnp.float32))) for i in range(n)]
    got = denoise_loop(
        model, torch.from_numpy(txt), torch.from_numpy(neg),
        SamplerSettings(num_inference_steps=n, guidance_scale=6.0, use_dynamic_cfg=dynamic,
                        sampler=sampler),
        shape, init_latents=torch.from_numpy(init), step_noise=noise,
        compute_dtype=torch.float32)
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_denoise_loop_draws_from_the_generator(models):
    cfg = CogVideoXConfig.tiny()
    _, _, model = models(cfg)
    txt = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim)
    shape = (1, cfg.sample_frames, cfg.vae_latent_channels, cfg.sample_height, cfg.sample_width)
    settings = SamplerSettings(num_inference_steps=2)

    def run(seed):
        return denoise_loop(model, txt, txt, settings, shape,
                            generator=torch.Generator().manual_seed(seed),
                            compute_dtype=torch.float32)

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - c).abs().max() > 1e-3
