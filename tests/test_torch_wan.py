"""The port's Wan2.2 path against the JAX package on ``WanConfig.tiny()`` in
f32: the DiT forward (scalar and per-token timesteps, LoRA, remat), the
flow-matching helpers, the sigma grid and UniPC tables, the three solvers of
the denoise loop with the JAX initial noise injected, one DPO train step with
the JAX draws injected, and the PEFT export. Same numpy inputs to both."""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import random_jax_tree
from videogpa_tpu.models.wan import config as jconfig
from videogpa_tpu.models.wan import dit as jdit
from videogpa_tpu.models.wan import flow_match as jflow
from videogpa_tpu.models.wan import pipeline as jpipe
from videogpa_tpu.train import lora as jlora
from videogpa_tpu.train import trainer as jtrainer
from videogpa_tpu.train import wan_trainer as jwan_trainer
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.wan import (
    WanConfig, WanTransformer, flow_match as tflow, pipeline as tpipe, wan_forward, wan_init)
from videogpa_torch.train import lora as tlora
from videogpa_torch.train import trainer as ttrainer
from videogpa_torch.train import wan_trainer as twan_trainer

torch.set_num_threads(2)

CFG = WanConfig.tiny()
JCFG = jconfig.WanConfig(**dataclasses.asdict(CFG))
LATENT = (CFG.in_channels, 3, 8, 8)  # (C, F, H, W): 3 x 4 x 4 = 48 tokens
# f32 on both sides; the two sum in different orders (XLA's CPU dots, PyTorch's
# BLAS), a few 1e-6 of the largest value through two blocks
FWD_TOL = dict(atol=2e-5, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _models(seed=0):
    """(JAX params as jnp, the port's module) holding the same random tree."""
    params = random_jax_tree(jdit.wan_init, JCFG, seed=seed)
    model = load_jax_params(WanTransformer(CFG), jax.tree.map(np.asarray, params))
    return params, model.requires_grad_(False)


def _lora_np(seed, rank=4, b_scale=0.1):
    lora = jlora.lora_init(jax.random.PRNGKey(seed), CFG.num_layers, CFG.dim, rank=rank)
    rng = np.random.default_rng(seed)
    return {n: {"lora_A": np.array(ab["lora_A"]),
                "lora_B": rng.standard_normal(ab["lora_B"].shape, dtype=np.float32) * b_scale}
            for n, ab in lora.items()}


def _lora_torch(lora_np):
    return {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
            for n, ab in lora_np.items()}


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B,) + LATENT, dtype=np.float32)
    ctx = rng.standard_normal((B, CFG.text_len, CFG.text_dim), dtype=np.float32)
    return x, ctx


# ---------------------------------------------------------------------------
# config, embeddings, flow matching, schedule
# ---------------------------------------------------------------------------

def test_config_is_the_jax_config():
    for make in ("ti2v_5b", "tiny"):
        t, j = getattr(WanConfig, make)(), getattr(jconfig.WanConfig, make)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.head_dim, t.rope_axis_dims) == (j.head_dim, j.rope_axis_dims)
    assert WanConfig.ti2v_5b().rope_axis_dims == (44, 42, 42)


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0.0, 1.0, 37.5, 999.0], np.float32)
    from videogpa_torch.models.wan.dit import sinusoidal_embedding_1d
    got = sinusoidal_embedding_1d(16, _t(t)).numpy()
    want = np.asarray(jdit.sinusoidal_embedding_1d(16, jnp.asarray(t)))
    # cat(cos, sin): the first half at t = 0 is all ones
    assert (got[0, :8] == 1.0).all() and (got[0, 8:] == 0.0).all()
    # f32 angles up to ~1e3: cos/sin implementations differ by a few ulps of the angle
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    from videogpa_tpu.ops import layers as JL
    from videogpa_torch.ops import layers as TL
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3.0
    scale = 1.0 + rng.uniform(-0.2, 0.2, 48).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    for p, w in (({"scale": jnp.asarray(scale)}, _t(scale)), ({}, None)):
        want = np.asarray(JL.rmsnorm(p, jx, eps=1e-6).astype(jnp.float32))
        got = TL.rmsnorm(tx, w, eps=1e-6)
        assert got.dtype == tx.dtype
        # f32 statistics on both sides; one ulp of the output type
        tol = 1e-6 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_wan_rope_tables_match_jax():
    from videogpa_tpu.ops import rope as jrope
    from videogpa_torch.ops import rope as trope
    full = WanConfig.ti2v_5b()
    grid = (3, 4, 5)
    cos_t, sin_t = trope.rope_3d_freqs(grid, full.head_dim, full.rope_theta, full.rope_axis_dims)
    cos_j, sin_j = jrope.rope_3d_freqs(grid, full.head_dim, full.rope_theta, full.rope_axis_dims)
    assert cos_t.shape == (60, 128)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)


def test_flow_match_functions_match_jax():
    rng = np.random.default_rng(0)
    t = np.array([1, 250, 999], np.int32)
    z0, eps = (rng.standard_normal((3,) + LATENT, dtype=np.float32) for _ in range(2))
    sig_t = tflow.sigma_from_timestep(_t(t), 1000, 5.0)
    sig_j = jflow.sigma_from_timestep(jnp.asarray(t), 1000, 5.0)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-6)
    np.testing.assert_allclose(
        tflow.flow_add_noise(_t(z0), _t(eps), sig_t).numpy(),
        np.asarray(jflow.flow_add_noise(jnp.asarray(z0), jnp.asarray(eps), sig_j)),
        atol=1e-6)
    np.testing.assert_array_equal(
        tflow.flow_velocity_target(_t(z0), _t(eps)).numpy(),
        np.asarray(jflow.flow_velocity_target(jnp.asarray(z0), jnp.asarray(eps))))
    tok_t = tflow.ti2v_timestep_tokens(_t(t), LATENT[1:], CFG.patch_size)
    tok_j = jflow.ti2v_timestep_tokens(jnp.asarray(t), LATENT[1:], CFG.patch_size)
    assert tok_t.shape == (3, 48) and tok_t.dtype == torch.float32
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert (tok_t[:, :16] == 0).all() and (tok_t[:, 16:] == _t(t)[:, None]).all()


@pytest.mark.parametrize("n", [1, 2, 3, 50])
def test_sigma_grid_and_unipc_tables_match_jax(n):
    # the two linspaces round a grid point of the f32 ramp differently: within
    # two f32 ulps of 1 after the shift
    np.testing.assert_allclose(tpipe.shifted_sigmas(n, 5.0).numpy(),
                               np.asarray(jpipe.shifted_sigmas(n, 5.0)), atol=2.5e-7, rtol=0)
    got, want = tpipe._unipc_coeffs(n, 5.0), jpipe._unipc_coeffs(n, 5.0)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    assert got["c_on"][0] == 0.0 and (got["c_on"][1:] == 1.0).all()


# ---------------------------------------------------------------------------
# bridge and init
# ---------------------------------------------------------------------------

def test_wan_init_has_the_jax_tree_and_distributions():
    model = wan_init(CFG, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda k: jdit.wan_init(k, JCFG), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    other = load_jax_params(WanTransformer(CFG), zeros)  # strict: same keys and shapes
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in other.state_dict().items()}
    assert model.patch_embedding.bias.abs().sum() == 0
    assert 0.01 < model.patch_embedding.weight.std() < 0.03
    mod = torch.stack([b.modulation for b in model.blocks])
    assert abs(mod.std().item() - CFG.dim ** -0.5) < 0.03
    assert (model.blocks[0].self_attn.norm_q.weight == 1).all()
    bound = CFG.dim ** -0.5
    assert model.blocks[1].ffn.fc1.weight.abs().max() <= bound
    with pytest.raises(RuntimeError, match="CUDA"):
        wan_init(CFG)  # entry points run on the card unless the caller asks for the CPU


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("with_lora", [False, True])
def test_wan_forward_matches_jax(per_token, with_lora):
    params, model = _models()
    x, ctx = _inputs(1)
    t = np.array([37.0, 850.0], np.float32)
    if per_token:
        t = np.asarray(jflow.ti2v_timestep_tokens(jnp.asarray(t), LATENT[1:], CFG.patch_size))
    lora_np = _lora_np(2) if with_lora else None
    jl = None if lora_np is None else jax.tree.map(jnp.asarray, lora_np)
    want = np.asarray(jdit.wan_forward(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), JCFG, attn_impl="xla",
        compute_dtype=jnp.float32, lora=jl, lora_scaling=2.0))
    with torch.no_grad():
        got = wan_forward(model, _t(x), _t(t), _t(ctx), compute_dtype=torch.float32,
                          lora=None if lora_np is None else _lora_torch(lora_np),
                          lora_scaling=2.0)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    if with_lora:  # the adapters are live: the output moved
        with torch.no_grad():
            base = wan_forward(model, _t(x), _t(t), _t(ctx), compute_dtype=torch.float32)
        assert (got - base).abs().max() > 1e-3


def test_wan_forward_remat_equals_no_remat():
    _, model = _models(seed=3)
    x, ctx = _inputs(4)
    t = tflow.ti2v_timestep_tokens(torch.tensor([100.0, 700.0]), LATENT[1:], CFG.patch_size)
    out = {}
    for remat in (False, True):
        lora = _lora_torch(_lora_np(5))
        v = wan_forward(model, _t(x), t, _t(ctx), remat=remat, compute_dtype=torch.float32,
                        lora=lora, lora_scaling=2.0)
        grads = torch.autograd.grad(v.square().mean(), tlora.lora_leaves(lora))
        out[remat] = (v.detach(), grads)
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    for a, b in zip(out[True][1], out[False][1]):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_wan_forward_bf16_stays_near_f32():
    """The path's dtype on the CPU: bf16 blocks with f32 modulation and norms."""
    _, model = _models(seed=6)
    x, ctx = _inputs(7)
    t = torch.tensor([100.0, 700.0])
    with torch.no_grad():
        want = wan_forward(model, _t(x), t, _t(ctx), compute_dtype=torch.float32)
        got = wan_forward(model, _t(x), t, _t(ctx))
    assert got.dtype == torch.float32
    assert ((got - want).abs().max() / want.abs().max()).item() < 5e-2


@pytest.mark.parametrize("seed", [14, 15, 16])
def test_small_wan_of_the_smoke_run_in_bf16_plain_versions(seed):
    """``chip_smoke.py``'s small Wan (head_dim 128) through the same
    functions on the CPU: the plain versions in bf16 against f32. The bounds
    here are what the limits of the run on the card are sized from."""
    import copy

    import chip_smoke

    cfg = chip_smoke.small_wan_config()
    assert cfg.head_dim == 128
    ref, *case = chip_smoke.small_wan_case(cfg, seed)
    lat32, (m32, g32, l32) = chip_smoke.small_wan_run(ref, cfg, *case, torch.float32)
    _, *case = chip_smoke.small_wan_case(cfg, seed)  # fresh LoRA: the step updates in place
    bf16 = copy.deepcopy(ref).to(torch.bfloat16)
    lat16, (m16, g16, l16) = chip_smoke.small_wan_run(bf16, cfg, *case, torch.bfloat16)
    assert torch.equal(lat16[:, :, :1], case[3]["image_latent"])
    assert ((lat16 - lat32).norm() / lat32.norm()).item() < 1e-2 < chip_smoke.WAN_LOOP_REL
    grad_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(g16, g32))
    assert grad_rel < 3e-2 < chip_smoke.WAN_DPO_GRAD_REL
    assert abs(m16["loss"] - m32["loss"]) < 2e-4 < chip_smoke.WAN_DPO_LOSS_ATOL
    assert max((l16[n][k] - l32[n][k]).abs().max().item() for n in l32 for k in l32[n]) <= 2.5e-3


# ---------------------------------------------------------------------------
# denoise loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["euler", "heun", "unipc"])
@pytest.mark.parametrize("ti2v", [False, True])
def test_wan_denoise_loop_matches_jax(solver, ti2v):
    """Three steps run every branch of UniPC (predictor orders 1, 2, 1;
    corrector off, order 1, order 2)."""
    params, model = _models(seed=8)
    _, ctx = _inputs(9, B=2)
    context, null = ctx[:1], ctx[1:]
    shape = (1,) + LATENT
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    image = (np.random.default_rng(12).standard_normal((1, LATENT[0], 1) + LATENT[2:],
                                                        dtype=np.float32) if ti2v else None)
    want = np.asarray(jpipe.wan_denoise_loop(
        params, jnp.asarray(context), jnp.asarray(null), key, JCFG, shape, num_steps=3,
        guidance_scale=5.0, image_latent=None if image is None else jnp.asarray(image),
        ti2v=ti2v, attn_impl="xla", compute_dtype=jnp.float32, solver=solver))
    got = tpipe.wan_denoise_loop(
        model, _t(context), _t(null), shape, num_steps=3, guidance_scale=5.0,
        image_latent=None if image is None else _t(image), ti2v=ti2v,
        compute_dtype=torch.float32, solver=solver, latents=_t(noise))
    assert got.shape == shape and got.dtype == torch.float32
    # three CFG-5 model evaluations compound the forward's ~1e-5 differences
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    if ti2v:  # the first frame is the clean image latent
        np.testing.assert_array_equal(got[:, :, :1].numpy(), image)


def test_wan_denoise_loop_draws_from_the_generator_and_rejects_unknown_solvers():
    _, model = _models(seed=8)
    _, ctx = _inputs(9, B=2)
    shape = (1,) + LATENT

    def run(seed):
        return tpipe.wan_denoise_loop(model, _t(ctx[:1]), _t(ctx[1:]), shape, num_steps=1,
                                      compute_dtype=torch.float32, solver="euler",
                                      generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="solver"):
        tpipe.wan_denoise_loop(model, _t(ctx[:1]), _t(ctx[1:]), shape, solver="dpm")
    with pytest.raises(NotImplementedError, match="VAE"):
        tpipe.sample_ti2v()


# ---------------------------------------------------------------------------
# DPO train step
# ---------------------------------------------------------------------------

_STEP_KW = dict(learning_rate=1e-3, beta=50.0, warmup_steps=0, max_steps=20, lora_rank=4,
                lora_alpha=8.0, accumulate_grad_batches=2)
_METRICS = ("loss", "reward_margin", "reward_accuracy", "grad_norm")


def _batch(seed, B=2, with_image=True):
    rng = np.random.default_rng(seed)
    batch = {
        "x_win": rng.standard_normal((B,) + LATENT, dtype=np.float32),
        "x_lose": rng.standard_normal((B,) + LATENT, dtype=np.float32),
        "prompt_emb": rng.standard_normal((B, CFG.text_len, CFG.text_dim), dtype=np.float32),
    }
    if with_image:
        batch["image_latent"] = rng.standard_normal((B, LATENT[0], 1) + LATENT[2:],
                                                    dtype=np.float32)
    return batch


def _jax_draws(key, batch):
    """The draws of the JAX step (wan_trainer.py:61-64): timesteps in [1, T)."""
    k_t, k_noise = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (batch["x_win"].shape[0],), 1,
                                    JCFG.num_train_timesteps))
    noise = np.array(jax.random.normal(k_noise, batch["x_win"].shape, jnp.float32))
    return torch.from_numpy(t), torch.from_numpy(noise)


@pytest.mark.parametrize("with_image", [True, False])
def test_wan_dpo_train_step_matches_jax(with_image):
    """Two mini-steps with accumulate 2 on the same batch and draws: after
    the first the accumulator holds the LoRA gradients (compared), after the
    second the LoRA has taken one AdamW update (compared)."""
    params, model = _models(seed=13)
    lora_np = _lora_np(14)
    batch = _batch(15, with_image=with_image)
    key = jax.random.PRNGKey(16)

    jt = jtrainer.TrainerConfig(**_STEP_KW, compute_dtype=jnp.float32, remat=False,
                                attn_impl="xla")
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, lora_np), jt)
    jstep, _ = jwan_trainer.make_wan_dpo_train_step(params, JCFG, jt)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate, jm1 = jstep(jstate, jbatch, key)
    jgrads = jax.tree.map(np.asarray, jstate.opt_state.acc_grads)
    jstate, jm2 = jstep(jstate, jbatch, key)

    tt = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=True)
    tstate = ttrainer.init_train_state(_lora_torch(lora_np), tt)
    tstep, tevaluate = twan_trainer.make_wan_dpo_train_step(model, CFG, tt)
    timesteps, noise = _jax_draws(key, batch)
    assert (timesteps >= 1).all()
    tstate, tm1 = tstep(tstate, batch, timesteps=timesteps, noise=noise)
    tgrads = [g.clone() for g in tstate.opt_state["acc_grads"]]
    tstate, tm2 = tstep(tstate, batch, timesteps=timesteps, noise=noise)

    assert tstate.step == 2
    assert set(tm1) == set(jm1) == set(_METRICS)  # the four the JAX step returns
    # the DiT outputs agree to ~1e-5, so the per-sample MSEs (~1) likewise;
    # the loss multiplies differences of MSEs by beta
    for tm, jm in ((tm1, jm1), (tm2, jm2)):
        for k in _METRICS:
            atol = 1e-5 * _STEP_KW["beta"] if k == "loss" else 1e-5
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=atol,
                                       err_msg=k)
    assert float(tm1["grad_norm"]) > 0 and float(tm1["loss"]) != pytest.approx(np.log(2))
    names = [(n, k) for n in lora_np for k in ("lora_A", "lora_B")]
    for (n, k), g in zip(names, tgrads):
        np.testing.assert_allclose(g.numpy(), jgrads[n][k], rtol=1e-3,
                                   atol=1e-4 * np.abs(jgrads[n][k]).max(), err_msg=f"{n}.{k}")
    for n, ab in tstate.lora.items():
        for k, t in ab.items():
            want = np.asarray(jstate.lora[n][k])
            assert np.abs(want - lora_np[n][k]).max() > 1e-4  # the update happened
            np.testing.assert_allclose(t.detach().numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n}.{k}")
    ev = tevaluate(tstate, batch, timesteps=timesteps, noise=noise)
    assert set(ev) == set(_METRICS) - {"grad_norm"}


def test_wan_train_step_draws_from_the_generator_and_binds_the_model():
    _, model = _models(seed=13)
    tc = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=False)
    _, evaluate = twan_trainer.make_wan_dpo_train_step(model, CFG, tc)
    _, unbound = twan_trainer.make_wan_dpo_train_step_unbound(CFG, tc)
    state = ttrainer.init_train_state(_lora_torch(_lora_np(1)), tc)
    batch = _batch(2)

    def run(seed, fn=evaluate, *lead):
        return float(fn(*lead, state, batch, generator=torch.Generator().manual_seed(seed))["loss"])

    assert run(0) == run(0) and run(0) != run(1)
    assert run(0) == run(0, unbound, model)  # the unbound step takes the model first


# ---------------------------------------------------------------------------
# LoRA files
# ---------------------------------------------------------------------------

def test_wan_peft_export_is_the_jax_file_byte_for_byte(tmp_path):
    """The arguments of ``cli/train_dpo.py::train_wan_dpo`` (:273-276)."""
    lora_np = _lora_np(3, b_scale=1.0)
    kw = dict(rank=4, alpha=8.0, base_model_class="WanModel",
              parent_library="wan.modules.model", block_prefix="blocks")
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tlora.export_peft(_lora_torch(lora_np), t_dir, **kw)
    jlora.export_peft({n: {k: jnp.asarray(v) for k, v in ab.items()}
                       for n, ab in lora_np.items()}, j_dir, **kw)
    for f in ("adapter_model.safetensors", "adapter_config.json"):
        assert filecmp.cmp(os.path.join(t_dir, f), os.path.join(j_dir, f), shallow=False), f
    back = tlora.import_peft(t_dir, num_layers=CFG.num_layers, block_prefix="blocks",
                             device="cpu")
    for n, ab in lora_np.items():
        for k, want in ab.items():
            np.testing.assert_array_equal(back[n][k].numpy(), want)


def test_lora_init_at_the_wan_size_and_merge_matches_jax():
    lora = tlora.lora_init(2, 3072, 4, torch.Generator().manual_seed(0), device="cpu")
    assert lora["to_q"]["lora_A"].shape == (2, 4, 3072)
    assert lora["to_out"]["lora_B"].shape == (2, 3072, 4)
    params, model = _models(seed=17)
    lora_np = _lora_np(18)
    merged = jlora.merge_lora(params, jax.tree.map(jnp.asarray, lora_np), rank=4, alpha=8.0,
                              weight=0.5, layout="wan")
    tlora.merge_lora(model, _lora_torch(lora_np), rank=4, alpha=8.0, weight=0.5, layout="wan")
    for name in ("q", "k", "v", "o"):
        want = np.asarray(merged["blocks"]["self_attn"][name]["kernel"])
        got = np.stack([getattr(b.self_attn, name).weight.numpy().T for b in model.blocks])
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
