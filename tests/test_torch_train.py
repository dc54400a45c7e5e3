"""The port's DPO training stack against the JAX package: loss, LoRA and PEFT
files, dataset, optimiser, one whole train step with the JAX draws injected,
remat, checkpoints and recipes. Same numpy inputs to both packages; f32."""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import safetensors.numpy
import torch

from videogpa_tpu import checkpoint as jckpt
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.train import dataset as jdata
from videogpa_tpu.train import lora as jlora
from videogpa_tpu.train import loss as jloss
from videogpa_tpu.train import recipes as jrecipes
from videogpa_tpu.train import trainer as jtrainer
from videogpa_torch import checkpoint as tckpt
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer, dit_forward
from videogpa_torch.train import dataset as tdata
from videogpa_torch.train import lora as tlora
from videogpa_torch.train import loss as tloss
from videogpa_torch.train import recipes as trecipes
from videogpa_torch.train import trainer as ttrainer
from videogpa_torch.utils import safetensors_np
from videogpa_torch.utils.logging import MetricLogger

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lora_np(seed, num_layers, dim, rank, b_scale=0.1):
    """A JAX-initialised LoRA tree as numpy, with B off zero so every
    adapter is live."""
    lora = jlora.lora_init(jax.random.PRNGKey(seed), num_layers, dim, rank=rank)
    rng = np.random.default_rng(seed)
    return {n: {"lora_A": np.array(ab["lora_A"]),
                "lora_B": rng.standard_normal(ab["lora_B"].shape, dtype=np.float32) * b_scale}
            for n, ab in lora.items()}


def _lora_torch(lora_np):
    return {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
            for n, ab in lora_np.items()}


def _models(cfg, seed=0):
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    params = jax_dit_init(jax.random.PRNGKey(seed), jcfg)
    model = load_jax_params(CogVideoXTransformer(cfg), jax.tree.map(np.asarray, params))
    return jcfg, params, model.requires_grad_(False)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

_LOSSES = {
    "sigmoid_beta500": dict(),
    "sigmoid_beta1": dict(beta=1.0),
    "label_smoothed": dict(beta=1.0, label_smoothing=0.1),
    "hinge": dict(beta=1.0, loss_type="hinge"),
}


@pytest.mark.parametrize("name", list(_LOSSES))
def test_dpo_loss_matches_jax(name):
    """The variants of test_train.py::TestDPOLoss on the same inputs. The
    per-sample MSEs (1,080 terms) sum in another order in each package,
    about 1e-7 relative; the logits multiply their differences by beta, so
    the loss is held to 4e-6 * beta."""
    rng = np.random.default_rng(len(name))
    args = [rng.standard_normal((3, 5, 4, 6, 9), dtype=np.float32) for _ in range(6)]
    kw = _LOSSES[name]
    want = jloss.DPOLoss(**kw)(*map(jnp.asarray, args))
    got = tloss.DPOLoss(**kw)(*map(_t, args))
    for field in ("loss", "reward_margin", "winner_reward", "loser_reward", "accuracy"):
        atol = 4e-6 * kw.get("beta", 500.0) if field == "loss" else 1e-6
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)),
                                   rtol=1e-5, atol=atol, err_msg=field)


def test_loss_strategies_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 2, 2, 4, 4), dtype=np.float32)
    t = np.zeros_like(x)
    sym = tloss.create_loss_strategy("dpo", beta=1.0)(*map(_t, (x, x, x, x, t, t)))
    np.testing.assert_allclose(float(sym.loss), np.log(2.0), rtol=1e-5)
    sft = tloss.create_loss_strategy("sft")(_t(x), _t(t))
    want = jloss.create_loss_strategy("sft")(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(float(sft.loss), float(want.loss), rtol=1e-6)
    with pytest.raises(ValueError):
        tloss.create_loss_strategy("ppo")
    with pytest.raises(ValueError):
        tloss.DPOLoss(loss_type="ipo")(*map(_t, (x, x, x, x, t, t)))


# ---------------------------------------------------------------------------
# LoRA and PEFT files
# ---------------------------------------------------------------------------

def test_lora_init_shapes_and_zero_b():
    lora = tlora.lora_init(3, 32, 4, torch.Generator().manual_seed(0), device="cpu")
    assert list(lora) == list(tlora.TARGETS)
    bound = np.sqrt(3.0 / 32)
    for ab in lora.values():
        assert ab["lora_A"].shape == (3, 4, 32) and ab["lora_B"].shape == (3, 32, 4)
        assert all(t.dtype == torch.float32 and t.requires_grad and t.is_leaf
                   for t in ab.values())
        a = ab["lora_A"].detach()
        assert float(a.abs().max()) <= bound and float(a.std()) > 0.1
        assert not ab["lora_B"].any()
    again = tlora.lora_init(3, 32, 4, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again["to_k"]["lora_A"], lora["to_k"]["lora_A"], atol=0, rtol=0)


@pytest.mark.parametrize("conv", ["peft", "relative", "absolute"])
def test_merge_lora_matches_online_and_jax(conv):
    """merge_lora under each scaling convention equals online application
    (the port's DiT) and the JAX merge (the same weights)."""
    cfg = CogVideoXConfig.tiny()
    rank, alpha = 4, 8.0
    kw = {"peft": {}, "relative": {"weight": 0.5}, "absolute": {"absolute_scaling": 1.5}}[conv]
    scaling = {"peft": alpha / rank, "relative": 0.5 * alpha / rank, "absolute": 1.5}[conv]
    jcfg, params, model = _models(cfg)
    lora_np = _lora_np(1, cfg.num_layers, cfg.hidden_dim, rank)
    lora = {n: {k: _t(v) for k, v in ab.items()} for n, ab in lora_np.items()}
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((1, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                                cfg.sample_width), dtype=np.float32))
    txt = _t(rng.standard_normal((1, cfg.max_text_seq_length, cfg.text_embed_dim),
                                 dtype=np.float32))
    t = torch.tensor([100])
    online = dit_forward(model, x, txt, t, compute_dtype=torch.float32, lora=lora,
                         lora_scaling=scaling)
    merged = tlora.merge_lora(model, lora, rank, alpha, **kw)
    assert merged is model
    np.testing.assert_allclose(dit_forward(merged, x, txt, t, compute_dtype=torch.float32).numpy(),
                               online.numpy(), atol=2e-4)
    jmerged = jlora.merge_lora(params, jax.tree.map(jnp.asarray, lora_np), rank, alpha, **kw)
    for name in tlora.TARGETS:
        want = np.asarray(jmerged["blocks"]["attn1"][name]["kernel"])  # (L, in, out)
        got = np.stack([getattr(b.attn1, name).weight.numpy().T for b in model.blocks])
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


def test_peft_files_interchange_with_jax(tmp_path):
    lora_np = _lora_np(3, 3, 32, 4, b_scale=1.0)
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tlora.export_peft(_lora_torch(lora_np), t_dir, rank=4, alpha=8.0)
    # a dict comprehension keeps the targets' order (jax.tree.map would sort them)
    jlora.export_peft({n: {k: jnp.asarray(v) for k, v in ab.items()} for n, ab in lora_np.items()},
                      j_dir, rank=4, alpha=8.0)
    for f in ("adapter_model.safetensors", "adapter_config.json"):
        assert filecmp.cmp(os.path.join(t_dir, f), os.path.join(j_dir, f), shallow=False), f
    with open(os.path.join(t_dir, "adapter_config.json")) as f:
        config = json.load(f)
    assert config["r"] == 4 and config["lora_alpha"] == 8.0
    assert set(config["target_modules"]) == {"to_q", "to_k", "to_v", "to_out.0"}
    from_port = jlora.import_peft(t_dir, num_layers=3)
    from_jax = tlora.import_peft(j_dir, num_layers=3, device="cpu")
    for name, ab in lora_np.items():
        for k, want in ab.items():
            np.testing.assert_array_equal(np.asarray(from_port[name][k]), want)
            np.testing.assert_array_equal(from_jax[name][k].numpy(), want)


@pytest.mark.parametrize("with_metadata", [False, True])
def test_safetensors_codec_matches_the_library(tmp_path, with_metadata):
    rng = np.random.default_rng(4)
    tensors = {
        "w": rng.standard_normal((3, 5), dtype=np.float32),
        "a.b": rng.standard_normal(7).astype(np.float16),
        "idx": np.arange(4, dtype=np.int64),
        "d": rng.standard_normal((2, 2)),
        "flags": np.array([True, False, True]),
        "u8": np.arange(5, dtype=np.uint8),
        "i32": np.arange(3, dtype=np.int32),
        "empty": np.zeros((2, 0), np.float32),
    }
    md = {"format": "pt"} if with_metadata else None
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    safetensors_np.save_file(tensors, ours, metadata=md)
    safetensors.numpy.save_file(tensors, theirs, metadata=md)
    assert filecmp.cmp(ours, theirs, shallow=False)
    back = safetensors_np.load_file(theirs)
    lib = safetensors.numpy.load_file(ours)
    for name, want in tensors.items():
        for got in (back[name], lib[name]):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# dataset and recipes
# ---------------------------------------------------------------------------

@pytest.fixture
def dpo_metadata(tmp_path):
    """Synthetic scored metadata (test_train.py's fixture): four groups, each
    hitting a different pair filter."""
    base = tmp_path
    (base / "latents").mkdir()
    groups = []
    rng = np.random.default_rng(0)
    scores = [(0.3, 0.7), (0.5, 0.52), (0.9, 1.5), (0.4, 0.8)]
    motions = [(0.1, 0.1), (0.1, 0.1), (0.1, 0.1), (0.0001, 0.1)]
    for g, ((sw, sl), (mw, ml)) in enumerate(zip(scores, motions)):
        cond_path = f"latents/cond_{g}.npz"
        np.savez(base / cond_path,
                 encoder_hidden_states=rng.standard_normal((8, 32)).astype(np.float32))
        videos = []
        for i, (score, motion) in enumerate([(sw, mw), (sl, ml)]):
            lp = f"latents/lat_{g}_{i}.npz"
            np.savez(base / lp, data=rng.standard_normal((4, 3, 8, 12)).astype(np.float32))
            videos.append({"video_path": f"v_{g}_{i}.mp4", "consistency_score": score,
                           "motion_norm": motion, "latent_path": lp, "condition_path": cond_path})
        groups.append({"group_id": f"g{g}", "prompt": f"prompt {g}", "videos": videos})
    meta = base / "meta_data.json"
    meta.write_text(json.dumps({"groups": groups}))
    return str(base), str(meta)


@pytest.mark.parametrize("filters", [
    dict(min_gap=0.05, metric_threshold=0.8, motion_threshold=0.001),
    dict(min_gap=0.01, motion_threshold=0.001),
    dict(min_gap=0.01, metric_mode="max", max_samples=2),
])
def test_dataset_matches_jax(dpo_metadata, filters):
    base, meta = dpo_metadata
    want = jdata.DPODataset(base, meta, **filters)
    got = tdata.DPODataset(base, meta, **filters)
    assert len(got) == len(want) and got.preference_pairs == want.preference_pairs
    items_t = [got[i] for i in range(len(got))]
    items_j = [want[i] for i in range(len(want))]
    for a, b in zip(items_t, items_j):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if len(got) >= 2:
        bt, bj = tdata.collate(items_t), jdata.collate(items_j)
        assert bt.keys() == bj.keys() and bt["x_win"].shape == (len(got), 4, 3, 8, 12)
        for k in bt:
            np.testing.assert_array_equal(bt[k], bj[k])


def test_dataset_reads_pt_artifacts(tmp_path):
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((4, 3, 8, 12)).astype(np.float32)
    torch.save(torch.from_numpy(lat), tmp_path / "lat.pt")
    torch.save({"encoder_hidden_states": torch.ones(8, 32)}, tmp_path / "cond.pt")
    np.testing.assert_array_equal(tdata._load_tensor_file(tmp_path / "lat.pt"), lat)
    np.testing.assert_array_equal(tdata._load_tensor_file(tmp_path / "cond.pt")[
        "encoder_hidden_states"], np.ones((8, 32), np.float32))


@pytest.mark.parametrize("n,frac,seed", [(100, 0.02, 42), (7, 0.3, 1)])
def test_train_val_split_matches_jax(n, frac, seed):
    for a, b in zip(tdata.train_val_split(n, frac, seed), jdata.train_val_split(n, frac, seed)):
        np.testing.assert_array_equal(a, b)


def test_recipes_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("DATASET_PATH", "/data/set")
    assert trecipes.RECIPES == jrecipes.RECIPES
    for r in trecipes.RECIPES:
        assert trecipes.default_config(r) == jrecipes.default_config(r)
        assert (trecipes.build_config(r, base_path=str(tmp_path))
                == jrecipes.build_config(r, base_path=str(tmp_path)))
    # run_recipe dispatches the CogVideoX recipes to cli.train_dpo.train_dpo
    # (held against the JAX package's train_dpo in test_torch_train_cli.py)
    # and the Wan recipe to train_wan_dpo (test_torch_wan_flows.py), with
    # the 5B configurations unless a model configuration is handed over
    import videogpa_torch.cli.train_dpo as tcli

    calls = []
    monkeypatch.setattr(tcli, "train_dpo",
                        lambda config, cfg, i2v=False, device=None: calls.append((cfg, i2v)))
    monkeypatch.setattr(tcli, "train_wan_dpo",
                        lambda config, cfg=None, device=None: calls.append((cfg, "wan")))
    for r in trecipes.RECIPES:
        trecipes.run_recipe(r, trecipes.default_config(r))
    assert [(c.num_layers, i2v) for c, i2v in calls[:3]] == [(42, False), (42, True), (42, False)]
    assert calls[3] == (None, "wan")
    from videogpa_torch.models.wan import WanConfig

    trecipes.run_recipe("Wan2.2-TI2V-5B", {}, model_cfg=WanConfig.tiny())
    assert calls[4] == (WanConfig.tiny(), "wan")
    with pytest.raises(ValueError):
        trecipes.default_config("nope")


# ---------------------------------------------------------------------------
# optimiser and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accumulate,grad_scale", [(2, 1.0), (1, 1.0), (2, 1e-3)])
def test_optimizer_matches_optax(accumulate, grad_scale):
    """make_optimizer over 6 calls, warmup 2: the schedule's zero first
    update, accumulation, the clip (grad_scale 1: norms ~10 > clip 1;
    1e-3: below it) and weight decay."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, max_steps=10, gradient_clip_val=1.0,
              accumulate_grad_batches=accumulate)
    rng = np.random.default_rng(accumulate)
    params_np = {"a": rng.standard_normal((3, 4), dtype=np.float32),
                 "b": rng.standard_normal(5, dtype=np.float32)}
    jopt = jtrainer.make_optimizer(jtrainer.TrainerConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    topt = ttrainer.make_optimizer(ttrainer.TrainerConfig(**kw))
    tparams = [_t(params_np["a"]), _t(params_np["b"])]
    tstate = topt.init(tparams)
    for i in range(6):
        g = {k: (rng.standard_normal(v.shape) * 5 * grad_scale).astype(np.float32)
             for k, v in params_np.items()}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.update([_t(g["a"]), _t(g["b"])], tstate, tparams)
        for got, k in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(got.numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"call {i}, {k}")
    moved = np.abs(tparams[0].numpy() - params_np["a"]).max()
    assert moved > 1e-4


def _batch(cfg, seed, B=2, frames=None, hw=None):
    rng = np.random.default_rng(seed)
    F = frames or cfg.sample_frames
    H, W = hw or (cfg.sample_height, cfg.sample_width)
    return {
        "x_win": rng.standard_normal((B, cfg.vae_latent_channels, F, H, W), dtype=np.float32),
        "x_lose": rng.standard_normal((B, cfg.vae_latent_channels, F, H, W), dtype=np.float32),
        "prompt_emb": rng.standard_normal((B, cfg.max_text_seq_length, cfg.text_embed_dim),
                                          dtype=np.float32),
    }


def _jax_draws(key, cfg, batch):
    """The draws of the JAX step (trainer.py:165-169), on its trimmed shape."""
    B, C, F, H, W = batch["x_win"].shape
    if cfg.patch_size_t is not None:
        F, H, W = F - F % cfg.patch_size_t, H - H % cfg.patch_size, W - W % cfg.patch_size
    k_t, k_noise, _ = jax.random.split(key, 3)
    t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
    noise = np.array(jax.random.normal(k_noise, (B, F, C, H, W), jnp.float32))
    return torch.from_numpy(t), torch.from_numpy(noise)


_STEP_KW = dict(learning_rate=1e-3, beta=50.0, warmup_steps=0, max_steps=20, lora_rank=4,
                lora_alpha=8.0, accumulate_grad_batches=2)
_METRICS = ("loss", "reward_margin", "reward_accuracy", "winner_reward", "loser_reward",
            "grad_norm")


@pytest.mark.parametrize("variant", ["tiny", "tiny_pt2_trim"])
def test_dpo_train_step_matches_jax(variant):
    """Two calls with accumulate 2 on the same batch and draws: after the
    first the accumulator holds the LoRA gradients (compared), after the
    second the LoRA has taken one AdamW update (compared)."""
    cfg = CogVideoXConfig.tiny()
    kw = {}
    if variant == "tiny_pt2_trim":
        cfg = dataclasses.replace(cfg, patch_size_t=2)
        kw = dict(frames=5, hw=(10, 14), B=1)  # odd F, non-patch H/W: trimmed
    jcfg, params, model = _models(cfg)
    lora_np = _lora_np(5, cfg.num_layers, cfg.hidden_dim, 4)
    batch = _batch(cfg, 6, **kw)
    key = jax.random.PRNGKey(7)

    jt = jtrainer.TrainerConfig(**_STEP_KW, compute_dtype=jnp.float32, remat=False,
                                attn_impl="xla")
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, lora_np), jt)
    jstep, _ = jtrainer.make_dpo_train_step(params, jcfg, jt)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate, jm1 = jstep(jstate, jbatch, key)
    jgrads = jax.tree.map(np.asarray, jstate.opt_state.acc_grads)
    jstate, jm2 = jstep(jstate, jbatch, key)

    tt = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=False)
    tstate = ttrainer.init_train_state(_lora_torch(lora_np), tt)
    tstep, _ = ttrainer.make_dpo_train_step(model, cfg, tt)
    timesteps, noise = _jax_draws(key, cfg, batch)
    tstate, tm1 = tstep(tstate, batch, timesteps=timesteps, noise=noise)
    tgrads = [g.clone() for g in tstate.opt_state["acc_grads"]]
    tstate, tm2 = tstep(tstate, batch, timesteps=timesteps, noise=noise)

    assert tstate.step == 2
    # the DiT outputs agree to ~1e-6 relative (test_torch_cogvideox holds
    # them to 1e-4), so the per-sample MSEs (~1) to ~1e-5; the loss
    # multiplies differences of MSEs by beta
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


def test_remat_matches_no_remat():
    cfg = CogVideoXConfig.tiny()
    _, _, model = _models(cfg, seed=2)
    lora_np = _lora_np(8, cfg.num_layers, cfg.hidden_dim, 4)
    batch = _batch(cfg, 9)
    draws = dict(timesteps=torch.tensor([10, 700]),
                 noise=torch.from_numpy(np.random.default_rng(10).standard_normal(
                     (2, cfg.sample_frames, cfg.vae_latent_channels, cfg.sample_height,
                      cfg.sample_width), dtype=np.float32)))
    out = {}
    for remat in (False, True):
        tc = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=remat)
        state = ttrainer.init_train_state(_lora_torch(lora_np), tc)
        step, evaluate = ttrainer.make_dpo_train_step(model, cfg, tc)
        state, metrics = step(state, batch, **draws)
        out[remat] = (metrics, [g.clone() for g in state.opt_state["acc_grads"]],
                      evaluate(state, batch, **draws))
    for a, b in zip(out[False][1], out[True][1]):
        torch.testing.assert_close(b, a, atol=1e-7, rtol=1e-6)
    for k in _METRICS:
        torch.testing.assert_close(out[True][0][k], out[False][0][k], atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(out[True][2]["loss"], out[True][0]["loss"], atol=0, rtol=0)


def test_train_step_draws_from_the_generator():
    cfg = CogVideoXConfig.tiny()
    _, _, model = _models(cfg)
    tc = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=False)
    _, evaluate = ttrainer.make_dpo_train_step(model, cfg, tc)
    state = ttrainer.init_train_state(_lora_torch(_lora_np(1, cfg.num_layers,
                                                           cfg.hidden_dim, 4)), tc)
    batch = _batch(cfg, 2)

    def run(seed):
        return float(evaluate(state, batch, generator=torch.Generator().manual_seed(seed))["loss"])

    assert run(0) == run(0) and run(0) != run(1)


# ---------------------------------------------------------------------------
# checkpoints and logging
# ---------------------------------------------------------------------------

def test_checkpointer_top_k_and_round_trip(tmp_path):
    tc = ttrainer.TrainerConfig(lora_rank=2, accumulate_grad_batches=2)
    lora = tlora.lora_init(2, 8, 2, torch.Generator().manual_seed(0), device="cpu")
    state = ttrainer.init_train_state(lora, tc)
    state.opt_state["mu"][0].fill_(0.5)
    state.step = 7
    ck = tckpt.TrainCheckpointer(str(tmp_path / "ckpt"), save_top_k=2, mode="min")
    for step, metric in ((1, 0.9), (2, 0.3), (3, 0.5), (4, 0.7)):
        ck.save(step, state, metric=metric)
    kept = sorted(n for n in os.listdir(ck.directory) if n.startswith("step_"))
    assert kept == ["step_00000002", "step_00000003"]
    assert ck.latest().endswith("step_00000003")
    back = ck.restore(ck.latest(), target=state)
    assert isinstance(back, ttrainer.TrainState) and back.step == 7
    assert back.opt_state["count"] == 0 and back.opt_state["mini_step"] == 0
    assert back.lora["to_q"]["lora_A"].requires_grad
    for a, b in zip(tlora.lora_leaves(back.lora) + back.opt_state["mu"],
                    tlora.lora_leaves(state.lora) + state.opt_state["mu"]):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)
    # a new checkpointer over the same directory keeps the scores
    again = tckpt.TrainCheckpointer(ck.directory, save_top_k=2)
    assert again.latest() == ck.latest()


def test_pytree_files_interchange_with_jax(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"blocks": [{"w": rng.standard_normal((2, 3), dtype=np.float32)},
                       {"w": rng.standard_normal((2, 3), dtype=np.float32)}],
            "b": np.arange(4, dtype=np.int32)}
    tckpt.save_pytree({"blocks": [{"w": _t(x["w"])} for x in tree["blocks"]],
                       "b": _t(tree["b"])}, str(tmp_path / "port"))
    jckpt.save_pytree(tree, str(tmp_path / "jax"))
    from_port = jckpt.load_pytree(str(tmp_path / "port"), to_device=False)
    from_jax = tckpt.load_pytree(str(tmp_path / "jax"))
    assert isinstance(from_jax["blocks"], list) and isinstance(from_jax["b"], torch.Tensor)
    for i in range(2):
        np.testing.assert_array_equal(from_port["blocks"][i]["w"], tree["blocks"][i]["w"])
        np.testing.assert_array_equal(from_jax["blocks"][i]["w"].numpy(), tree["blocks"][i]["w"])
    np.testing.assert_array_equal(tckpt.load_pytree(str(tmp_path / "jax.npz"))["b"].numpy(),
                                  tree["b"])


def test_metric_logger_writes_jsonl(tmp_path, monkeypatch):
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    logger = MetricLogger(str(tmp_path), config={"lr": 1e-3})
    logger.log(3, {"train/loss": torch.tensor(0.5), "train/acc": 1})
    assert logger.throughput(3, batch_size=2) > 0
    logger.close()
    lines = [json.loads(x) for x in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert lines[0] == {"_config": {"lr": 1e-3}}
    assert lines[1]["step"] == 3 and lines[1]["train/loss"] == 0.5 and lines[1]["train/acc"] == 1.0
