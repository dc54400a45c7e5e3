"""CogVideoX1.5-5B DPO training through the port against the JAX package on
the CPU, at tiny widths with the 1.5 layout (``test_torch_cog15.py``'s
``CFG``: patch_size_t 2, the Linear patch embed, a 6 x 10 sample grid), the
same numpy-seeded weights through the bridge and the same injected draws:

(a) ``make_dpo_train_step`` with ``remat=True`` on the port's kernel route
    (``_FlashAttention``: K1's and K3's plain versions on the CPU) on
    latents with an odd frame count, a height and width that no patch
    divides, and a trimmed grid smaller than the sample grid; the metrics,
    the LoRA gradients after one accumulate-2 call and the LoRA after the
    update against JAX's step (XLA attention);
(b) ``run_recipe("CogVideoX1.5-5B")`` from ``.npz`` files against the JAX
    ``run_recipe`` on the same files and weights, both recipes' model
    configuration replaced by the tiny one: the split, the batches in
    order, each step's loss, the validation losses, the checkpoints, a
    resume and the exported PEFT files;
(c) the one-device reckoning of the 1.5 step (``train.memory``, the
    recipe's trainer settings): 41,026 tokens a forward and 252,063,744 B
    a remat block, at a depth cut to 2 of 42 layers (the full depth traces
    for ~25 s; neither figure depends on the depth).

Every JAX step is compiled without LLVM's costly passes (``FAST_COMPILE``)
and without remat: the values are the same, the compile is cheaper. Both
packages run in f32. Tolerances are stated beside each comparison.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.cli.train_dpo as jcli
import videogpa_tpu.models.loader as jloader
import videogpa_tpu.train.trainer as jtrainer
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.train import lora as jlora
from videogpa_tpu.train import recipes as jrecipes
import videogpa_torch.cli.train_dpo as tcli
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from videogpa_torch.ops import attention as A
from videogpa_torch.train import memory as M
from videogpa_torch.train import recipes as trecipes
from videogpa_torch.train import trainer as ttrainer
from videogpa_torch.train.lora import import_peft
from videogpa_torch.utils import safetensors_np
from test_torch_bridge import random_jax_tree
from test_torch_train import _lora_np, _lora_torch
from test_torch_train_cli import write_pair_set

torch.set_num_threads(2)

# test_torch_cog15.py's CFG: CogVideoX1.5's layout at tiny widths
CFG = dataclasses.replace(CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4,
                          sample_height=6, sample_width=10, vae_invert_scale_latents=True)
JCFG = JaxConfig(**dataclasses.asdict(CFG))
# latents as the recipe's encoder leaves them, at tiny size: an odd frame
# count (5 -> 4 trimmed) and a 5 x 9 grid (-> 4 x 8, 2 x 4 patches, under
# the 3 x 5 of the sample grid)
LATENT_FHW = (5, 5, 9)
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}
SEED = 3


@pytest.fixture(scope="module")
def models():
    """The tiny 1.5 DiT's JAX tree (seeded numpy draws) and the port's
    module bridged from it; no test writes into them."""
    params = random_jax_tree(jax_dit_init, JCFG, seed=23)
    model = load_jax_params(CogVideoXTransformer(CFG), params).requires_grad_(False)
    return params, model


def _trimmed(shape):
    """(B, C, F, H, W) of latents as the 1.5 step trims them."""
    B, C, F, H, W = shape
    p, pt = CFG.patch_size, CFG.patch_size_t
    return B, C, F - F % pt, H - H % p, W - W % p


def _jax_draws(key, shape):
    """The JAX step's draws (trainer.py:165-169) on its trimmed latents."""
    B, C, F, H, W = _trimmed(shape)
    k_t, k_noise, _ = jax.random.split(key, 3)
    t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
    noise = np.array(jax.random.normal(k_noise, (B, F, C, H, W), jnp.float32))
    return torch.from_numpy(t), torch.from_numpy(noise)


def _fast_jax_step(base_params, cfg, tcfg, vae_params=None):
    """JAX's ``make_dpo_train_step``: its two jitted functions lowered at
    their first call and compiled with ``FAST_COMPILE``."""
    jits = jtrainer.make_dpo_train_step_unbound(cfg, tcfg)

    def bind(fn):
        compiled = []

        def call(state, batch, key):
            if not compiled:
                compiled.append(fn.lower(base_params, vae_params, state, batch, key)
                                .compile(FAST_COMPILE))
            return compiled[0](base_params, vae_params, state, batch, key)

        return call

    return tuple(map(bind, jits))


# (a) ------------------------------------------------------------------------

_STEP_KW = dict(learning_rate=1e-3, beta=50.0, warmup_steps=0, max_steps=20, lora_rank=4,
                lora_alpha=8.0, accumulate_grad_batches=2)
_METRICS = ("loss", "reward_margin", "reward_accuracy", "winner_reward", "loser_reward",
            "grad_norm")


def test_cog15_dpo_step_with_remat_matches_jax(models, monkeypatch):
    """Two calls with accumulate 2 on the same batch and draws: after the
    first the accumulator holds the LoRA gradients (compared), after the
    second the LoRA has taken one AdamW update (compared). The port's step
    runs the attention through ``_FlashAttention`` (K1 with LSE, K3), each
    block recomputed in the backward."""
    params, model = models
    rng = np.random.default_rng(24)
    shape = (2, CFG.vae_latent_channels) + LATENT_FHW
    batch = {"x_win": rng.standard_normal(shape, dtype=np.float32),
             "x_lose": rng.standard_normal(shape, dtype=np.float32),
             "prompt_emb": rng.standard_normal((2, CFG.max_text_seq_length, CFG.text_embed_dim),
                                               dtype=np.float32)}
    lora_np = _lora_np(25, CFG.num_layers, CFG.hidden_dim, 4)
    key = jax.random.PRNGKey(26)

    jt = jtrainer.TrainerConfig(**_STEP_KW, compute_dtype=jnp.float32, remat=False,
                                attn_impl="xla")
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, lora_np), jt)
    jstep, _ = _fast_jax_step(params, JCFG, jt)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate, jm1 = jstep(jstate, jbatch, key)
    jgrads = jax.tree.map(np.asarray, jstate.opt_state.acc_grads)
    jstate, jm2 = jstep(jstate, jbatch, key)

    tt = ttrainer.TrainerConfig(**_STEP_KW, compute_dtype=torch.float32, remat=True)
    tstate = ttrainer.init_train_state(_lora_torch(lora_np), tt)
    tstep, _ = ttrainer.make_dpo_train_step(model, CFG, tt)
    timesteps, noise = _jax_draws(key, shape)
    calls = []
    real_apply = A._FlashAttention.apply

    def apply(q, *a):
        calls.append(tuple(q.shape))
        return real_apply(q, *a)

    monkeypatch.setattr(A._FlashAttention, "apply", apply)
    tstate, tm1 = tstep(tstate, batch, timesteps=timesteps, noise=noise)
    tgrads = [g.clone() for g in tstate.opt_state["acc_grads"]]
    tstate, tm2 = tstep(tstate, batch, timesteps=timesteps, noise=noise)

    # the trimmed grid: 2 frames of 2 x 4 patches + 8 text tokens a row; 2
    # policy forwards + their 2 recomputes a call, one a layer
    tokens = 2 * 2 * 4 + CFG.max_text_seq_length
    assert set(calls) == {(2, tokens, CFG.num_heads, CFG.head_dim)}
    assert len(calls) == 2 * 4 * CFG.num_layers
    assert tstate.step == 2
    # as test_torch_train.py's step: the DiT outputs agree to ~1e-6
    # relative, the per-sample MSEs (~1) to ~1e-5, and the loss multiplies
    # differences of MSEs by beta
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


# (b) ------------------------------------------------------------------------

@pytest.fixture
def recipes(models, monkeypatch):
    """Both packages' ``run_recipe("CogVideoX1.5-5B")`` on the same tiny 1.5
    DiT (``cogvideox_1_5_5b`` replaced in both), in f32, with the port's
    LoRA init and step draws taken from the JAX train_dpo's seed and key
    sequence; records the configuration each trainer got and each one's
    batches (by the winner's score) in order."""
    params, model = models
    seen = {"jax": [], "port": [], "cfg": {}}
    monkeypatch.setattr(JaxConfig, "cogvideox_1_5_5b", staticmethod(lambda: JCFG))
    monkeypatch.setattr(CogVideoXConfig, "cogvideox_1_5_5b", staticmethod(lambda: CFG))
    monkeypatch.setattr(jloader, "load_cogvideox", lambda *a, **k: (params, None))
    monkeypatch.setattr(tcli, "load_cogvideox", lambda *a, **k: (model, None))
    # XLA attention in f32 without remat (the same values, a cheaper compile)
    real_jcfg = jtrainer.TrainerConfig
    monkeypatch.setattr(jtrainer, "TrainerConfig", lambda **kw: real_jcfg(
        **kw, compute_dtype=jnp.float32, attn_impl="xla", remat=False))
    real_tcfg = ttrainer.TrainerConfig
    monkeypatch.setattr(tcli, "TrainerConfig", lambda **kw: real_tcfg(
        **kw, compute_dtype=torch.float32))

    for pkg, mod in (("jax", jcli), ("port", tcli)):
        real_train = mod.train_dpo

        def train_dpo(config, cog_cfg, i2v=False, pkg=pkg, real_train=real_train, **kw):
            seen["cfg"][pkg] = (cog_cfg, i2v)
            return real_train(config, cog_cfg, i2v=i2v, **kw)

        monkeypatch.setattr(mod, "train_dpo", train_dpo)

    def jax_step(base_params, cfg, tcfg, vae_params=None):
        train, ev = _fast_jax_step(base_params, cfg, tcfg, vae_params)

        def train_rec(state, batch, key):
            seen["jax"].append(float(np.asarray(batch["m_win"])[0]))
            return train(state, batch, key)

        return train_rec, ev

    monkeypatch.setattr(jtrainer, "make_dpo_train_step", jax_step)

    def port_lora(num_layers, dim, rank, generator, device=None):
        lora = jlora.lora_init(jax.random.PRNGKey(SEED), num_layers, dim, rank=rank)
        return {n: {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in ab.items()}
                for n, ab in lora.items()}

    monkeypatch.setattr(tcli, "lora_init", port_lora)
    real_port_step = ttrainer.make_dpo_train_step

    def port_step(model, cfg, tcfg, vae=None):
        assert tcfg.remat and tcfg.accumulate_grad_batches == 1  # the recipe's
        train, ev = real_port_step(model, cfg, tcfg, vae=vae)
        key = [jax.random.PRNGKey(SEED)]  # the JAX train_dpo's key, split per call

        def draws(batch):
            key[0], sub = jax.random.split(key[0])
            return _jax_draws(sub, batch["x_win"].shape)

        def train_inj(state, batch, generator=None):
            seen["port"].append(float(batch["m_win"][0]))
            t, noise = draws(batch)
            return train(state, batch, timesteps=t, noise=noise)

        def eval_inj(state, batch, generator=None):
            t, noise = draws(batch)
            return ev(state, batch, timesteps=t, noise=noise)

        return train_inj, eval_inj

    monkeypatch.setattr(tcli, "make_dpo_train_step", port_step)
    return seen


def _config(module, root, out, max_steps):
    """The recipe's configuration from ``build_config``, cut to a tiny run:
    LoRA r 4, a warmup shorter than the run, a learning rate that moves the
    tiny LoRA, every pair kept whatever its gap."""
    config = module.build_config("CogVideoX1.5-5B", base_path=str(root))
    config.update(output_dir=str(out), max_steps=max_steps, log_every_n_steps=1,
                  checkpoint_every_n_steps=2, lora_rank=4, lora_alpha=8.0, warmup_steps=1,
                  learning_rate=1e-2, seed=SEED, metric_threshold=None)
    return config


def _log(out):
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    train = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    val = {r["step"]: r["val/loss"] for r in recs if "val/loss" in r}
    return train, val


def _kept(out):
    with open(os.path.join(out, "checkpoints", "scores.json")) as f:
        return sorted(json.load(f))


def test_run_recipe_cog15_matches_jax_from_files_and_resumes(recipes, tmp_path, capsys):
    root = tmp_path / "data"
    write_pair_set(root, dataclasses.replace(CFG, sample_frames=LATENT_FHW[0],
                                             sample_height=LATENT_FHW[1],
                                             sample_width=LATENT_FHW[2]))
    outs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    assert trecipes.default_config("CogVideoX1.5-5B") == jrecipes.default_config(
        "CogVideoX1.5-5B")
    run = {"jax": lambda c: jrecipes.run_recipe("CogVideoX1.5-5B", c),
           "port": lambda c: trecipes.run_recipe("CogVideoX1.5-5B", c, device="cpu")}
    printed = {}
    for pkg, module in (("jax", jrecipes), ("port", trecipes)):
        run[pkg](_config(module, root, outs[pkg], 2))
        printed[pkg] = capsys.readouterr().out
    # the recipe's model configuration (here the tiny 1.5 one), T2V
    assert recipes["cfg"]["port"] == (CFG, False) and recipes["cfg"]["jax"] == (JCFG, False)
    # the 98/2 split of the same pairs, and the same epoch order
    split = [line for line in printed["jax"].splitlines() if line.startswith("pairs:")]
    assert split == [line for line in printed["port"].splitlines() if line.startswith("pairs:")]
    assert split == ["pairs: 6 (train 5, val 1)"]
    assert recipes["port"] == recipes["jax"] and len(recipes["port"]) == 2
    (jt, jv), (pt, pv) = _log(outs["jax"]), _log(outs["port"])
    assert sorted(pt) == sorted(jt) == [1, 2] and sorted(pv) == sorted(jv) == [2]
    assert abs(pt[1] - np.log(2.0)) < 1e-6  # B = 0: the policy is the reference
    # the same f32 step; the summation orders differ (test_torch_train_cli.py)
    for step in (1, 2):
        assert abs(pt[step] - jt[step]) <= 1e-5, (step, pt[step], jt[step])
    assert abs(pv[2] - jv[2]) <= 1e-5
    assert _kept(outs["port"]) == _kept(outs["jax"]) == ["step_00000002"]

    # resume: both restart at step 2 and take one more step
    for pkg, module in (("jax", jrecipes), ("port", trecipes)):
        run[pkg](_config(module, root, outs[pkg], 3))
        printed[pkg] = capsys.readouterr().out
    resumed = {pkg: [line.split(" at ")[-1] for line in text.splitlines() if "resumed" in line]
               for pkg, text in printed.items()}
    assert resumed["port"] == resumed["jax"] == ["step 2"]
    assert recipes["port"] == recipes["jax"] and len(recipes["port"]) == 3
    (jt, jv), (pt, pv) = _log(outs["jax"]), _log(outs["port"])
    assert sorted(pt) == sorted(jt) == [1, 2, 3] and sorted(pv) == sorted(jv) == [2, 3]
    assert abs(pt[3] - jt[3]) <= 1e-5 and abs(pv[3] - jv[3]) <= 1e-5
    assert _kept(outs["port"]) == _kept(outs["jax"]) == ["step_00000002", "step_00000003"]

    # the PEFT export: the same keys, shapes and values (1e-5: the LoRA of
    # three f32 updates), and the port's reads back as its last checkpoint's
    pa = safetensors_np.load_file(str(outs["port"] / "final_lora/adapter_model.safetensors"))
    ja = safetensors_np.load_file(str(outs["jax"] / "final_lora/adapter_model.safetensors"))
    assert pa.keys() == ja.keys() and len(pa) == 8 * CFG.num_layers
    for k in ja:
        assert pa[k].shape == ja[k].shape
        np.testing.assert_allclose(pa[k], ja[k], atol=1e-5, err_msg=k)
    assert np.abs(pa[next(k for k in pa if "lora_B" in k)]).max() > 1e-3  # trained
    pc, jc = (json.load(open(outs[k] / "final_lora/adapter_config.json")) for k in ("port", "jax"))
    assert sorted(pc.pop("target_modules")) == sorted(jc.pop("target_modules"))
    assert pc == jc
    lora = import_peft(str(outs["port"] / "final_lora"), CFG.num_layers, device="cpu")
    ckpt = torch.load(outs["port"] / "checkpoints" / "step_00000003" / "state.pt", weights_only=True)
    assert ckpt["step"] == 3
    for name, ab in lora.items():
        for k, v in ab.items():
            torch.testing.assert_close(v, ckpt["lora"][name][k], atol=0, rtol=0)


# (c) ------------------------------------------------------------------------

def test_one_device_reckoning_of_the_cog15_step():
    """The recipe's step (batch 1, accumulate 1: no accumulator; LoRA r 64 /
    alpha 128, remat, bf16) on one device under no mesh, traced on fake
    tensors at full width and two layers: 41,026 tokens, a remat block's
    252,063,744 B (its two residual streams' rows in bf16), no launch, and
    figures that add up."""
    cfg = dataclasses.replace(CogVideoXConfig.cogvideox_1_5_5b(), num_layers=2)
    tcfg = tcli._tcfg(trecipes.default_config("CogVideoX1.5-5B"))
    assert tcfg.accumulate_grad_batches == 1 and tcfg.remat and tcfg.lora_rank == 64
    counts = {f: f.launches for f in (A.flash_attn_fwd, A.flash_attn_bwd, A.flash_attn_short)}
    r = M.aot_train_memory(cfg, tcfg, mesh=M.ONE_DEVICE, batch_size=1)
    assert {f: f.launches for f in counts} == counts
    assert r["tokens"] == 41_026 == (20 // 2) * (96 // 2) * (170 // 2) + 226
    assert r["mesh"] == {"data": 1, "model": 1} and r["global_batch_pairs"] == 1
    assert r["block_residual_bytes"] == 252_063_744 == (40_800 + 226) * 3_072 * 2
    assert r["residual_gib"] == round(2 * 2 * 252_063_744 / 2**30, 3)
    # arguments: the 2-layer base in bf16, LoRA + two AdamW moments in f32
    # (accumulate 1: no accumulator) and the batch in f32
    base = sum(p.numel() * 2 for p in CogVideoXTransformer(cfg, device="meta").parameters())
    lora = 4 * 2 * (2 * 64 * 3_072) * 4
    batch = 2 * (16 * 21 * 96 * 170) * 4 + 226 * 4_096 * 4
    assert r["argument_bytes"] == base + 3 * lora + batch
    assert r["per_device_hbm_bytes"] > r["argument_bytes"]
    assert sum(r["peak_by_category_gib"].values()) == pytest.approx(r["per_device_hbm_gib"],
                                                                     abs=2e-3)
