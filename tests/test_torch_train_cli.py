"""The train leg from files on the port (``videogpa_torch/cli/train_dpo.py``,
``train/recipes.py::run_recipe``, ``data/prefetch.py``) against the JAX
package's ``train_dpo`` on the CPU.

Both trainers read the same tiny preference set from files and train the
tiny CogVideoX DiT, with ``load_cogvideox`` monkeypatched in both to hand
over the same weights, the JAX LoRA initialisation handed to the port, the
port's step draws (timesteps, noise) injected from the JAX train_dpo's key
sequence, and both trainers in f32 without remat (``TrainerConfig`` with
f32 compute, XLA attention in JAX). Compared: the split, the batch order, each step's loss,
the validation losses, the checkpoint steps kept, the exported PEFT keys,
shapes and values, and the resume step (``tests/test_cli.py::
TestTrainResume``); the drop-last guard. ``prefetch_to_device`` and
``BatchLoader`` on the CPU.

Tolerances: losses and PEFT values within 1e-5 (the same f32 step; the
summation orders differ), everything else exact.
"""

import dataclasses
import functools
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
import videogpa_torch.cli.train_dpo as tcli
from videogpa_torch.convert import load_jax_params
from videogpa_torch.data.prefetch import BatchLoader, prefetch_to_device
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from videogpa_torch.train import recipes as trecipes
from videogpa_torch.train import trainer as ttrainer
from videogpa_torch.train.dataset import DPODataset, collate
from videogpa_torch.train.lora import import_peft
from videogpa_torch.utils import safetensors_np

torch.set_num_threads(2)
CFG = CogVideoXConfig.tiny()
SEED = 3


def write_pair_set(root, cfg, n_groups=6, seed=0):
    """``n_groups`` prompt groups of three scored candidates with latents
    (C, F, H, W) and T5-shaped conditions as .npz, in the metadata schema
    of ``train.dataset`` (winner: the least consistency score)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "latents"), exist_ok=True)
    groups = []
    for g in range(n_groups):
        cond = f"latents/cond_{g}.npz"
        np.savez(os.path.join(root, cond), encoder_hidden_states=rng.standard_normal(
            (cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32))
        videos = []
        for i, score in enumerate((0.1 + 0.01 * g, 0.5, 0.3)):
            lat = f"latents/lat_{g}_{i}.npz"
            np.savez(os.path.join(root, lat), data=rng.standard_normal(
                (cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height,
                 cfg.sample_width), dtype=np.float32))
            videos.append({"video_path": f"v_{g}_{i}.mp4", "consistency_score": score,
                           "motion_norm": 0.1, "latent_path": lat, "condition_path": cond})
        groups.append({"group_id": f"g{g}", "prompt": f"prompt {g}", "videos": videos})
    with open(os.path.join(root, "meta_data.json"), "w") as f:
        json.dump({"groups": groups}, f)


def _config(root, out, **kw):
    config = trecipes.default_config("CogVideoX-5B")
    config.update(base_path=str(root), metadata_path=str(root / "meta_data.json"),
                  output_dir=str(out), model_path="unused", max_steps=3, batch_size=1,
                  accumulate_grad_batches=1, log_every_n_steps=1, checkpoint_every_n_steps=2,
                  save_top_k=1, lora_rank=4, lora_alpha=8.0, warmup_steps=1,
                  learning_rate=1e-2, seed=SEED, metric_threshold=None)
    config.update(kw)
    return config


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    params = jax_dit_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(CogVideoXTransformer(CFG), jax.tree.map(np.asarray, params))
    return jcfg, params, model.requires_grad_(False)


@pytest.fixture
def runs(models, monkeypatch):
    """Both trainers on the same weights, f32, with the port's LoRA init and
    step draws taken from the JAX train_dpo's seeds and key sequence; records
    each one's batches (by the winner's score) in order."""
    jcfg, params, model = models
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jloader, "load_cogvideox", lambda *a, **k: (params, None))
    monkeypatch.setattr(tcli, "load_cogvideox", lambda *a, **k: (model, None))
    monkeypatch.setattr(jtrainer, "TrainerConfig", functools.partial(
        jtrainer.TrainerConfig, compute_dtype=jnp.float32, attn_impl="xla", remat=False))
    monkeypatch.setattr(tcli, "TrainerConfig", functools.partial(
        ttrainer.TrainerConfig, compute_dtype=torch.float32, remat=False))

    real_jax_step = jtrainer.make_dpo_train_step

    def jax_step(*a, **k):
        train, ev = real_jax_step(*a, **k)

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
        train, ev = real_port_step(model, cfg, tcfg, vae=vae)
        key = [jax.random.PRNGKey(SEED)]  # the JAX train_dpo's key, split per call

        def draws(batch):
            key[0], sub = jax.random.split(key[0])
            B, C, F, H, W = batch["x_win"].shape
            k_t, k_noise, _ = jax.random.split(sub, 3)
            t = torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 1000)))
            noise = torch.from_numpy(np.array(jax.random.normal(k_noise, (B, F, C, H, W))))
            return t, noise

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


def _log(out):
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    train = {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}
    val = {r["step"]: r["val/loss"] for r in recs if "val/loss" in r}
    return train, val


def _kept(out):
    """The checkpoints kept, by the checkpointer's own record (the JAX
    package's orbax writes asynchronously, so a pruned step directory can
    reappear on disk after its removal)."""
    with open(os.path.join(out, "checkpoints", "scores.json")) as f:
        return sorted(json.load(f))


def test_train_dpo_matches_the_jax_train_dpo_and_resumes(runs, tmp_path, capsys):
    root = tmp_path / "data"
    write_pair_set(root, CFG)
    outs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jcli.train_dpo(_config(root, outs["jax"]), JaxConfig(**dataclasses.asdict(CFG)))
    jax_out = capsys.readouterr().out
    tcli.train_dpo(_config(root, outs["port"]), CFG, device="cpu")
    port_out = capsys.readouterr().out
    # the 98/2 split of the same pairs, and the same epoch order
    split = [line for line in jax_out.splitlines() if line.startswith("pairs:")]
    assert split == [line for line in port_out.splitlines() if line.startswith("pairs:")]
    assert split == ["pairs: 6 (train 5, val 1)"]
    assert runs["port"] == runs["jax"] and len(runs["port"]) == 3
    (jt, jv), (pt, pv) = _log(outs["jax"]), _log(outs["port"])
    assert sorted(pt) == sorted(jt) == [1, 2, 3] and sorted(pv) == sorted(jv) == [2, 3]
    assert abs(pt[1] - np.log(2.0)) < 1e-6  # B = 0: the policy is the reference
    for step in (1, 2, 3):
        assert abs(pt[step] - jt[step]) <= 1e-5, (step, pt[step], jt[step])
    for step in (2, 3):
        assert abs(pv[step] - jv[step]) <= 1e-5
    # top-1 by validation loss, the same step kept
    assert _kept(outs["port"]) == _kept(outs["jax"]) and len(_kept(outs["port"])) == 1
    # the PEFT export: the same keys, shapes and values
    pa = safetensors_np.load_file(str(outs["port"] / "final_lora/adapter_model.safetensors"))
    ja = safetensors_np.load_file(str(outs["jax"] / "final_lora/adapter_model.safetensors"))
    assert pa.keys() == ja.keys() and len(pa) == 8 * CFG.num_layers
    for k in ja:
        assert pa[k].shape == ja[k].shape
        np.testing.assert_allclose(pa[k], ja[k], atol=1e-5, err_msg=k)
    pc, jc = (json.load(open(outs[k] / "final_lora/adapter_config.json")) for k in ("port", "jax"))
    # a set of module names (JAX lists the LoRA tree's keys in pytree order)
    assert sorted(pc.pop("target_modules")) == sorted(jc.pop("target_modules"))
    assert pc == jc

    # resume: both restart at the checkpoint kept and take the steps left
    jcli.train_dpo(_config(root, outs["jax"], max_steps=4), JaxConfig(**dataclasses.asdict(CFG)))
    jax_out = capsys.readouterr().out
    tcli.train_dpo(_config(root, outs["port"], max_steps=4), CFG, device="cpu")
    port_out = capsys.readouterr().out
    resumed = [line.split(" at ")[-1] for line in port_out.splitlines() if "resumed" in line]
    assert resumed == [line.split(" at ")[-1] for line in jax_out.splitlines()
                       if "resumed" in line]
    assert resumed and resumed[0].startswith("step ")
    start = int(resumed[0].split()[1])
    assert len(runs["port"]) == 3 + 4 - start == len(runs["jax"])


def test_batch_size_past_the_training_set_raises(runs, tmp_path):
    root = tmp_path / "data"
    write_pair_set(root, CFG, n_groups=3)
    for train, kw in ((jcli.train_dpo, {}), (tcli.train_dpo, {"device": "cpu"})):
        cfg = JaxConfig(**dataclasses.asdict(CFG)) if train is jcli.train_dpo else CFG
        with pytest.raises(ValueError, match="exceeds the 2-pair training set"):
            train(_config(root, tmp_path / "out", batch_size=3), cfg, **kw)


def test_prefetch_and_batch_loader_on_the_cpu(tmp_path):
    root = tmp_path / "data"
    write_pair_set(root, CFG, n_groups=5)
    ds = DPODataset(str(root), str(root / "meta_data.json"), metric_threshold=None)
    loader = BatchLoader(ds, range(len(ds)), batch_size=2, collate=collate, num_workers=2,
                         shuffle_seed=1)
    assert len(loader) == 2
    first = list(loader)
    order = np.random.default_rng(1).permutation(len(ds))
    want = collate([ds[int(i)] for i in order[:2]])
    np.testing.assert_array_equal(first[0]["x_win"], want["x_win"])
    batches = list(prefetch_to_device(iter(first), device="cpu"))
    assert len(batches) == 2 and isinstance(batches[0]["x_win"], torch.Tensor)
    torch.testing.assert_close(batches[1]["prompt_emb"], torch.from_numpy(first[1]["prompt_emb"]))
    assert batches[0]["prompt"] == first[0]["prompt"]

    def broken():
        yield first[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(broken(), device="cpu"))


def test_import_peft_reads_the_exported_lora(runs, tmp_path):
    root = tmp_path / "data"
    write_pair_set(root, CFG)
    out = tmp_path / "port"
    tcli.train_dpo(_config(root, out, max_steps=2), CFG, device="cpu")
    lora = import_peft(str(out / "final_lora"), CFG.num_layers, device="cpu")
    ckpt = torch.load(out / "checkpoints" / _kept(out)[0] / "state.pt", weights_only=True)
    for name, ab in lora.items():
        for k, v in ab.items():
            torch.testing.assert_close(v, ckpt["lora"][name][k], atol=0, rtol=0)
