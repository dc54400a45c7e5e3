"""The Wan2.2 flows and the encode leg on the port, on ``WanConfig.tiny()``
and ``CogVideoXConfig.tiny()`` on the CPU, against the JAX package.

- ``sample_ti2v`` (T2V and TI2V) against JAX's ``sample_ti2v`` with both
  draws injected (the image's posterior noise and the initial latents, from
  the JAX key's split), f32 compute: max |delta| <= 1e-3.
- ``run_recipe("Wan2.2-TI2V-5B", ..., model_cfg=tiny)`` from a root-layout
  safetensors checkpoint and .npz pairs against JAX's ``train_wan_dpo``
  (its 5B config monkeypatched to the tiny one), both with f32 compute on
  bf16 base weights, the JAX LoRA initialisation and step draws injected:
  the same batches, each step's loss and the validation losses within 1e-5,
  the same checkpoints kept, the exported PEFT adapter (keys, values within
  1e-5, config) equal; the resume, and the batch-size error.
- ``generate_wan.main``, ``encode.main`` and ``encode_wan.main`` on tiny
  checkpoint directories with the tokenizer stubbed: the mp4 written is
  ``sample_ti2v``'s video (LoRA merged, image conditioned, a random VAE
  when none is on disk); the encode artifacts equal JAX's ``t5_encode`` /
  ``vae_encode`` / ``wan_vae_encode`` of the same ids and frames (the
  CogVideoX posterior noise: the CLI's per-group generator, and JAX's
  ``PRNGKey(gi)`` draw injected into the port's ``vae_encode``), within
  1e-4, and resume and the metadata rewrite work.
"""

import dataclasses
import functools
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import videogpa_tpu.models.wan as jwan
import videogpa_tpu.train.trainer as jtrainer
import videogpa_tpu.train.wan_trainer as jwan_trainer
from test_torch_bridge import random_jax_tree
from test_torch_generate_cli import FakeTokenizer, _checkpoint_dir
from test_torch_t5 import _tiny_hf
from test_wan_parity import WanOracle
from test_wan_vae_parity import WanVAEOracle
from videogpa_tpu.cli import train_dpo as jcli
from videogpa_tpu.data.video_io import read_video_frames as j_read_video_frames
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxCogConfig
from videogpa_tpu.models.cogvideox.convert import convert_vae as j_convert_vae
from videogpa_tpu.models.cogvideox.vae import vae_encode as j_vae_encode
from videogpa_tpu.models.t5 import encoder as jt5
from videogpa_tpu.models.wan import convert as jconvert
from videogpa_tpu.models.wan import dit as jdit
from videogpa_tpu.models.wan import pipeline as jpipe
from videogpa_tpu.models.wan import vae as jvae
from videogpa_tpu.train import lora as jlora
from videogpa_torch.cli import encode as tencode
from videogpa_torch.cli import encode_wan as tencode_wan
from videogpa_torch.cli import generate_wan as tgen
from videogpa_torch.cli import train_dpo as tcli
from videogpa_torch.convert import load_jax_params
from videogpa_torch.data import video_io
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.cogvideox import CogVideoXConfig
from videogpa_torch.models.cogvideox.vae import vae_encode
from videogpa_torch.models.t5 import T5Config
from videogpa_torch.models.wan import (
    WanConfig, WanTransformer, WanVAE, sample_ti2v, wan_vae_init)
from videogpa_torch.models.wan.convert import convert_wan_vae
from videogpa_torch.train import recipes as trecipes
from videogpa_torch.train import trainer as ttrainer
from videogpa_torch.train import wan_trainer as twan_trainer
from videogpa_torch.train.lora import export_peft, lora_init, merge_lora
from videogpa_torch.utils import safetensors_np

torch.set_num_threads(2)
CFG = WanConfig.tiny()
JCFG = jwan.WanConfig(**dataclasses.asdict(CFG))
T5_CFG = T5Config.tiny(per_layer_bias=True)  # umT5's per-layer bias, d_model = text_dim
LAT = (CFG.vae_z_dim, 3, 8, 8)  # (C, F, H, W): 9 frames at 128 x 128


# the JAX encoders jitted (their references here ran eagerly, op by op)
_j_t5_encode = jax.jit(jt5.t5_encode, static_argnums=(3,))
_j_wan_vae_encode = jax.jit(jvae.wan_vae_encode, static_argnums=(2,))
_j_vae_encode = jax.jit(j_vae_encode, static_argnums=(2,), static_argnames=("sample",))


def _vae_sd(seed=0):
    torch.manual_seed(seed)
    oracle = WanVAEOracle(dim=CFG.vae_base_ch, dec_dim=CFG.vae_dec_base_ch, z_dim=CFG.vae_z_dim,
                          dim_mult=CFG.vae_dim_mult, n_res=CFG.vae_num_res_blocks,
                          t_down=CFG.vae_temporal_down)
    return {k: v.numpy() for k, v in oracle.state_dict().items()}


def _vae_pair(seed=0):
    sd = _vae_sd(seed)
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(CFG.vae_z_dim).astype(np.float32) * 0.3
    std = rng.uniform(0.8, 1.5, CFG.vae_z_dim).astype(np.float32)
    params = jconvert.convert_wan_vae(sd, JCFG, latents_mean=mean, latents_std=std)
    vae = tloader._module_from_state_dict(WanVAE, CFG, convert_wan_vae(sd, CFG, mean, std),
                                          "cpu", torch.float32)
    return params, vae


# ---------------------------------------------------------------------------
# sample_ti2v
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ti2v_models():
    """The JAX DiT tree and its bridge, the JAX and port Wan VAEs, built once."""
    params = random_jax_tree(jdit.wan_init, JCFG, seed=1)
    model = load_jax_params(WanTransformer(CFG), jax.tree.map(np.asarray, params))
    return (params, model) + _vae_pair(2)


@pytest.mark.parametrize("with_image", [False, True])
def test_sample_ti2v_matches_jax_with_its_draws(with_image, ti2v_models):
    params, model, vparams, vae = ti2v_models
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((2, CFG.text_len, CFG.text_dim), dtype=np.float32)
    image = rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32) if with_image else None
    key = jax.random.PRNGKey(4)
    kw = dict(num_frames=5, height=64, width=64, num_steps=3, guidance_scale=5.0)
    want = np.asarray(jpipe.sample_ti2v(
        params, vparams, jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]), JCFG, key,
        image=None if image is None else jnp.asarray(image), attn_impl="xla",
        compute_dtype=jnp.float32, **kw))
    shape = (1, CFG.vae_z_dim, 2, 4, 4)
    image_noise = None
    if with_image:
        k_img, key = jax.random.split(key)
        image_noise = torch.from_numpy(np.array(jax.random.normal(
            k_img, (1, CFG.vae_z_dim, 1, 4, 4), jnp.float32)))
    latents = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    got = sample_ti2v(model, vae, torch.from_numpy(ctx[:1]), torch.from_numpy(ctx[1:]), CFG,
                      image=None if image is None else torch.from_numpy(image),
                      compute_dtype=torch.float32, image_noise=image_noise, latents=latents,
                      **kw)
    assert got.shape == want.shape == (1, 3, 5, 64, 64) and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0 and (np.abs(want) < 0.999).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# train_wan_dpo through run_recipe
# ---------------------------------------------------------------------------

def _write_wan_pairs(root, n_groups=6, seed=0):
    """``n_groups`` groups of three scored candidates, .npz latents and umT5-
    shaped conditions with the first frame's ``image_latent``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "latents"), exist_ok=True)
    groups = []
    for g in range(n_groups):
        cond = f"latents/cond_{g}.npz"
        np.savez(os.path.join(root, cond),
                 encoder_hidden_states=rng.standard_normal((CFG.text_len, CFG.text_dim),
                                                           dtype=np.float32),
                 image_latent=rng.standard_normal((LAT[0], 1) + LAT[2:], dtype=np.float32))
        videos = []
        for i, score in enumerate((0.1 + 0.01 * g, 0.5, 0.3)):
            lat = f"latents/lat_{g}_{i}.npz"
            np.savez(os.path.join(root, lat), data=rng.standard_normal(LAT, dtype=np.float32))
            videos.append({"video_path": f"v_{g}_{i}.mp4", "consistency_score": score,
                           "motion_norm": 0.1, "latent_path": lat, "condition_path": cond})
        groups.append({"group_id": f"g{g}", "prompt": f"prompt {g}", "videos": videos})
    with open(os.path.join(root, "meta_data.json"), "w") as f:
        json.dump({"groups": groups}, f)


def _wan_checkpoint(root, seed=0):
    """A root-layout Wan2.2 checkpoint: the ``WanModel`` safetensors."""
    torch.manual_seed(seed)
    oracle = WanOracle(JCFG)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if "modulation" in name or name.startswith("head."):
                p.normal_(0.0, 0.3)
    os.makedirs(root, exist_ok=True)
    safetensors_np.save_file({k: v.numpy() for k, v in oracle.state_dict().items()
                              if k != "freqs"},
                             os.path.join(root, "diffusion_pytorch_model.safetensors"))


def _wan_config(data, out, ckpt, **kw):
    config = trecipes.build_config("Wan2.2-TI2V-5B", base_path=str(data))
    config.update(output_dir=str(out), model_path=str(ckpt), max_steps=3, batch_size=1,
                  accumulate_grad_batches=1, log_every_n_steps=1, checkpoint_every_n_steps=2,
                  save_top_k=1, lora_rank=4, lora_alpha=8.0, warmup_steps=1,
                  learning_rate=1e-2, metric_threshold=None)
    config.update(kw)
    return config


@pytest.fixture
def wan_runs(monkeypatch):
    """Both Wan trainers in f32 compute, the port's LoRA init and step draws
    taken from the JAX trainer's PRNGKey(0) sequence; records each one's
    batches (by the winner's score) in order."""
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jwan.WanConfig, "ti2v_5b", staticmethod(lambda: JCFG))
    monkeypatch.setattr(jtrainer, "TrainerConfig", functools.partial(
        jtrainer.TrainerConfig, compute_dtype=jnp.float32, attn_impl="xla", remat=False))
    monkeypatch.setattr(tcli, "TrainerConfig", functools.partial(
        ttrainer.TrainerConfig, compute_dtype=torch.float32, remat=False))
    real_jax_step = jwan_trainer.make_wan_dpo_train_step

    def jax_step(*a, **k):
        train, ev = real_jax_step(*a, **k)

        def train_rec(state, batch, key):
            seen["jax"].append(float(np.asarray(batch["m_win"])[0]))
            return train(state, batch, key)

        return train_rec, ev

    monkeypatch.setattr(jwan_trainer, "make_wan_dpo_train_step", jax_step)

    def port_lora(num_layers, dim, rank, generator, device=None):
        lora = jlora.lora_init(jax.random.PRNGKey(0), num_layers, dim, rank=rank)
        return {n: {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in ab.items()}
                for n, ab in lora.items()}

    monkeypatch.setattr(tcli, "lora_init", port_lora)
    real_port_step = twan_trainer.make_wan_dpo_train_step

    def port_step(model, cfg, tcfg):
        train, ev = real_port_step(model, cfg, tcfg)
        key = [jax.random.PRNGKey(0)]  # the JAX trainer's key, split per call

        def draws(batch):
            key[0], sub = jax.random.split(key[0])
            k_t, k_noise = jax.random.split(sub)
            shape = tuple(batch["x_win"].shape)
            t = np.array(jax.random.randint(k_t, (shape[0],), 1, CFG.num_train_timesteps))
            noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
            return torch.from_numpy(t), torch.from_numpy(noise)

        def train_inj(state, batch, generator=None):
            seen["port"].append(float(batch["m_win"][0]))
            t, noise = draws(batch)
            return train(state, batch, timesteps=t, noise=noise)

        def eval_inj(state, batch, generator=None):
            t, noise = draws(batch)
            return ev(state, batch, timesteps=t, noise=noise)

        return train_inj, eval_inj

    monkeypatch.setattr(tcli, "make_wan_dpo_train_step", port_step)
    return seen


def _log(out):
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return ({r["step"]: r["train/loss"] for r in recs if "train/loss" in r},
            {r["step"]: r["val/loss"] for r in recs if "val/loss" in r})


def _kept(out):
    with open(os.path.join(out, "checkpoints", "scores.json")) as f:
        return sorted(json.load(f))


def test_run_recipe_wan_matches_the_jax_train_wan_dpo_and_resumes(wan_runs, tmp_path, capsys):
    data, ckpt = tmp_path / "data", tmp_path / "wan"
    _write_wan_pairs(str(data))
    _wan_checkpoint(str(ckpt))
    outs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jcli.train_wan_dpo(_wan_config(data, outs["jax"], ckpt))
    jax_out = capsys.readouterr().out
    trecipes.run_recipe("Wan2.2-TI2V-5B", _wan_config(data, outs["port"], ckpt), device="cpu",
                        model_cfg=CFG)
    port_out = capsys.readouterr().out
    split = [line for line in jax_out.splitlines() if line.startswith("pairs:")]
    assert split == [line for line in port_out.splitlines() if line.startswith("pairs:")]
    assert split == ["pairs: 6 (train 5, val 1)"]
    assert wan_runs["port"] == wan_runs["jax"] and len(wan_runs["port"]) == 3
    (jt, jv), (pt, pv) = _log(outs["jax"]), _log(outs["port"])
    assert sorted(pt) == sorted(jt) == [1, 2, 3] and sorted(pv) == sorted(jv) == [2, 3]
    assert abs(pt[1] - np.log(2.0)) < 1e-6  # B = 0: the policy is the reference
    for step in (1, 2, 3):
        assert abs(pt[step] - jt[step]) <= 1e-5, (step, pt[step], jt[step])
    # the first update runs at lr schedule(0) = 0; the second moves the LoRA
    assert abs(pt[3] - np.log(2.0)) > 1e-4
    for step in (2, 3):
        assert abs(pv[step] - jv[step]) <= 1e-5
    assert _kept(outs["port"]) == _kept(outs["jax"]) and len(_kept(outs["port"])) == 1
    # the PEFT export of the Wan layout: keys, values, config
    pa = safetensors_np.load_file(str(outs["port"] / "final_lora/adapter_model.safetensors"))
    ja = safetensors_np.load_file(str(outs["jax"] / "final_lora/adapter_model.safetensors"))
    assert pa.keys() == ja.keys() and len(pa) == 8 * CFG.num_layers
    assert all(k.startswith("base_model.model.blocks.") for k in pa)
    for k in ja:
        np.testing.assert_allclose(pa[k], ja[k], atol=1e-5, err_msg=k)
    pc = json.loads((outs["port"] / "final_lora/adapter_config.json").read_text())
    jc = json.loads((outs["jax"] / "final_lora/adapter_config.json").read_text())
    # PEFT reads target_modules as a set; the JAX optimiser hands back the
    # LoRA tree with its keys sorted
    for c in (pc, jc):
        c["target_modules"] = sorted(c["target_modules"])
    assert pc == jc and pc["auto_mapping"] == {"base_model_class": "WanModel",
                                               "parent_library": "wan.modules.model"}

    # resume: the checkpoint kept goes on to step 4
    kept = int(_kept(outs["port"])[0].removeprefix("step_"))
    trecipes.run_recipe("Wan2.2-TI2V-5B", _wan_config(data, outs["port"], ckpt, max_steps=4),
                        device="cpu", model_cfg=CFG)
    assert f"at step {kept}" in capsys.readouterr().out
    assert sorted(_log(outs["port"])[0]) == [1, 2, 3, 4]
    # drop-last batching needs a batch of pairs
    with pytest.raises(ValueError, match="exceeds the 5-pair"):
        trecipes.run_recipe("Wan2.2-TI2V-5B", _wan_config(
            data, tmp_path / "big", ckpt, batch_size=6), device="cpu", model_cfg=CFG)


# ---------------------------------------------------------------------------
# generate_wan
# ---------------------------------------------------------------------------

def _umt5_dir(root):
    torch.manual_seed(7)
    hf, _ = _tiny_hf(per_layer_bias=True)
    os.makedirs(os.path.join(root, "text_encoder"), exist_ok=True)
    safetensors_np.save_file({k: v.numpy() for k, v in hf.state_dict().items()},
                             os.path.join(root, "text_encoder", "model.safetensors"))
    os.makedirs(os.path.join(root, "tokenizer"), exist_ok=True)


def _stub_tokenizer(monkeypatch):
    seen = []
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda path: seen.append(path) or FakeTokenizer())
    return seen


def _write_mp4(path, frames, fps=8):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames.shape[2], frames.shape[1]))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def _gradient_frames(T, H, W, seed):
    """Smooth frames (a codec keeps them close), uint8 (T, H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(T):
        c = rng.uniform(0, 1, 3)
        f = np.stack([(np.sin(xx / (7 + 3 * k) + t * 0.3 + c[k] * 6) + 1) * 110 + 15
                      + 0.2 * yy for k in range(3)], -1)
        out.append(f.clip(0, 255).astype(np.uint8))
    return np.stack(out)


def test_generate_wan_main_writes_the_sampled_video(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "wan"
    _wan_checkpoint(str(ckpt), seed=8)
    _umt5_dir(str(ckpt))
    torch.save({k: torch.from_numpy(v) for k, v in _vae_sd(9).items()},
               ckpt / "Wan2.2_VAE.pth")
    (ckpt / "vae_stats.json").write_text(json.dumps(
        {"latents_mean": [0.1] * 6, "latents_std": [1.2] * 6}))
    seen = _stub_tokenizer(monkeypatch)
    lora = lora_init(CFG.num_layers, CFG.dim, 4, torch.Generator().manual_seed(10), device="cpu")
    for ab in lora.values():
        ab["lora_B"].data.normal_(0, 0.1, generator=torch.Generator().manual_seed(11))
    export_peft(lora, str(tmp_path / "lora"), rank=4, alpha=8.0, base_model_class="WanModel",
                parent_library="wan.modules.model", block_prefix="blocks")
    cv2.imwrite(str(tmp_path / "img.png"), _gradient_frames(1, 40, 50, 12)[0])
    (tmp_path / "p.json").write_text(json.dumps(
        [{"group_id": "g/1", "prompt": "a cat", "image_path": "img.png"},
         {"group_id": "empty", "prompt": "  "}]))
    videos = {}
    real_write = video_io.write_video

    def write_video(path, frames, fps):
        videos[path] = frames
        real_write(path, frames, fps)

    monkeypatch.setattr(video_io, "write_video", write_video)
    argv = ["--base_model", str(ckpt), "--prompt_json", str(tmp_path / "p.json"),
            "--output_dir", str(tmp_path / "out"), "--lora_path", str(tmp_path / "lora"),
            "--lora_weight", "0.5", "--base_dir", str(tmp_path), "--seed", "3",
            "--num_inference_steps", "2", "--num_frames", "5", "--height", "32",
            "--width", "32"]
    tgen.main(argv, cfg=CFG, t5_cfg=T5_CFG, device="cpu")
    out = capsys.readouterr().out
    path = str(tmp_path / "out" / "g_1" / "seed_3.mp4")
    assert "LoRA merged (relative weight 0.5)" in out and out.rstrip().endswith("Done.")
    assert list(videos) == [path] and os.path.getsize(path) > 0
    assert seen == [str(ckpt / "tokenizer")]

    # the same video from the loaded parts: LoRA merged at 0.5 x alpha / r
    dit = tloader.load_wan(str(ckpt), CFG, device="cpu")
    merge_lora(dit, lora, 4, 8.0, weight=0.5, layout="wan")
    vae = tloader.load_wan_vae(str(ckpt), CFG, device="cpu")
    t5, _ = tloader.load_t5(str(ckpt), T5_CFG, device="cpu")
    from videogpa_torch.models.t5 import t5_encode

    def emb(text):
        t = FakeTokenizer()(text, max_length=CFG.text_len)
        return t5_encode(t5, torch.from_numpy(t["input_ids"]),
                         torch.from_numpy(t["attention_mask"]))

    img = cv2.resize(cv2.cvtColor(cv2.imread(str(tmp_path / "img.png")), cv2.COLOR_BGR2RGB),
                     (32, 32), interpolation=cv2.INTER_AREA)
    image = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
    video = sample_ti2v(dit, vae, emb("a cat"), emb(""), CFG, image=image, num_frames=5,
                        height=32, width=32, num_steps=2,
                        generator=torch.Generator().manual_seed(3))
    want = ((video[0].numpy().transpose(1, 2, 3, 0) + 1) * 127.5).clip(0, 255).astype(np.uint8)
    np.testing.assert_array_equal(videos[path], want)

    # resume skips the written video; no VAE on disk -> a random VAE, warned
    os.remove(ckpt / "Wan2.2_VAE.pth")
    videos.clear()
    tgen.main(argv, cfg=CFG, t5_cfg=T5_CFG, device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: Wan VAE weights not found" in out and videos == {}


def test_random_vae_fallback_is_wan_vae_init_of_seed_0():
    a = wan_vae_init(CFG, torch.Generator().manual_seed(0), device="cpu")
    b = wan_vae_init(CFG, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# ---------------------------------------------------------------------------
# encode CLIs
# ---------------------------------------------------------------------------

def _metadata(path, groups):
    with open(path, "w") as f:
        json.dump({"groups": groups}, f)


def test_encode_main_writes_the_jax_artifacts(tmp_path, monkeypatch, capsys):
    cfg = CogVideoXConfig.tiny(i2v=True)
    jcfg = JaxCogConfig(**dataclasses.asdict(cfg))
    t5_cfg = T5Config.tiny()
    ckpt = tmp_path / "cog"
    _checkpoint_dir(ckpt, cfg, t5_cfg)
    _stub_tokenizer(monkeypatch)
    base = tmp_path / "data"
    base.mkdir()
    for g in range(2):
        _write_mp4(base / f"v{g}.mp4", _gradient_frames(10, 48, 72, 20 + g))
    cv2.imwrite(str(base / "img.png"), _gradient_frames(1, 50, 70, 30)[0])
    meta = base / "meta.json"
    _metadata(meta, [
        {"group_id": "a/b", "prompt": "a cat", "image_path": "img.png",
         "videos": [{"video_path": "v0.mp4", "generation_id": 0},
                    {"video_path": "missing.mp4", "generation_id": 1}]},
        {"group_id": "c", "prompt": "a dog", "videos": [{"video_path": "v1.mp4"}]}])
    argv = ["--metadata", str(meta), "--base_dir", str(base), "--model_path", str(ckpt),
            "--num_frames", "9", "--height", "64", "--width", "96"]
    tencode.main(argv, cfg=cfg, t5_cfg=t5_cfg, device="cpu")
    out = capsys.readouterr().out
    assert "encode failed missing.mp4" in out and out.rstrip().endswith("Done.")
    data = json.loads(meta.read_text())
    assert [v["latent_path"] for g in data["groups"] for v in g["videos"]] == [
        "dpo_latents/latent_a_b_0.npz", "dpo_latents/latent_a_b_1.npz",
        "dpo_latents/latent_c_0.npz"]
    assert data["groups"][1]["videos"][0]["condition_path"] == "dpo_latents/condition_c.npz"

    # the JAX script's computation on the same ids and frames
    sd = tloader._to_f32(tloader.load_safetensors_dir(str(ckpt / "text_encoder")))
    jt5_params = jt5.convert_t5_encoder(sd, jt5.T5Config(**dataclasses.asdict(t5_cfg)))
    jvae_params = j_convert_vae(tloader._to_f32(tloader.load_safetensors_dir(str(ckpt / "vae"))),
                                jcfg)
    vae = tloader.load_cogvideox_vae(str(ckpt), cfg, device="cpu")
    for gi, (gid, prompt, video) in enumerate((("a_b", "a cat", "v0.mp4"),
                                               ("c", "a dog", "v1.mp4"))):
        cond = np.load(base / "dpo_latents" / f"condition_{gid}.npz")
        ids = FakeTokenizer()(prompt, max_length=cfg.max_text_seq_length)["input_ids"]
        want = np.asarray(_j_t5_encode(jt5_params, jnp.asarray(ids), None,
                                       jt5.T5Config(**dataclasses.asdict(t5_cfg))))[0]
        np.testing.assert_allclose(cond["encoder_hidden_states"], want, atol=1e-4, rtol=0)
        assert ("image_embeds" in cond.files) == (gi == 0)
        if gi == 0:
            img = cv2.resize(cv2.cvtColor(cv2.imread(str(base / "img.png")), cv2.COLOR_BGR2RGB),
                             (96, 64), interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(
                cond["image_embeds"], img.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0)
        frames = np.stack([cv2.resize(f, (96, 64), interpolation=cv2.INTER_AREA)
                           for f in j_read_video_frames(str(base / video), np.arange(9))])
        vid = frames.astype(np.float32).transpose(3, 0, 1, 2)[None] / 127.5 - 1.0
        got = np.load(base / "dpo_latents" / f"latent_{gid}_0.npz")["data"]
        assert got.shape == (cfg.vae_latent_channels, 3, 8, 12)
        # the CLI's draw: a generator seeded with the group's index
        mine = vae_encode(vae, torch.from_numpy(vid), cfg,
                          generator=torch.Generator().manual_seed(gi))[0].numpy()
        np.testing.assert_array_equal(got, mine)
        # with JAX's PRNGKey(gi) draw injected, the port's vae_encode is JAX's
        want = np.asarray(_j_vae_encode(jvae_params, jnp.asarray(vid), jcfg,
                                        key=jax.random.PRNGKey(gi), sample=True))
        noise = np.array(jax.random.normal(jax.random.PRNGKey(gi),
                                           (1, cfg.vae_latent_channels, 3, 8, 12)))
        port = vae_encode(vae, torch.from_numpy(vid), cfg, noise=torch.from_numpy(noise))
        np.testing.assert_allclose(port.numpy(), want, atol=1e-4, rtol=0)

    # resume: nothing is re-encoded
    stamps = {p: p.stat().st_mtime_ns for p in (base / "dpo_latents").iterdir()}
    tencode.main(argv, cfg=cfg, t5_cfg=t5_cfg, device="cpu")
    assert stamps == {p: p.stat().st_mtime_ns for p in (base / "dpo_latents").iterdir()
                      if p in stamps}


def test_encode_recipe_defaults_are_the_wrappers():
    base = ["--metadata", "m", "--base_dir", "d"]
    assert (tencode.parse_args(base).model_path, tencode.parse_args(base).num_frames) == (
        "THUDM/CogVideoX-5B-I2V", 49)
    a = tencode.parse_args(base + ["--recipe", "CogVideoX-5B"])
    assert (a.model_path, a.num_frames) == ("THUDM/CogVideoX-5B", 49)
    a = tencode.parse_args(base + ["--recipe", "CogVideoX1.5-5B"])
    assert (a.model_path, a.num_frames) == ("THUDM/CogVideoX1.5-5B", 81)
    a = tencode.parse_args(base + ["--recipe", "CogVideoX1.5-5B", "--num_frames", "49",
                                   "--model_path", "x"])
    assert (a.model_path, a.num_frames) == ("x", 49)
    w = tencode_wan.parse_args(base)
    assert (w.model_path, w.num_frames, w.height, w.width) == (
        "Wan-AI/Wan2.2-TI2V-5B", 81, 704, 1280)


def test_encode_wan_main_writes_the_jax_artifacts(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "wan"
    _umt5_dir(str(ckpt))
    (ckpt / "vae").mkdir()
    sd = _vae_sd(13)
    safetensors_np.save_file(sd, str(ckpt / "vae" / "diffusion_pytorch_model.safetensors"))
    stats = {"latents_mean": [0.05 * i for i in range(6)], "latents_std": [1.1] * 6}
    (ckpt / "vae" / "config.json").write_text(json.dumps(stats))
    _stub_tokenizer(monkeypatch)
    base = tmp_path / "data"
    base.mkdir()
    _write_mp4(base / "v.mp4", _gradient_frames(9, 40, 56, 40))
    cv2.imwrite(str(base / "img.png"), _gradient_frames(1, 40, 56, 41)[0])
    meta = base / "meta.json"
    _metadata(meta, [{"group_id": "g", "prompt": "waves", "image_path": "img.png",
                      "videos": [{"video_path": "v.mp4", "generation_id": 2}]}])
    tencode_wan.main(["--metadata", str(meta), "--base_dir", str(base), "--model_path",
                      str(ckpt), "--num_frames", "9", "--height", "32", "--width", "48"],
                     cfg=CFG, t5_cfg=T5_CFG, device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("Done.")

    jt5_cfg = jt5.T5Config(**dataclasses.asdict(T5_CFG))
    jt5_params = jt5.convert_t5_encoder(
        tloader._to_f32(tloader.load_safetensors_dir(str(ckpt / "text_encoder"))), jt5_cfg)
    vparams = jconvert.convert_wan_vae(sd, JCFG, latents_mean=stats["latents_mean"],
                                       latents_std=stats["latents_std"])
    cond = np.load(base / "dpo_latents" / "condition_g.npz")
    t = FakeTokenizer()("waves", max_length=CFG.text_len)
    want = np.asarray(_j_t5_encode(jt5_params, jnp.asarray(t["input_ids"]),
                                   jnp.asarray(t["attention_mask"]), jt5_cfg))[0]
    assert cond["encoder_hidden_states"].shape == (CFG.text_len, CFG.text_dim)
    np.testing.assert_allclose(cond["encoder_hidden_states"], want, atol=1e-4, rtol=0)
    img = cv2.resize(cv2.cvtColor(cv2.imread(str(base / "img.png")), cv2.COLOR_BGR2RGB),
                     (48, 32), interpolation=cv2.INTER_AREA)
    want = np.asarray(_j_wan_vae_encode(vparams, jnp.asarray(
        img.astype(np.float32).transpose(2, 0, 1)[None, :, None] / 127.5 - 1.0), JCFG))[0]
    assert cond["image_latent"].shape == (CFG.vae_z_dim, 1, 2, 3)
    np.testing.assert_allclose(cond["image_latent"], want, atol=1e-4, rtol=0)
    frames = np.stack([cv2.resize(f, (48, 32), interpolation=cv2.INTER_AREA)
                       for f in j_read_video_frames(str(base / "v.mp4"), np.arange(9))])
    want = np.asarray(_j_wan_vae_encode(vparams, jnp.asarray(
        frames.astype(np.float32).transpose(3, 0, 1, 2)[None] / 127.5 - 1.0), JCFG))[0]
    got = np.load(base / "dpo_latents" / "latent_g_2.npz")["data"]
    assert got.shape == (CFG.vae_z_dim, 3, 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
