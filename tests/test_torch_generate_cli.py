"""The port's generate CLI on the CPU at tiny sizes (``tests/test_cli.py``'s
``TestPromptLoading`` and ``TestGenerationEndToEnd``, which the JAX package
keeps out of tier 1 for its compile time): prompt loading, ``run_generation``
writing mp4s and skipping them on resume, per-prompt isolation, and the real
``CogVideoXGenerator`` loading a tiny diffusers-layout checkpoint directory
with a stubbed tokenizer, merging LoRA before ``--w8a8`` quantises."""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from videogpa_tpu.cli.generate import load_tasks as j_load_tasks
from videogpa_torch.cli import generate as G
from videogpa_torch.models.cogvideox import (
    CogVideoXConfig, SamplerSettings, dit_init, sample_t2v, vae_init, video_to_uint8)
from videogpa_torch.models.t5 import T5Config, t5_encode, t5_encoder_init
from videogpa_torch.ops.quant import QuantLinear
from videogpa_torch.train.lora import export_peft, lora_init
from videogpa_torch.utils.safetensors_np import save_file
from test_cogvideox_parity import OracleDiT
from test_cogvideox_vae_parity import OracleVAE

torch.set_num_threads(2)


def test_dict_and_list_formats(tmp_path):
    p1 = tmp_path / "d.json"
    p1.write_text(json.dumps({"a": "prompt A", "b": {"text_prompt": "B", "image_path": "x.png"}}))
    tasks = G.load_tasks(str(p1), None)
    assert tasks == j_load_tasks(str(p1), None)
    assert tasks[0]["group_id"] == "a" and tasks[0]["text_prompt"] == "prompt A"
    assert tasks[1]["image_path"] == "x.png"
    p2 = tmp_path / "l.json"
    p2.write_text(json.dumps([{"group_id": "g", "prompt": "P"}]))
    assert G.load_tasks(str(p2), 5) == j_load_tasks(str(p2), 5) == [{"group_id": "g",
                                                                      "prompt": "P"}]
    p3 = tmp_path / "s.json"
    p3.write_text(json.dumps("just a string"))
    with pytest.raises(ValueError, match="Unsupported"):
        G.load_tasks(str(p3), None)


def test_num_prompts_limit(tmp_path):
    p = tmp_path / "p.json"
    p.write_text(json.dumps({f"k{i}": f"prompt {i}" for i in range(10)}))
    assert len(G.load_tasks(str(p), 3)) == 3
    assert [t["group_id"] for t in G.load_tasks(str(p), 3)] == ["k0", "k1", "k2"]
    assert len(G.load_tasks(str(p), None)) == 10


class FakeTokenizer:
    def __call__(self, text, **kw):
        L = kw.get("max_length", 8)
        ids = np.full((1, L), 1 + len(text) % 7, np.int64)
        return {"input_ids": ids, "attention_mask": np.ones((1, L), np.int64)}


def _tiny_generator_cls(cfg):
    class TinyGenerator:
        def __init__(self, args, cfg_model, i2v=False, dynamic_cfg=False,
                     lora_weight=None, absolute_lora=False, device=None):
            gen = torch.Generator().manual_seed(0)
            self.cfg, self.args = cfg_model, args
            self.settings = SamplerSettings(num_inference_steps=args.num_inference_steps,
                                            guidance_scale=args.guidance_scale)
            self.dit = dit_init(cfg_model, gen, device="cpu")
            self.vae = vae_init(cfg_model, gen, device="cpu")
            t5_cfg = dataclasses.replace(T5Config.tiny(), d_model=cfg_model.text_embed_dim)
            self.t5 = t5_encoder_init(t5_cfg, gen, device="cpu")

        def generate_one(self, prompt, seed, image=None, num_frames=5, height=32, width=48):
            if prompt == "boom":
                raise RuntimeError("a failing prompt")
            ids = FakeTokenizer()(prompt, max_length=self.cfg.max_text_seq_length)["input_ids"]
            emb = t5_encode(self.t5, torch.from_numpy(ids))
            video = sample_t2v(self.dit, self.vae, emb, torch.zeros_like(emb), self.cfg,
                               num_frames=num_frames, height=height, width=width,
                               settings=self.settings,
                               generator=torch.Generator().manual_seed(seed),
                               compute_dtype=torch.float32)
            return video_to_uint8(video)[0]

    return TinyGenerator


def _args(tmp_path, prompts, **kw):
    p = tmp_path / "prompts.json"
    p.write_text(json.dumps(prompts))
    base = dict(base_model="tiny", prompt_json=str(p), output_dir=str(tmp_path / "out"),
                lora_path=None, gpu_id=0, seed=7, num_prompts=None, num_inference_steps=2,
                guidance_scale=6.0, fps=8, attn_impl="auto", w8a8=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_run_generation_writes_video_and_resumes(tmp_path, monkeypatch, capsys):
    cfg = CogVideoXConfig.tiny()
    monkeypatch.setattr(G, "CogVideoXGenerator", _tiny_generator_cls(cfg))
    args = _args(tmp_path, {"scene1": "a cat", "scene2": "a dog", "bad": "boom", "empty": ""})
    G.run_generation(args, cfg, i2v=False, num_frames=5, height=32, width=48)
    for scene in ("scene1", "scene2"):
        p = tmp_path / "out" / scene / "seed_7.mp4"
        assert p.exists() and p.stat().st_size > 0, p
    assert not (tmp_path / "out" / "bad" / "seed_7.mp4").exists()
    out = capsys.readouterr().out
    assert "Failed: a failing prompt" in out and out.rstrip().endswith("Done.")
    sizes = {s: (tmp_path / "out" / s / "seed_7.mp4").stat().st_mtime_ns
             for s in ("scene1", "scene2")}
    G.run_generation(args, cfg, i2v=False, num_frames=5, height=32, width=48)
    assert "Skip existing: scene1" in capsys.readouterr().out
    assert sizes == {s: (tmp_path / "out" / s / "seed_7.mp4").stat().st_mtime_ns
                     for s in ("scene1", "scene2")}


def _checkpoint_dir(root, cfg, t5_cfg):
    """A tiny diffusers-layout checkpoint: bf16 DiT, f32 VAE and T5."""
    torch.manual_seed(0)
    (root / "transformer").mkdir(parents=True)
    safetensors.torch.save_file(
        {k: v.to(torch.bfloat16).contiguous() for k, v in OracleDiT(cfg).state_dict().items()},
        str(root / "transformer" / "diffusion_pytorch_model.safetensors"))
    (root / "vae").mkdir()
    save_file({k: v.numpy() for k, v in OracleVAE(cfg).state_dict().items()},
              str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=t5_cfg.vocab_size, d_model=t5_cfg.d_model, d_kv=t5_cfg.d_kv,
        d_ff=t5_cfg.d_ff, num_layers=t5_cfg.num_layers, num_heads=t5_cfg.num_heads,
        feed_forward_proj="gated-gelu"))
    (root / "text_encoder").mkdir()
    save_file({k: v.numpy() for k, v in hf.state_dict().items()},
              str(root / "text_encoder" / "model.safetensors"))
    (root / "tokenizer").mkdir()


def test_generator_loads_a_checkpoint_merges_lora_then_quantises(tmp_path, monkeypatch):
    cfg = CogVideoXConfig.tiny()
    _checkpoint_dir(tmp_path / "ckpt", cfg, T5Config.tiny())
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, 4, torch.Generator().manual_seed(1),
                     device="cpu")
    for ab in lora.values():
        ab["lora_B"].data.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    export_peft(lora, str(tmp_path / "lora"), rank=4, alpha=8.0)
    seen = []
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda path: seen.append(path) or FakeTokenizer())
    import videogpa_torch.models.loader as tloader
    import videogpa_torch.ops.quant as quant
    import videogpa_torch.train.lora as tlora

    # the checkpoint's encoder is T5Config.tiny(), not the XXL default
    real_load_t5 = tloader.load_t5
    monkeypatch.setattr(tloader, "load_t5", lambda path, **kw: real_load_t5(
        path, cfg=T5Config.tiny(), **kw))

    order = []
    for mod, name in ((tlora, "merge_lora"), (quant, "quantize_dit_int8")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _n=name, **k:
                            order.append(_n) or _real(*a, **k))
    args = _args(tmp_path, {"a": "a cat"}, base_model=str(tmp_path / "ckpt"),
                 lora_path=str(tmp_path / "lora"), w8a8=True)
    gen = G.CogVideoXGenerator(args, cfg, device="cpu")
    assert order == ["merge_lora", "quantize_dit_int8"]
    assert seen == [str(tmp_path / "ckpt" / "tokenizer")]
    assert gen.attn_impl == "flash_int8"
    assert isinstance(gen.dit.blocks[0].attn1.to_q, QuantLinear)
    assert next(gen.vae.parameters()).dtype == torch.bfloat16
    assert next(gen.t5.parameters()).dtype == torch.float32
    text, neg = gen.encode_prompt("a cat")
    assert text.shape == (1, cfg.max_text_seq_length, 32) and not torch.equal(text, neg)
