"""The paper's loop, generate -> score -> train, from files on the port alone
(the shape of ``tests/test_e2e.py::TestClosedLoopDPO``, at tiny size).

Candidate mp4s (a clean pan and a noise-corrupted copy in each group) are
scored by ``cli.score.main`` with the tiny VGGT (``load_vggt``
monkeypatched), win/lose pairs come from the scores (``train.dataset``'s
rule: the least consistency score wins), latents and T5-shaped conditions
are written beside them, ``run_recipe("CogVideoX-5B", ...)`` trains the tiny
DiT's LoRA for 2 steps (``load_cogvideox`` and the recipe's model config
monkeypatched to the tiny ones), and the exported PEFT LoRA re-imports equal
to the trained one. Everything on the CPU; nothing is compared with JAX here
(the legs are, in ``test_torch_score_cli.py`` and ``test_torch_train_cli.py``).
"""

import functools
import json
import os

import cv2
import numpy as np
import torch

import videogpa_torch.cli.train_dpo as tcli
import videogpa_torch.data.video_io as tio
import videogpa_torch.models.loader as tloader
from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
from videogpa_torch.models.vggt import VGGTConfig, vggt_init
from videogpa_torch.train import recipes as trecipes
from videogpa_torch.train.dataset import DPODataset
from videogpa_torch.train.lora import import_peft
from test_torch_score_cli import main_stats

torch.set_num_threads(2)


def _write_candidates(base, groups=3, frames=5, size=56):
    rng = np.random.default_rng(0)
    os.makedirs(base / "videos")
    meta = []
    for g in range(groups):
        bg = cv2.GaussianBlur(rng.uniform(0, 255, (128, 128, 3)).astype(np.uint8), (0, 0), 3)
        clean = np.stack([bg[10 + 2 * t:10 + 2 * t + size, 10 + 3 * t:10 + 3 * t + size]
                          for t in range(frames)])
        noisy = np.clip(clean.astype(np.int16) + np.random.default_rng(300 + g).integers(
            -90, 90, clean.shape), 0, 255).astype(np.uint8)
        videos = []
        for vid, clip in enumerate((clean, noisy)):
            path = f"videos/g{g}_v{vid}.mp4"
            writer = cv2.VideoWriter(str(base / path), cv2.VideoWriter_fourcc(*"mp4v"), 8,
                                     (size, size))
            for f in clip:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            writer.release()
            videos.append({"video_path": path, "generation_id": vid})
        meta.append({"group_id": f"g{g}", "prompt": f"scene {g}", "videos": videos})
    with open(base / "groups.json", "w") as f:
        json.dump({"groups": meta}, f)


def test_generate_score_train_from_files(tmp_path, monkeypatch):
    base = tmp_path
    _write_candidates(base)
    vcfg, ccfg = VGGTConfig.tiny(), CogVideoXConfig.tiny()
    vggt = vggt_init(vcfg, generator=torch.Generator().manual_seed(2), device="cpu")
    # a random camera head can emit fov 0 (NaN pixels): shift the fov bias
    with torch.no_grad():
        vggt.camera_head.pose_branch.fc2.bias[7:9] += 1.0
    monkeypatch.setattr(tloader, "load_vggt", lambda *a, **k: (vggt, vcfg))
    monkeypatch.setattr(tio, "sample_uniform_frames",
                        functools.partial(tio.sample_uniform_frames, size=vcfg.img_size))

    # ---- score: the CLI writes consistency scores into the group JSON ----
    stats = main_stats(monkeypatch, ["--input_json", str(base / "groups.json"),
                                     "--output_json", str(base / "scored.json"), "--base_dir",
                                     str(base), "--num_frames", "4", "--batch_size", "2",
                                     "--device", "cpu"])
    assert stats == {"scored": 6, "failed": 0, "resumed": 0}
    scored = json.load(open(base / "scored.json"))

    # ---- latents + conditions beside the scored candidates ----
    rng = np.random.default_rng(1)
    os.makedirs(base / "lat")
    for g in scored["groups"]:
        cond = f"lat/cond_{g['group_id']}.npz"
        np.savez(base / cond, encoder_hidden_states=rng.standard_normal(
            (ccfg.max_text_seq_length, ccfg.text_embed_dim), dtype=np.float32))
        for v in g["videos"]:
            lat = f"lat/{os.path.basename(v['video_path'])}.npz"
            np.savez(base / lat, data=rng.standard_normal(
                (ccfg.vae_latent_channels, ccfg.sample_frames, ccfg.sample_height,
                 ccfg.sample_width), dtype=np.float32))
            v.update(latent_path=lat, condition_path=cond)
    with open(base / "meta_data.json", "w") as f:
        json.dump(scored, f)

    # ---- pairs from the scores ----
    config = trecipes.build_config("CogVideoX-5B", base_path=str(base))
    config.update(output_dir=str(base / "out"), max_steps=2, batch_size=1,
                  accumulate_grad_batches=1, checkpoint_every_n_steps=2, log_every_n_steps=1, lora_rank=4,
                  lora_alpha=8.0, warmup_steps=1, learning_rate=1e-2, seed=0,
                  metric_threshold=None, min_gap=0.0)
    ds = DPODataset(config["base_path"], config["metadata_path"], min_gap=0.0,
                    metric_threshold=None)
    assert len(ds) == 3
    for pair in ds.preference_pairs:
        assert pair["winner"]["consistency_score"] <= pair["loser"]["consistency_score"]

    # ---- train through the recipe, then export and re-import the LoRA ----
    dit = dit_init(ccfg, generator=torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(tcli, "load_cogvideox", lambda *a, **k: (dit, None))
    monkeypatch.setattr(CogVideoXConfig, "cogvideox_5b", staticmethod(lambda: ccfg))
    monkeypatch.setattr(tcli, "TrainerConfig", functools.partial(
        tcli.TrainerConfig, compute_dtype=torch.float32))
    trecipes.run_recipe("CogVideoX-5B", config, device="cpu")
    recs = [json.loads(line) for line in open(base / "out" / "metrics.jsonl")]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    lora = import_peft(str(base / "out" / "final_lora"), ccfg.num_layers, device="cpu")
    kept = json.load(open(base / "out" / "checkpoints" / "scores.json"))
    state = torch.load(base / "out" / "checkpoints" / sorted(kept)[-1] / "state.pt",
                       weights_only=True)
    assert state["step"] == 2
    for name, ab in state["lora"].items():
        for k, v in ab.items():
            torch.testing.assert_close(lora[name][k], v, atol=0, rtol=0)
    assert any(ab["lora_B"].abs().max() > 0 for ab in lora.values())  # the LoRA moved
