"""The replicate flow on the port, on the CPU at tiny sizes:
``cli/replicate.py`` (CogVideoX-I2V from DL3DV first frames) with a tiny
resident generator and a stub tokenizer, against the root ``replicate.py``'s
file layout; ``cli/replicate_scorer.py`` against the root
``replicate_scorer.py`` on the same mp4s with the tiny DA3 in both packages
(``load_da3`` monkeypatched on both sides, as ``tests/test_cli.py``'s
``test_full_scoring_run`` patches ``load_vggt``), batched with a bad file,
per video and resumed; and the ``--recipe`` generate entry that stands for
the three ``generate/CogVideoX*.py`` wrappers."""

import csv
import dataclasses
import functools
import importlib
import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.data.video_io as jio
import videogpa_tpu.metrics.api as jm_api
import videogpa_tpu.models.loader as jloader
import videogpa_tpu.reward as jreward
import videogpa_tpu.reward.processor as jprocessor
from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import da3_init as j_da3_init
import videogpa_torch.data.video_io as tio
import videogpa_torch.metrics.api as tm_api
import videogpa_torch.reward as treward
from videogpa_torch.cli import generate as G
from videogpa_torch.cli import replicate as trep
from videogpa_torch.cli import replicate_scorer as trs
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.cogvideox import CogVideoXConfig, SamplerSettings, dit_init, vae_init
from videogpa_torch.models.da3 import DA3, DA3Config
from videogpa_torch.models.t5 import T5Config, t5_encoder_init
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
S, SIZE = 4, 56


class FakeTokenizer:
    def __call__(self, text, **kw):
        L = kw.get("max_length", 8)
        ids = np.full((1, L), 1 + len(text) % 7, np.int64)
        return {"input_ids": ids, "attention_mask": np.ones((1, L), np.int64)}


def _resident_generator(cfg, calls):
    """``CogVideoXGenerator`` as a factory of one tiny I2V generator whose
    models are resident (built once, no checkpoint), the tokenizer stubbed;
    its sampler settings come from the args the flow passes, and the real
    ``encode_prompt`` / ``generate_one`` run."""
    g = torch.Generator().manual_seed(0)
    gen = G.CogVideoXGenerator.__new__(G.CogVideoXGenerator)
    gen.cfg, gen.i2v, gen.device, gen.attn_impl = cfg, True, torch.device("cpu"), "auto"
    gen.dit = dit_init(cfg, g, device="cpu")
    gen.vae = vae_init(cfg, g, device="cpu")
    gen.t5 = t5_encoder_init(dataclasses.replace(T5Config.tiny(), d_model=cfg.text_embed_dim),
                             g, device="cpu")
    gen.tokenizer = FakeTokenizer()

    def factory(args, cfg_model, i2v=False, dynamic_cfg=False, lora_weight=None,
                absolute_lora=False, device=None):
        calls.append({"i2v": i2v, "lora_weight": lora_weight, "lora_path": args.lora_path,
                      "steps": args.num_inference_steps, "device": device,
                      "absolute_lora": absolute_lora, "dynamic_cfg": dynamic_cfg})
        gen.args = args
        gen.settings = SamplerSettings(num_inference_steps=args.num_inference_steps,
                                       guidance_scale=args.guidance_scale)
        return gen

    return factory


def _dl3dv(root):
    """A DL3DV layout holding one scene's first frame (a 960 x 540 PNG) and a
    caption JSON naming it, one scene without a frame and one caption dict."""
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.uniform(0, 255, (540, 960, 3)).astype(np.uint8), (0, 0), 5)
    (root / "1K" / "abc123" / "images_8").mkdir(parents=True)
    cv2.imwrite(str(root / "1K" / "abc123" / "images_8" / "frame_00001.png"), img)
    captions = {"1K/abc123/images_8": "a quiet street",
                "1K/nohash/images_8": {"caption": "missing frame"}}
    (root / "captions.json").write_text(json.dumps(captions))
    return root / "captions.json"


def test_replicate_generates_named_videos_and_skips_existing(tmp_path, monkeypatch, capsys):
    cfg = CogVideoXConfig.tiny(i2v=True)
    calls = []
    monkeypatch.setattr(G, "CogVideoXGenerator", _resident_generator(cfg, calls))
    real_read = trep.read_first_frame
    images = []

    def tiny_frame(path, width=720, height=480):
        img = real_read(path, width, height)  # OpenCV INTER_AREA to 720 x 480
        images.append(img.shape)
        return np.ascontiguousarray(img[::15, ::15])  # 32 x 48 for the tiny model

    monkeypatch.setattr(trep, "read_first_frame", tiny_frame)
    env = {"RUN_MODE": "dpo", "RUN_WEIGHTS": "1.0,0.5", "RUN_SEEDS": "7",
           "PROMPT_JSON": str(_dl3dv(tmp_path / "dl3dv")),
           "DL3DV_BASE_DIR": str(tmp_path / "dl3dv"), "RUN_OUTPUT_DIR": str(tmp_path / "out"),
           "RUN_LORA_PATH": str(tmp_path / "no_lora"), "RUN_NUM_PROMPTS": "5"}
    config = trep.build_config(env)
    config["num_inference_steps"] = 2
    written = trep.main(config, cfg=cfg, device="cpu")
    names = sorted(p.relative_to(tmp_path / "out").as_posix()
                   for p in (tmp_path / "out").rglob("*.mp4"))
    assert names == ["abc123/seed_7_dpo_w0.5.mp4", "abc123/seed_7_dpo_w1.0.mp4"]
    assert len(written) == 2 and images == [(480, 720, 3)] * 2
    assert [c["lora_weight"] for c in calls] == [1.0, 0.5]
    assert all(c["i2v"] and c["steps"] == 2 and c["device"] == "cpu" for c in calls)
    assert "missing first frame for nohash" in capsys.readouterr().out
    frames = tio.read_video_frames(str(tmp_path / "out" / names[0]))
    assert frames.shape[1:] == (32, 48, 3) and frames.shape[0] == 49
    # a second run writes nothing: every video exists
    assert trep.main(config, cfg=cfg, device="cpu") == []
    # "original" mode mounts no LoRA
    config["mode"], config["weight_list"] = "original", [1.0]
    trep.main(config, cfg=cfg, device="cpu")
    assert calls[-1]["lora_path"] is None
    assert (tmp_path / "out" / "abc123" / "seed_7_original_w1.0.mp4").exists()

    # the root replicate.py reads the same configuration from the same
    # environment, and names and finds the same files (its generator stubbed:
    # a constant video)
    import replicate as jrep

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    importlib.reload(jrep)
    assert jrep.CONFIG == trep.build_config(env)

    class _Const:
        def __init__(self, *a, **k):
            pass

        def generate_one(self, prompt, seed, image=None):
            assert image.shape == (480, 720, 3)
            return np.zeros((5, 32, 48, 3), np.uint8)

    import videogpa_tpu.cli.generate as jgen

    monkeypatch.setattr(jgen, "CogVideoXGenerator", _Const)
    monkeypatch.setitem(jrep.CONFIG, "output_dir", str(tmp_path / "jax_out"))
    jrep.main()
    jnames = sorted(p.relative_to(tmp_path / "jax_out").as_posix()
                    for p in (tmp_path / "jax_out").rglob("*.mp4"))
    assert jnames == names


def _write_mp4(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             frames.shape[2:0:-1])
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture(scope="module")
def da3_weights():
    tree = random_jax_tree(j_da3_init, JaxDA3Config.tiny())
    tree["cam_dec"]["fc_fov"]["bias"] += 1.0  # a random decoder can emit fov 0
    return tree, load_jax_params(DA3(DA3Config.tiny()), tree).eval()


def _outputs(root):
    """2 prompts x 2 clips named as the replicate flow names them, and a
    file that does not decode."""
    rng = np.random.default_rng(1)
    for pid in ("scene_a", "scene_b"):
        (root / pid).mkdir(parents=True)
        bg = cv2.GaussianBlur(rng.uniform(0, 255, (120, 120, 3)).astype(np.uint8), (0, 0), 2)
        for mode, jitter in (("dpo", 1), ("original", 9)):
            frames = []
            for t in range(S + 2):
                dy, dx = (int(np.clip(t * 3 + rng.integers(-jitter, jitter + 1), 0, 60))
                          for _ in range(2))
                frames.append(bg[dy:dy + 48, dx:dx + 64])
            _write_mp4(root / pid / f"seed_456_{mode}_w1.0.mp4", np.stack(frames))
    # sorts into a chunk with a good clip at score_batch 2: the chunk fails
    # and is scored again clip by clip
    (root / "scene_b" / "seed_456_dpo_w0.5.mp4").write_bytes(b"not a video")


_NUMERIC = ("mse", "consistency_score", "motion_score", "psnr", "ssim", "lpips", "mvcs",
            "epipolar")


@pytest.mark.parametrize("score_batch", [1, 2], ids=["per_video", "batched"])
def test_replicate_scorer_matches_the_root_scorer(da3_weights, tmp_path, monkeypatch,
                                                  score_batch):
    tree, model = da3_weights
    base = tmp_path / "gen"
    _outputs(base)
    # both packages decode at the tiny size, with no LPIPS network (MSE-only
    # consistency score), and score the DA3 in f32
    monkeypatch.setattr(tio, "sample_uniform_frames",
                        functools.partial(tio.sample_uniform_frames, size=SIZE))
    monkeypatch.setattr(jio, "sample_uniform_frames",
                        functools.partial(jio.sample_uniform_frames, size=SIZE))
    # the JAX processor holds its own reference to the decoder
    monkeypatch.setattr(jprocessor, "sample_uniform_frames", jio.sample_uniform_frames)
    monkeypatch.delenv("VIDEOGPA_LPIPS_PATH", raising=False)
    monkeypatch.setattr(jm_api, "_LPIPS_CACHE", {})
    monkeypatch.setattr(tm_api, "_LPIPS_CACHE", {})
    loads = []
    monkeypatch.setattr(jloader, "load_da3", lambda name: (tree, JaxDA3Config.tiny()))
    monkeypatch.setattr(tloader, "load_da3", lambda name, device=None: loads.append(
        (name, device)) or (model, DA3Config.tiny()))
    monkeypatch.setattr(jreward, "VideoProcessor", functools.partial(
        jreward.VideoProcessor, compute_dtype=jnp.float32))
    monkeypatch.setattr(treward, "VideoProcessor", functools.partial(
        treward.VideoProcessor, compute_dtype=torch.float32))

    env = {"SCORE_BASE_DIR": str(base), "SCORE_NUM_FRAMES": str(S),
           "SCORE_BATCH": str(score_batch), "SCORE_SEED_FILTER": "456"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("SCORE_OUTPUT_CSV", str(tmp_path / "jax" / "scores.csv"))
    import replicate_scorer as jrs

    importlib.reload(jrs)
    jrs.main()
    cfg = trs.build_score_config({**env, "SCORE_OUTPUT_CSV": str(tmp_path / "t" / "scores.csv")})
    assert cfg["backbone"] == "da3" and cfg["model_name"] == "depth-anything/DA3-Large"
    assert {k: v for k, v in cfg.items() if k not in ("output_csv",)} == {
        k: v for k, v in jrs.SCORE_CONFIG.items() if k not in ("output_csv",)}
    report = trs.main(cfg, device="cpu")
    assert loads == [("depth-anything/DA3-Large", "cpu")]

    def rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    got, want = rows(tmp_path / "t" / "scores.csv"), rows(tmp_path / "jax" / "scores.csv")
    assert [r["relative_path"] for r in got] == [r["relative_path"] for r in want]
    assert len(got) == 5
    flip = 2.0 / (S * SIZE * SIZE)
    for g, w in zip(got, want):
        assert (g["error"] != "") == (w["error"] != ""), (g, w)
        if w["error"]:
            assert g["video_name"] == "seed_456_dpo_w0.5.mp4"
            continue
        for col in _NUMERIC:
            a, b = float(g[col]), float(w[col])
            if col in ("mse", "consistency_score"):
                tol = flip + 1e-6
            elif col == "psnr":
                tol = 10 * np.log10(1 + flip / max(float(w["mse"]), 1e-12)) + 1e-4
            else:
                tol = {"ssim": 1e-3, "lpips": 1e-4}.get(col, 1e-5 + 1e-4 * abs(b))
            assert np.isfinite(a) and abs(a - b) <= tol, (col, a, b, tol)
    with open(tmp_path / "jax" / "scores.json") as f:
        jreport = json.load(f)
    assert set(report["summary"]) == set(jreport["summary"]) == {"dpo", "original"}
    for mode, s in jreport["summary"].items():
        assert report["summary"][mode]["count"] == s["count"] == 2
        np.testing.assert_allclose(report["summary"][mode]["mean_motion_score"],
                                   s["mean_motion_score"], rtol=1e-4, atol=1e-5)
    # resume: the second run scores nothing new
    resumed = trs.main({**cfg, "resume": True}, device="cpu")
    assert resumed["rows"] == report["rows"]


def test_collect_tasks_filters_and_caps(tmp_path):
    base = tmp_path / "gen"
    for pid in ("p0", "p1"):
        (base / pid).mkdir(parents=True)
        for s in ("1", "2"):
            (base / pid / f"seed_{s}_dpo_w1.0.mp4").write_bytes(b"")
    cfg = trs.build_score_config({"SCORE_BASE_DIR": str(base), "SCORE_SEED_FILTER": "2",
                                  "SCORE_MAX_VIDEOS": "1", "SCORE_BACKBONE": "VGGT"})
    assert cfg["backbone"] == "vggt" and cfg["model_name"] == "facebook/VGGT-1B"
    assert [t["relative_path"] for t in trs.collect_tasks(cfg)] == ["p0/seed_2_dpo_w1.0.mp4"]
    assert trs.infer_mode("seed_1_sft_w1.0.mp4") == "sft"
    assert trs.infer_mode("x_original.mp4") == "original"
    assert trs.infer_mode("x.mp4") == "unknown"


@pytest.mark.parametrize("recipe", ["CogVideoX-5B", "CogVideoX-5B-I2V", "CogVideoX1.5-5B"])
def test_generate_recipe_entry(tmp_path, monkeypatch, recipe):
    """One entry for the three reference wrappers: each recipe's base model,
    configuration, operating point and flags (I2V's --base_dir, 1.5's
    absolute --lora_weight and fps 16)."""
    args = G.parse_args(["--recipe", recipe, "--prompt_json", "p.json", "--output_dir", "o"])
    want = {"CogVideoX-5B": ("THUDM/CogVideoX-5B", 8),
            "CogVideoX-5B-I2V": ("THUDM/CogVideoX-5B-I2V", 8),
            "CogVideoX1.5-5B": ("THUDM/CogVideoX1.5-5B", 16)}[recipe]
    assert (args.base_model, args.fps) == want
    assert hasattr(args, "base_dir") == (recipe == "CogVideoX-5B-I2V")
    assert getattr(args, "lora_weight", None) == (0.2 if recipe == "CogVideoX1.5-5B" else None)

    seen = {}

    def fake_run(args_, cfg, **kw):
        seen.update(kw, cfg=cfg)

    monkeypatch.setattr(G, "run_generation", fake_run)
    G.main(["--recipe", recipe, "--prompt_json", "p.json", "--output_dir", "o"],
           device="cpu")
    full = {"CogVideoX-5B": (CogVideoXConfig.cogvideox_5b(), False, (49, 480, 720)),
            "CogVideoX-5B-I2V": (CogVideoXConfig.cogvideox_5b_i2v(), True, (49, 480, 720)),
            "CogVideoX1.5-5B": (CogVideoXConfig.cogvideox_1_5_5b(), False, (81, 768, 1360))}
    cfg, i2v, (T, H, W) = full[recipe]
    assert seen["cfg"] == cfg and seen["i2v"] == i2v and seen["device"] == "cpu"
    assert (seen["num_frames"], seen["height"], seen["width"]) == (T, H, W)
    assert seen["dynamic_cfg"] == seen["absolute_lora"] == (recipe == "CogVideoX1.5-5B")


def test_generate_i2v_recipe_end_to_end(tmp_path, monkeypatch):
    """``main`` with ``--recipe CogVideoX-5B-I2V`` through ``run_generation``
    and the tiny resident generator: a relative image path under --base_dir."""
    cfg = CogVideoXConfig.tiny(i2v=True)
    calls = []
    monkeypatch.setattr(G, "CogVideoXGenerator", _resident_generator(cfg, calls))
    real_run = G.run_generation
    monkeypatch.setattr(G, "run_generation", lambda *a, **k: real_run(
        *a, **{**k, "num_frames": 9, "height": 32, "width": 48}))  # the tiny model's sizes
    img = np.random.default_rng(2).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "first.png"), img)
    (tmp_path / "p.json").write_text(json.dumps(
        {"g/1": {"text_prompt": "a room", "image_path": "first.png"}}))
    G.main(["--recipe", "CogVideoX-5B-I2V", "--prompt_json", str(tmp_path / "p.json"),
            "--output_dir", str(tmp_path / "out"), "--base_dir", str(tmp_path),
            "--num_inference_steps", "2", "--seed", "3"],
           cfg=cfg, device="cpu")
    out = tmp_path / "out" / "g_1" / "seed_3.mp4"
    assert out.exists() and calls[0]["i2v"] and calls[0]["steps"] == 2
    assert tio.read_video_frames(str(out)).shape == (9, 32, 48, 3)
