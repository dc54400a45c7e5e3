"""Generation of the replicate flow over DL3DV first frames (the root
``replicate.py``): CogVideoX-5B-I2V from each scene's first frame.

Configured by ``RUN_*``, ``PROMPT_JSON`` and ``DL3DV_BASE_DIR``
(``build_config``) or by a dict passed to ``main``. Captions are keyed
``<subset>/<hash>/images_8``; each scene's ``images_8/frame_00001.png`` is
found under ``<base>/<subset>/<hash>`` or ``<base>/<hash>``, resized to
720 x 480 by OpenCV's INTER_AREA; each (LoRA weight w, seed) writes
``<output_dir>/<hash>/seed_{s}_{mode}_w{w}.mp4`` with the LoRA scaled by
w * alpha / r at load time; videos that exist are skipped.

    RUN_MODE=dpo RUN_LORA_PATH=... python -m videogpa_torch.cli.replicate

The generator runs on the card unless ``main(device="cpu")``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Mapping, Optional

import numpy as np

from videogpa_torch.cli import generate
from videogpa_torch.data import video_io

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _int_list(raw: Optional[str], default) -> list:
    if raw is None:
        return list(default)
    return [int(x) for x in raw.split(",") if x.strip()]


def build_config(env: Optional[Mapping[str, str]] = None) -> dict:
    """The generation configuration from ``env`` (default ``os.environ``)."""
    env = os.environ if env is None else env
    return {
        "mode": env.get("RUN_MODE", "dpo"),
        "weight_list": [float(x) for x in env.get("RUN_WEIGHTS", "1.0").split(",")],
        "base_model": env.get("RUN_BASE_MODEL", "THUDM/CogVideoX-5B-I2V"),
        "lora_path": env.get("RUN_LORA_PATH",
                             os.path.join(_ROOT, "checkpoints/VideoGPA-I2V-lora")),
        "prompt_json": env.get("PROMPT_JSON",
                               os.path.join(_ROOT, "dl3dv_video_captions/captions_1K.json")),
        "dl3dv_base_dir": env.get("DL3DV_BASE_DIR", "/datasets/DL3DV-10K"),
        "output_dir": env.get("RUN_OUTPUT_DIR", os.path.join(_ROOT, "output/replicate")),
        "num_prompts": int(env.get("RUN_NUM_PROMPTS", "100")),
        "seeds_per_prompt": _int_list(env.get("RUN_SEEDS"), [456]),
        "num_inference_steps": 50,
        "guidance_scale": 6.0,
        "fps": 8,
    }


def extract_pure_hash(json_key: str) -> str:
    parts = json_key.split("/")
    return parts[1] if len(parts) >= 2 else json_key


def find_dl3dv_first_frame(base_dir: str, scene_hash: str) -> Optional[str]:
    for sub in sorted(os.listdir(base_dir)) if os.path.isdir(base_dir) else []:
        cand = os.path.join(base_dir, sub, scene_hash, "images_8", "frame_00001.png")
        if os.path.exists(cand):
            return cand
        cand = os.path.join(base_dir, scene_hash, "images_8", "frame_00001.png")
        if os.path.exists(cand):
            return cand
    return None


def read_first_frame(path: str, width: int = 720, height: int = 480) -> np.ndarray:
    """An image file -> (height, width, 3) RGB uint8 by OpenCV's INTER_AREA."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)


def main(config: Optional[dict] = None, cfg=None, device=None) -> list:
    """Generate every (weight, prompt, seed) of ``config`` (default
    ``build_config()``) with ``cfg`` (default CogVideoX-5B-I2V); returns the
    paths written. A failing video is reported and the run goes on."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig

    config = build_config() if config is None else config
    cfg = cfg or CogVideoXConfig.cogvideox_5b_i2v()
    with open(config["prompt_json"], encoding="utf-8") as f:
        captions = json.load(f)
    items = list(captions.items())[:config["num_prompts"]]
    print(f"{len(items)} prompts, seeds={config['seeds_per_prompt']}, mode={config['mode']}")
    args = argparse.Namespace(
        base_model=config["base_model"],
        lora_path=config["lora_path"] if config["mode"] != "original" else None,
        num_inference_steps=config["num_inference_steps"],
        guidance_scale=config["guidance_scale"])
    written = []
    for w in config["weight_list"]:
        gen = generate.CogVideoXGenerator(args, cfg, i2v=True, lora_weight=w, device=device)
        for key, caption in items:
            scene = extract_pure_hash(key)
            out_dir = os.path.join(config["output_dir"], scene)
            os.makedirs(out_dir, exist_ok=True)
            frame = find_dl3dv_first_frame(config["dl3dv_base_dir"], scene)
            if frame is None:
                print(f"missing first frame for {scene}")
                continue
            img = read_first_frame(frame)
            prompt = caption if isinstance(caption, str) else caption.get("caption", "")
            for seed in config["seeds_per_prompt"]:
                out_path = os.path.join(out_dir, f"seed_{seed}_{config['mode']}_w{w}.mp4")
                if os.path.exists(out_path):
                    continue
                try:
                    frames = gen.generate_one(prompt, seed, image=img)
                    video_io.write_video(out_path, frames, fps=config["fps"])
                    written.append(out_path)
                    print(f"wrote {out_path}")
                except Exception as e:  # per-video isolation (the reference's behaviour)
                    print(f"failed {scene} seed {seed}: {e}")
    print("Done.")
    return written


def cli() -> None:
    """``videogpa-torch-replicate``: ``main`` configured by the environment
    (a console script's exit status is its return value: None)."""
    main()


if __name__ == "__main__":
    cli()
