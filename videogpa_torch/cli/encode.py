"""Encode candidate videos and their conditions to latent artifacts for the
CogVideoX recipes (``train/CogVideoX-I2V-5B/02_encode.py`` and the
``train/CogVideoX-5B`` / ``train/CogVideoX1.5-5B`` wrappers around it).

Per group: the T5 prompt embedding (226 ids) and, where the group names an
input image, the raw first frame resized to the video size in [-1, 1], into
``<output_dir>/condition_{gid}.npz`` (``encoder_hidden_states``,
``image_embeds``); per candidate video: its first ``--num_frames`` frames,
resized, through ``vae_encode(..., sample=True)`` with a generator seeded by
the group's index, into ``latent_{gid}_{generation_id}.npz`` (``data``).
Files that exist are skipped (resume); the metadata JSON is rewritten with
each video's ``latent_path`` and ``condition_path`` after every group.

``--recipe`` picks the defaults the wrappers add: CogVideoX-I2V-5B (the
default), CogVideoX-5B (``--model_path THUDM/CogVideoX-5B``) or
CogVideoX1.5-5B (``--model_path THUDM/CogVideoX1.5-5B --num_frames 81``);
every recipe encodes with the I2V configuration, as the shared script does.

    python -m videogpa_torch.cli.encode --metadata M --base_dir D [--recipe R]

``main(argv, cfg=..., t5_cfg=..., device=...)`` takes other model
configurations and the CPU; ``run`` is ``main`` after loading, callable with
models in memory.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

_RECIPE_DEFAULTS = {
    "CogVideoX-I2V-5B": {"model_path": "THUDM/CogVideoX-5B-I2V", "num_frames": 49},
    "CogVideoX-5B": {"model_path": "THUDM/CogVideoX-5B", "num_frames": 49},
    "CogVideoX1.5-5B": {"model_path": "THUDM/CogVideoX1.5-5B", "num_frames": 81},
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Encode CogVideoX DPO latents")
    parser.add_argument("--metadata", required=True)
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--output_dir", default="dpo_latents")
    parser.add_argument("--recipe", choices=sorted(_RECIPE_DEFAULTS),
                        default="CogVideoX-I2V-5B")
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--num_frames", type=int, default=None)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=720)
    args = parser.parse_args(argv)
    for k, v in _RECIPE_DEFAULTS[args.recipe].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    return args


def resize_frames(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, height, width, 3) by OpenCV's INTER_AREA;
    frames already at that size pass as they are."""
    if frames.shape[1:3] == (height, width):
        return frames
    import cv2

    return np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
                     for f in frames])


def read_image(path: str, height: int, width: int) -> np.ndarray:
    """An image file -> (height, width, 3) RGB uint8."""
    import cv2

    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return resize_frames(img[None], height, width)[0]


def frames_to_video(frames: np.ndarray, device) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (1, 3, T, H, W) f32 in [-1, 1] on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    return (x.permute(3, 0, 1, 2)[None].float() / 127.5 - 1.0)


def text_condition(t5, input_ids: np.ndarray,
                   attention_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(1, L) ids (and mask) -> the (L, d_model) f32 T5 embedding."""
    from videogpa_torch.models.t5.encoder import t5_encode

    mask = None if attention_mask is None else torch.from_numpy(np.asarray(attention_mask))
    with torch.no_grad():
        emb = t5_encode(t5, torch.from_numpy(np.asarray(input_ids)), mask)
    return emb[0].float().cpu().numpy()


def video_latent(vae, frames: np.ndarray, cfg, generator: torch.Generator) -> np.ndarray:
    """(T, H, W, 3) uint8 frames -> the sampled (z, T', H/8, W/8) f32 latent."""
    from videogpa_torch.models.cogvideox.vae import vae_encode

    device = next(vae.parameters()).device
    with torch.no_grad():
        lat = vae_encode(vae, frames_to_video(frames, device), cfg, generator=generator,
                         sample=True)
    return lat[0].float().cpu().numpy()


def encode_groups(args, tokenizer, text_fn, video_fn, image_fn=None) -> None:
    """The loop both encode CLIs share: per group a condition file from
    ``text_fn(ids, mask)`` (and ``image_fn(gi, image)`` where the group has
    an image: a dict of extra arrays), per video a latent from
    ``video_fn(gi, frames)``; cached files skipped, metadata rewritten after
    each group, a video that fails reported and skipped."""
    from videogpa_torch.data import video_io
    from videogpa_torch.utils.json_io import safe_load_json, safe_save_json

    out_root = os.path.join(args.base_dir, args.output_dir)
    os.makedirs(out_root, exist_ok=True)
    data = safe_load_json(args.metadata)
    for gi, group in enumerate(data["groups"]):
        gid = str(group.get("group_id", gi)).replace("/", "_")
        cond_rel = os.path.join(args.output_dir, f"condition_{gid}.npz")
        full_cond = os.path.join(args.base_dir, cond_rel)
        if not os.path.exists(full_cond):
            toks = tokenizer(group.get("text_prompt", group.get("prompt", "")),
                             padding="max_length", truncation=True,
                             max_length=args.text_len, return_tensors="np")
            cond = {"encoder_hidden_states": text_fn(toks["input_ids"],
                                                     toks.get("attention_mask"))}
            image_path = group.get("image_path", group.get("input_image_path"))
            if image_path and image_fn is not None:
                ip = image_path if os.path.isabs(image_path) else os.path.join(args.base_dir,
                                                                               image_path)
                cond.update(image_fn(gi, read_image(ip, args.height, args.width)))
            np.savez(full_cond, **cond)
        for video in group.get("videos", []):
            lat_rel = os.path.join(args.output_dir,
                                   f"latent_{gid}_{video.get('generation_id', 0)}.npz")
            full_lat = os.path.join(args.base_dir, lat_rel)
            video["latent_path"] = lat_rel
            video["condition_path"] = cond_rel
            if os.path.exists(full_lat):
                continue
            try:
                vpath = video["video_path"]
                if not os.path.isabs(vpath):
                    vpath = os.path.join(args.base_dir, vpath)
                frames = video_io.read_video_frames(vpath, np.arange(args.num_frames))
                frames = resize_frames(frames, args.height, args.width)
                np.savez(full_lat, data=video_fn(gi, frames))
            except Exception as e:  # per-video isolation (reference behaviour)
                print(f"  encode failed {video['video_path']}: {e}")
        safe_save_json(data, args.metadata)
        print(f"[{gi + 1}/{len(data['groups'])}] {gid}")
    print("Done.")


def main(argv=None, cfg=None, t5_cfg=None, device=None) -> None:
    from transformers import AutoTokenizer

    from videogpa_torch.device import resolve_device
    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.loader import load_cogvideox_vae, load_t5, resolve_model_dir

    args = parse_args(argv)
    device = resolve_device(device)
    cfg = cfg or CogVideoXConfig.cogvideox_5b_i2v()
    vae = load_cogvideox_vae(args.model_path, cfg, device=device)
    t5, _ = load_t5(args.model_path, t5_cfg, device=device)
    tokenizer = AutoTokenizer.from_pretrained(resolve_model_dir(args.model_path, "tokenizer"))
    run(args, vae, t5, tokenizer, cfg)


def run(args, vae, t5, tokenizer, cfg) -> None:
    """``main`` after loading: every group of ``args.metadata`` through the
    loaded VAE and T5 (on their device)."""
    device = next(vae.parameters()).device
    args.text_len = cfg.max_text_seq_length

    def image_embeds(gi, img):
        return {"image_embeds": img.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0}

    encode_groups(
        args, tokenizer,
        # the reference encodes the prompt without its mask
        text_fn=lambda ids, mask: text_condition(t5, ids),
        video_fn=lambda gi, frames: video_latent(
            vae, frames, cfg, torch.Generator(device=device).manual_seed(gi)),
        image_fn=image_embeds)


if __name__ == "__main__":
    main()
