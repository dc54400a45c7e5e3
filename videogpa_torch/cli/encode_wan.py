"""Encode candidate videos and their conditions to latent artifacts for the
Wan2.2-TI2V-5B recipe (``train/Wan2.2-TI2V-5B/02_encode.py``).

Per group: the umT5 prompt embedding (ids and mask padded to 512) and,
where the group names an input image, that image resized to the video size
and encoded as one frame to ``image_latent`` (the posterior mean), into
``<output_dir>/condition_{gid}.npz``; per candidate video: its first 81
frames at 704 x 1,280 through ``wan_vae_encode(sample=False)`` (the
posterior mean, as ``Wan2_2_VAE.encode`` returns), into
``latent_{gid}_{generation_id}.npz`` (``data``). Resume, metadata rewrite
and per-video isolation are ``cli.encode.encode_groups``'. Without VAE
weights the VAE is random, with a warning (the reference's behaviour).

    python -m videogpa_torch.cli.encode_wan --metadata M --base_dir D

``main(argv, cfg=..., t5_cfg=..., device=...)`` takes other model
configurations and the CPU; ``run`` is ``main`` after loading, callable with
models in memory.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from videogpa_torch.cli.encode import encode_groups, frames_to_video, text_condition


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Encode Wan2.2-TI2V DPO latents")
    parser.add_argument("--metadata", required=True)
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--output_dir", default="dpo_latents")
    parser.add_argument("--model_path", default="Wan-AI/Wan2.2-TI2V-5B")
    parser.add_argument("--num_frames", type=int, default=81)
    parser.add_argument("--height", type=int, default=704)
    parser.add_argument("--width", type=int, default=1280)
    return parser.parse_args(argv)


def video_latent(vae, frames: np.ndarray, cfg) -> np.ndarray:
    """(T, H, W, 3) uint8 frames, T = 4k + 1 -> the (z, T', H/16, W/16) f32
    posterior mean, streamed."""
    from videogpa_torch.models.wan.vae import wan_vae_encode

    lat = wan_vae_encode(vae, frames_to_video(frames, vae.latents_mean.device), cfg)
    return lat[0].float().cpu().numpy()


def image_condition(vae, image: np.ndarray, cfg) -> dict:
    """(H, W, 3) uint8 -> ``{"image_latent": (z, 1, H/16, W/16)}``."""
    return {"image_latent": video_latent(vae, image[None], cfg)}


def main(argv=None, cfg=None, t5_cfg=None, device=None) -> None:
    from transformers import AutoTokenizer

    from videogpa_torch.device import resolve_device
    from videogpa_torch.models.loader import load_t5, load_wan_vae, resolve_model_dir
    from videogpa_torch.models.t5.encoder import T5Config
    from videogpa_torch.models.wan import WanConfig, wan_vae_init

    args = parse_args(argv)
    device = resolve_device(device)
    cfg = cfg or WanConfig.ti2v_5b()
    try:
        vae = load_wan_vae(args.model_path, cfg, device=device)
    except FileNotFoundError as e:
        print(f"WARNING: Wan VAE weights unavailable ({e}); random init")
        vae = wan_vae_init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    t5, _ = load_t5(args.model_path, t5_cfg or T5Config.umt5_xxl(), device=device)
    tokenizer = AutoTokenizer.from_pretrained(resolve_model_dir(args.model_path, "tokenizer"))
    run(args, vae, t5, tokenizer, cfg)


def run(args, vae, t5, tokenizer, cfg) -> None:
    """``main`` after loading: every group of ``args.metadata`` through the
    loaded VAE and umT5 (on their device)."""
    args.text_len = cfg.text_len
    encode_groups(
        args, tokenizer,
        text_fn=lambda ids, mask: text_condition(t5, ids, mask),
        video_fn=lambda gi, frames: video_latent(vae, frames, cfg),
        image_fn=lambda gi, img: image_condition(vae, img, cfg))


if __name__ == "__main__":
    main()
