"""Wan2.2-TI2V-5B text/image-to-video generation (``generate/Wan2.2-TI2V-5B.py``).

The reference CLI's surface: 50 UniPC steps, cfg 5.0, flow shift 5.0, 81
frames at 704 x 1,280, fps 24, ``--solver``, skip-existing resume and
per-prompt error isolation, RELATIVE LoRA scaling (scaling *= lora_weight,
default 0.2) merged through ``import_peft(block_prefix="blocks")`` +
``merge_lora(layout="wan")``, and ``--w8a8`` through ``quantize_wan_int8``
(in place, after the merge). Weights come from a local Wan2.2 checkpoint
directory: the ``WanModel`` safetensors at its root (``load_wan``, kept in
f32 as the JAX script keeps them, run in bf16), the VAE (``load_wan_vae``;
without its weights, a random VAE and a warning, the reference's own
behaviour), umT5-XXL from ``text_encoder/`` and the tokenizer from
``tokenizer/``.

    python -m videogpa_torch.cli.generate_wan --prompt_json P --output_dir O

``--gpu_id`` is accepted for CLI compatibility; the process runs on the
current CUDA device. ``main(argv, cfg=..., t5_cfg=..., device=...)`` takes
other model configurations (the reference hard-codes the 5B ones) and the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Wan2.2-TI2V-5B generation")
    parser.add_argument("--base_model", type=str, default="Wan-AI/Wan2.2-TI2V-5B")
    parser.add_argument("--prompt_json", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--lora_path", type=str, default=None)
    parser.add_argument("--lora_weight", type=float, default=0.2)
    parser.add_argument("--gpu_id", type=int, default=0)  # accepted, unused
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_prompts", type=int, default=None)
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=5.0)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--solver", type=str, default="unipc", choices=["unipc", "euler", "heun"],
                        help="flow solver; unipc matches the reference engine default")
    parser.add_argument("--base_dir", type=str, default=None)
    parser.add_argument("--w8a8", action="store_true",
                        help="int8-quantize the DiT attention/FFN weights; dynamic W8A8 "
                             "GEMMs (inference only; ops/quant.py)")
    parser.add_argument("--num_frames", type=int, default=81)
    parser.add_argument("--height", type=int, default=704)
    parser.add_argument("--width", type=int, default=1280)
    return parser.parse_args(argv)


def main(argv=None, cfg=None, t5_cfg=None, device=None) -> None:
    from transformers import AutoTokenizer

    from videogpa_torch.cli.generate import load_tasks
    from videogpa_torch.data.video_io import write_video
    from videogpa_torch.device import resolve_device
    from videogpa_torch.models.loader import load_t5, load_wan, load_wan_vae, resolve_model_dir
    from videogpa_torch.models.t5.encoder import T5Config, t5_encode
    from videogpa_torch.models.wan import WanConfig, sample_ti2v, wan_vae_init

    args = parse_args(argv)
    device = resolve_device(device)
    cfg = cfg or WanConfig.ti2v_5b()
    t5_cfg = t5_cfg or T5Config.umt5_xxl()
    dit = load_wan(args.base_model, cfg, dtype=torch.float32, device=device)
    try:
        vae = load_wan_vae(args.base_model, cfg, device=device)
    except FileNotFoundError:
        vae = wan_vae_init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
        print("WARNING: Wan VAE weights not found; using random VAE")
    t5, _ = load_t5(args.base_model, t5_cfg, device=device)
    tok = AutoTokenizer.from_pretrained(resolve_model_dir(args.base_model, "tokenizer"))

    if args.lora_path and os.path.exists(args.lora_path):
        from videogpa_torch.train.lora import import_peft, merge_lora

        with open(os.path.join(args.lora_path, "adapter_config.json")) as f:
            acfg = json.load(f)
        lora = import_peft(args.lora_path, cfg.num_layers, block_prefix="blocks", device=device)
        merge_lora(dit, lora, acfg["r"], acfg["lora_alpha"], weight=args.lora_weight,
                   layout="wan")
        print(f"LoRA merged (relative weight {args.lora_weight})")
    if args.w8a8:
        from videogpa_torch.ops.quant import quantize_wan_int8

        quantize_wan_int8(dit)
        print("Wan DiT attention/FFN weights quantized to int8 (W8A8)")

    def encode(text):
        t = tok(text, padding="max_length", truncation=True, max_length=cfg.text_len,
                return_tensors="np")
        return t5_encode(t5, torch.from_numpy(np.asarray(t["input_ids"])),
                         torch.from_numpy(np.asarray(t["attention_mask"])))

    tasks = load_tasks(args.prompt_json, args.num_prompts)
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    for idx, item in enumerate(tasks):
        group_id = str(item.get("group_id", idx)).replace("/", "_")
        prompt = item.get("text_prompt", item.get("prompt", "")).strip()
        if not prompt:
            continue
        out_dir = out_root / group_id
        out_dir.mkdir(parents=True, exist_ok=True)
        video_path = out_dir / f"seed_{args.seed}.mp4"
        if video_path.exists():
            continue
        try:
            image = None
            image_path = item.get("image_path", item.get("input_image_path"))
            if image_path:
                if args.base_dir and not os.path.isabs(image_path):
                    image_path = os.path.join(args.base_dir, image_path)
                import cv2

                img = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
                img = cv2.resize(img, (args.width, args.height), interpolation=cv2.INTER_AREA)
                image = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)
                image = image.permute(2, 0, 1)[None]
            video = sample_ti2v(
                dit, vae, encode(prompt), encode(""), cfg, image=image,
                num_frames=args.num_frames, height=args.height, width=args.width,
                num_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
                solver=args.solver,
                generator=torch.Generator(device=device).manual_seed(args.seed))
            v = video[0].float().cpu().numpy()
            frames = ((v.transpose(1, 2, 3, 0) + 1) * 127.5).clip(0, 255).astype(np.uint8)
            write_video(str(video_path), frames, fps=args.fps)
            print(f"[{idx + 1}/{len(tasks)}] wrote {video_path}")
        except Exception as e:  # per-prompt isolation (reference behaviour)
            print(f"  Failed: {e}")
            traceback.print_exc()
    print("Done.")


if __name__ == "__main__":
    main()
