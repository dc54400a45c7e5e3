"""Shared CogVideoX generation entry point (``videogpa_tpu/cli/generate.py``).

CLI surface of the reference ``generate/CogVideoX-5B.py`` /
``CogVideoX-5B-I2V.py`` / ``CogVideoX1.5-5B.py``, one entry picked by
``--recipe``: the same flags, prompt-JSON
formats, skip-existing resume, per-prompt error isolation and seed naming.

    python -m videogpa_torch.cli.generate --recipe CogVideoX-5B-I2V \
        --prompt_json P --output_dir O [--base_dir D]

``--gpu_id`` is accepted for CLI compatibility; the process runs on the
current CUDA device (choose it with ``CUDA_VISIBLE_DEVICES``). LoRA mounting
honours the three reference scaling conventions (PEFT merge, CogVideoX1.5
absolute override, relative weight). Weights come from a local
diffusers-layout directory (``models.loader``), the tokenizer from its
``tokenizer/`` folder.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def add_common_args(parser: argparse.ArgumentParser, base_model: str):
    parser.add_argument("--base_model", type=str, default=base_model)
    parser.add_argument("--prompt_json", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--lora_path", type=str, default=None)
    parser.add_argument("--gpu_id", type=int, default=0)  # accepted, unused
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_prompts", type=int, default=None)
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--guidance_scale", type=float, default=6.0)
    parser.add_argument("--fps", type=int, default=8)
    parser.add_argument(
        "--attn_impl", type=str, default="auto", choices=["auto", "flash", "flash_int8"],
        help="attention kernel; flash_int8 = int8-QK production-inference mode",
    )
    parser.add_argument(
        "--w8a8", action="store_true",
        help="quantize the DiT projection/FFN weights to int8 and run dynamic "
             "per-token W8A8 GEMMs (inference only; ops/quant.py)",
    )
    return parser


def load_tasks(prompt_json: str, num_prompts: Optional[int]):
    with open(prompt_json, encoding="utf-8") as f:
        raw = json.load(f)
    if isinstance(raw, dict):
        tasks = [
            {
                "group_id": k,
                "text_prompt": v if isinstance(v, str)
                else v.get("text_prompt", v.get("prompt", "")),
                **({} if isinstance(v, str) else v),
            }
            for k, v in raw.items()
        ]
    elif isinstance(raw, list):
        tasks = raw
    else:
        raise ValueError("Unsupported prompt JSON format")
    return tasks[:num_prompts] if num_prompts else tasks


def load_models(base_model: str, cfg, device):
    """The generator's models from a local diffusers-layout directory: (DiT
    and VAE in bf16, T5 in f32 and its config, the tokenizer)."""
    from transformers import AutoTokenizer

    from videogpa_torch.models.loader import load_cogvideox, load_t5, resolve_model_dir

    dit, vae = load_cogvideox(base_model, cfg, dtype=torch.bfloat16, device=device)
    t5, t5_cfg = load_t5(base_model, device=device)
    tokenizer = AutoTokenizer.from_pretrained(resolve_model_dir(base_model, "tokenizer"))
    return dit, vae, t5, t5_cfg, tokenizer


class CogVideoXGenerator:
    """Holds the models ``load_models`` gives, with the recipe's LoRA merged
    (and int8 weights under ``--w8a8``), and samples one video a call."""

    def __init__(self, args, cfg, i2v: bool = False, dynamic_cfg: bool = False,
                 lora_weight: Optional[float] = None, absolute_lora: bool = False,
                 device=None):
        from videogpa_torch.device import resolve_device
        from videogpa_torch.models.cogvideox.pipeline import SamplerSettings

        self.cfg = cfg
        self.i2v = i2v
        self.args = args
        self.device = resolve_device(device)
        self.settings = SamplerSettings(
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            use_dynamic_cfg=dynamic_cfg,
        )
        self.attn_impl = getattr(args, "attn_impl", "auto")
        (self.dit, self.vae, self.t5, self.t5_cfg,
         self.tokenizer) = load_models(args.base_model, cfg, self.device)
        if args.lora_path and os.path.exists(args.lora_path):
            from videogpa_torch.train.lora import import_peft, merge_lora

            with open(os.path.join(args.lora_path, "adapter_config.json")) as f:
                acfg = json.load(f)
            lora = import_peft(args.lora_path, cfg.num_layers, device=self.device)
            merge_lora(
                self.dit, lora, acfg["r"], acfg["lora_alpha"],
                weight=lora_weight if (lora_weight is not None and not absolute_lora) else 1.0,
                absolute_scaling=lora_weight if absolute_lora else None,
            )
            print(f"LoRA merged from {args.lora_path}")
        elif args.lora_path:
            print(f"LoRA path not found: {args.lora_path}, using base model")
        if getattr(args, "w8a8", False):
            # after any LoRA merge, so the adapter quantizes with the base
            from videogpa_torch.ops.quant import quantize_dit_int8

            quantize_dit_int8(self.dit)
            # --w8a8 alone is the full production int8 mode (W8A8 GEMMs +
            # int8-QK attention); --attn_impl overrides
            if self.attn_impl == "auto":
                self.attn_impl = "flash_int8"
            print("DiT projection/FFN weights quantized to int8 (W8A8); "
                  f"attention impl: {self.attn_impl}")

    def encode_prompt(self, prompt: str):
        from videogpa_torch.models.t5.encoder import t5_encode

        def enc(text):
            toks = self.tokenizer(
                text, padding="max_length", truncation=True,
                max_length=self.cfg.max_text_seq_length, return_tensors="np",
            )
            with torch.no_grad():
                return t5_encode(self.t5, torch.from_numpy(np.asarray(toks["input_ids"])))

        return enc(prompt), enc("")

    def generate_one(self, prompt: str, seed: int, image: Optional[np.ndarray] = None,
                     num_frames: int = 49, height: int = 480, width: int = 720) -> np.ndarray:
        from videogpa_torch.models.cogvideox.pipeline import (
            sample_i2v, sample_t2v, video_to_uint8,
        )

        text_emb, neg_emb = self.encode_prompt(prompt)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.i2v:
            img = torch.from_numpy(image.astype(np.float32) / 127.5 - 1.0)
            img = img.permute(2, 0, 1)[None].to(self.device)
            video = sample_i2v(
                self.dit, self.vae, text_emb, neg_emb, img, self.cfg,
                num_frames=num_frames, settings=self.settings, generator=generator,
                attn_impl=self.attn_impl,
            )
        else:
            video = sample_t2v(
                self.dit, self.vae, text_emb, neg_emb, self.cfg,
                num_frames=num_frames, height=height, width=width,
                settings=self.settings, generator=generator, attn_impl=self.attn_impl,
            )
        return video_to_uint8(video)[0]  # (T, H, W, 3)


def run_generation(args, cfg, i2v=False, dynamic_cfg=False,
                   lora_weight=None, absolute_lora=False,
                   num_frames=49, height=480, width=720, base_dir=None, device=None):
    """Sample every prompt of ``args.prompt_json`` to
    ``<output_dir>/<group_id>/seed_<seed>.mp4``, skipping videos that exist.
    A prompt that fails is reported and the run goes on (reference
    behaviour)."""
    from videogpa_torch.data.video_io import write_video

    gen = CogVideoXGenerator(args, cfg, i2v, dynamic_cfg, lora_weight, absolute_lora,
                             device=device)
    tasks = load_tasks(args.prompt_json, args.num_prompts)
    out_root = Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    print(f"Generating {len(tasks)} prompts, seed={args.seed}")

    for idx, item in enumerate(tasks):
        group_id = str(item.get("group_id", idx)).replace("/", "_")
        prompt = item.get("text_prompt", item.get("prompt", "")).strip()
        if not prompt:
            continue
        out_dir = out_root / group_id
        out_dir.mkdir(parents=True, exist_ok=True)
        video_path = out_dir / f"seed_{args.seed}.mp4"
        if video_path.exists():
            print(f"[{idx + 1}/{len(tasks)}] Skip existing: {group_id}")
            continue
        print(f"[{idx + 1}/{len(tasks)}] Generating: {group_id}")
        try:
            image = None
            if i2v:
                image_path = item.get("image_path", item.get("input_image_path"))
                if image_path and base_dir and not os.path.isabs(image_path):
                    image_path = os.path.join(base_dir, image_path)
                if not image_path or not os.path.exists(image_path):
                    print("  missing input image, skipping")
                    continue
                import cv2

                img = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
                image = cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)
            frames = gen.generate_one(prompt, args.seed, image, num_frames, height, width)
            write_video(str(video_path), frames, fps=args.fps)
        except Exception as e:  # per-prompt isolation (reference behaviour)
            print(f"  Failed: {e}")
            traceback.print_exc()
    print("Done.")


# the reference's three wrappers (generate/CogVideoX-5B.py, CogVideoX-5B-I2V.py,
# CogVideoX1.5-5B.py): base model, configuration and operating point
_RECIPES = {
    "CogVideoX-5B": {"base_model": "THUDM/CogVideoX-5B", "config": "cogvideox_5b"},
    "CogVideoX-5B-I2V": {"base_model": "THUDM/CogVideoX-5B-I2V", "config": "cogvideox_5b_i2v",
                         "i2v": True},
    # 81 frames at 768 x 1360, fps 16, dynamic cfg, and --lora_weight as the
    # ABSOLUTE LoRA scaling (default 0.2)
    "CogVideoX1.5-5B": {"base_model": "THUDM/CogVideoX1.5-5B", "config": "cogvideox_1_5_5b",
                        "dynamic_cfg": True, "absolute_lora": True, "fps": 16,
                        "num_frames": 81, "height": 768, "width": 1360},
}


def parse_args(argv=None) -> argparse.Namespace:
    """``--recipe`` (default CogVideoX-5B) and the flags of that recipe's
    reference wrapper, with its defaults."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--recipe", choices=sorted(_RECIPES), default="CogVideoX-5B")
    recipe = _RECIPES[pre.parse_known_args(argv)[0].recipe]
    parser = argparse.ArgumentParser(description="CogVideoX generation")
    parser.add_argument("--recipe", choices=sorted(_RECIPES), default="CogVideoX-5B")
    add_common_args(parser, base_model=recipe["base_model"])
    if recipe.get("i2v"):
        parser.add_argument("--base_dir", type=str, default=None,
                            help="base dir for relative image paths")
    if recipe.get("absolute_lora"):
        parser.add_argument("--lora_weight", type=float, default=0.2,
                            help="absolute LoRA scaling override")
    parser.set_defaults(fps=recipe.get("fps", 8))
    return parser.parse_args(argv)


def main(argv=None, cfg=None, device=None) -> None:
    """``videogpa-torch-generate``: one entry for the three CogVideoX
    generate wrappers, picked by ``--recipe``. ``cfg`` takes another model
    configuration, ``device`` the CPU."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig

    args = parse_args(argv)
    recipe = _RECIPES[args.recipe]
    cfg = cfg or getattr(CogVideoXConfig, recipe["config"])()
    op = {k: recipe.get(k, d) for k, d in (("num_frames", 49), ("height", 480), ("width", 720))}
    run_generation(args, cfg, i2v=recipe.get("i2v", False),
                   dynamic_cfg=recipe.get("dynamic_cfg", False),
                   lora_weight=getattr(args, "lora_weight", None),
                   absolute_lora=recipe.get("absolute_lora", False),
                   base_dir=getattr(args, "base_dir", None), device=device, **op)


if __name__ == "__main__":
    main()
