"""DPO LoRA training loops for the CogVideoX and Wan2.2 recipes
(``videogpa_tpu/cli/train_dpo.py``).

The reference's ``train/CogVideoX*/03_train.py`` loop: a 98/2 train/val split
of the preference pairs (seed 42), shuffled drop-last epochs, a train step
per batch, validation and top-k checkpointing by validation loss every
``checkpoint_every_n_steps``, automatic resume from the newest checkpoint,
and a PEFT export of the LoRA at the end.

    python -m videogpa_torch.cli.train_dpo CogVideoX-5B --base_path /data/set

Runs on the card unless the caller passes ``device="cpu"``. ``train_dpo``
trains a CogVideoX DiT, ``train_wan_dpo`` the Wan2.2-TI2V-5B DiT; both go
through one loop (``_fit``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from videogpa_torch.checkpoint import TrainCheckpointer
from videogpa_torch.device import resolve_device
from videogpa_torch.models.loader import load_cogvideox, load_wan
from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.train.dataset import DPODataset, collate, train_val_split
from videogpa_torch.train.lora import export_peft, lora_init
from videogpa_torch.train.trainer import (
    TrainerConfig, TrainState, init_train_state, make_dpo_train_step)
from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step
from videogpa_torch.utils.logging import MetricLogger


def _peak_memory_gb() -> float:
    """Peak device memory of this process in GB (the reference logs
    stats/max_memory_gb from torch.cuda); 0.0 without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def _tcfg(config: dict) -> TrainerConfig:
    return TrainerConfig(
        learning_rate=config.get("learning_rate", 5e-6),
        beta=config.get("beta", 1.0),
        warmup_steps=config.get("warmup_steps", 500),
        max_steps=config.get("max_steps", 10_000),
        gradient_clip_val=config.get("gradient_clip_val", 1.0),
        accumulate_grad_batches=config.get("accumulate_grad_batches", 1),
        lora_rank=config.get("lora_rank", 64),
        lora_alpha=config.get("lora_alpha", 128.0),
    )


def _fit(config: dict, tcfg: TrainerConfig, state: TrainState, train_step, eval_step,
         generator: torch.Generator, seed: int, device, **peft_layout) -> None:
    """The loop both recipes share: the 98/2 split, shuffled drop-last
    epochs, a train step per batch, validation on up to 50 pairs and top-k
    checkpointing every ``checkpoint_every_n_steps`` and at the last step,
    resume from the newest checkpoint, and the PEFT export (``peft_layout``:
    ``export_peft``'s naming arguments)."""
    ds = DPODataset(
        base_path=config["base_path"],
        metadata_path=config["metadata_path"],
        metric_name=config.get("metric_name", "consistency_score"),
        metric_mode=config.get("metric_mode", "min"),
        min_gap=config.get("min_gap", 0.05),
        metric_threshold=config.get("metric_threshold"),
        motion_threshold=config.get("motion_threshold", 0.001),
    )
    train_idx, val_idx = train_val_split(len(ds), 0.02, seed=42)
    print(f"pairs: {len(ds)} (train {len(train_idx)}, val {len(val_idx)})")

    out_dir = config["output_dir"]
    ckpt = TrainCheckpointer(os.path.join(out_dir, "checkpoints"),
                             save_top_k=config.get("save_top_k", 10))
    logger = MetricLogger(out_dir, project=config.get("wandb_project"),
                          name=config.get("experiment_name"), config=config)

    batch_size = config.get("batch_size", 2)
    rng = np.random.default_rng(seed)
    step = 0
    log_every = config.get("log_every_n_steps", 10)
    ckpt_every = config.get("checkpoint_every_n_steps", 1000)

    latest = ckpt.latest() if config.get("resume", True) else None
    if latest is not None:
        state = ckpt.restore(latest, state, device=device)
        step = int(state.step)
        print(f"resumed from {latest} at step {step}")
    # samples/sec counts the steps of this process, not the resumed ones
    step0 = step

    def make_batch(indices):
        b = collate([ds[int(i)] for i in indices])
        return {k: v for k, v in b.items() if k != "prompt"}

    if len(train_idx) < batch_size:
        # drop-last batching would yield no batch and the loop would spin
        raise ValueError(
            f"batch_size={batch_size} exceeds the {len(train_idx)}-pair "
            f"training set; drop-last batching would never yield a batch")

    while step < tcfg.max_steps:
        order = rng.permutation(train_idx)
        # drop-last batching: shuffled epochs cover every pair anyway
        for i in range(0, len(order) - batch_size + 1, batch_size):
            state, metrics = train_step(state, make_batch(order[i:i + batch_size]), generator)
            step += 1
            if step % log_every == 0:
                m = {f"train/{k}": float(v) for k, v in metrics.items()}
                m["stats/samples_per_sec"] = logger.throughput(step - step0, batch_size)
                m["stats/max_memory_gb"] = _peak_memory_gb()
                logger.log(step, m)
                print(f"step {step}: loss={m['train/loss']:.4f} "
                      f"margin={m['train/reward_margin']:.4f}")
            if step % ckpt_every == 0 or step >= tcfg.max_steps:
                val_losses = [float(eval_step(state, make_batch(val_idx[j:j + 1]),
                                              generator)["loss"])
                              for j in range(min(len(val_idx), 50))]
                val_loss = float(np.mean(val_losses)) if val_losses else float("inf")
                logger.log(step, {"val/loss": val_loss})
                ckpt.save(step, state, metric=val_loss)
            if step >= tcfg.max_steps:
                break

    export_peft(state.lora, os.path.join(out_dir, "final_lora"), rank=tcfg.lora_rank,
                alpha=tcfg.lora_alpha, **peft_layout)
    logger.close()
    print(f"final LoRA exported to {os.path.join(out_dir, 'final_lora')}")


def train_dpo(config: dict, cog_cfg, i2v: bool = False, device=None) -> None:
    """Train the CogVideoX DPO LoRA of ``config`` (a ``train.recipes`` config)
    on ``cog_cfg``'s DiT. Draws (the LoRA's A, each step's timesteps and
    noise) come from one ``torch.Generator`` seeded by ``config["seed"]``;
    the epoch order from numpy's ``default_rng(seed)``, the JAX package's
    permutation."""
    device = resolve_device(device)
    dit, vae = load_cogvideox(config["model_path"], cog_cfg, dtype=torch.bfloat16,
                              device=device)
    tcfg = _tcfg(config)
    seed = config.get("seed", 0)
    generator = torch.Generator(device=device).manual_seed(seed)
    lora = lora_init(cog_cfg.num_layers, cog_cfg.hidden_dim, rank=tcfg.lora_rank,
                     generator=generator, device=device)
    state = init_train_state(lora, tcfg)
    train_step, eval_step = make_dpo_train_step(dit, cog_cfg, tcfg, vae=vae if i2v else None)
    _fit(config, tcfg, state, train_step, eval_step, generator, seed, device)


def train_wan_dpo(config: dict, cfg: Optional[WanConfig] = None, device=None) -> None:
    """Wan2.2-TI2V-5B DPO: flow-matching loss with per-token timesteps
    (``videogpa_tpu/cli/train_dpo.py::train_wan_dpo``). The DiT comes from
    the ``WanModel`` safetensors at the root of ``config["model_path"]`` in
    bf16 (``load_wan``); ``cfg`` (default ``WanConfig.ti2v_5b()``, which
    the JAX trainer hard-codes) sizes it. Draws come from one generator
    seeded with 0, the epoch order from ``default_rng(0)``, as the JAX
    trainer's key and rng; the adapter exports in the Wan layout
    (``blocks.{i}.attn1.*`` of ``wan.modules.model.WanModel``)."""
    device = resolve_device(device)
    cfg = cfg or WanConfig.ti2v_5b()
    model = load_wan(config["model_path"], cfg, dtype=torch.bfloat16, device=device)
    tcfg = _tcfg(config)
    generator = torch.Generator(device=device).manual_seed(0)
    lora = lora_init(cfg.num_layers, cfg.dim, rank=tcfg.lora_rank, generator=generator,
                     device=device)
    state = init_train_state(lora, tcfg)
    train_step, eval_step = make_wan_dpo_train_step(model, cfg, tcfg)
    _fit({"batch_size": 1, **config}, tcfg, state, train_step, eval_step, generator, 0,
         device, base_model_class="WanModel",
         parent_library="wan.modules.model", block_prefix="blocks")


def main(argv=None) -> None:
    """``videogpa-torch-train-dpo <recipe> [--config cfg.yaml] [--base_path dir]``"""
    from videogpa_torch.train.recipes import RECIPES, build_config, run_recipe

    parser = argparse.ArgumentParser(
        prog="videogpa-torch-train-dpo",
        description="DPO LoRA training at one of the reference operating points "
                    "(videogpa_torch/train/recipes.py)")
    parser.add_argument("recipe", choices=RECIPES)
    parser.add_argument("--config", type=str, default=None,
                        help="YAML with overrides under key 'training'")
    parser.add_argument("--base_path", type=str, default=None)
    args = parser.parse_args(argv)
    run_recipe(args.recipe, build_config(args.recipe, args.config, args.base_path))


if __name__ == "__main__":
    main()
