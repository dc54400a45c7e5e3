"""DPO training recipes: the four reference operating points as data
(``videogpa_tpu/train/recipes.py``, copied), and ``run_recipe``, which hands
a resolved config to ``cli.train_dpo``.

Each recipe mirrors one reference ``train/<family>/03_train.py`` DEFAULT_CONFIG
(reference ``train/CogVideoX-I2V-5B/03_train.py:39-80`` and siblings):
lr 5e-6, beta 1.0, LoRA r=64 alpha=128, warmup 500, grad clip 1.0, pair
filters min_gap 0.05 / metric_threshold 0.8 / motion_threshold 0.001, with
per-family batch/accum/max_steps differences preserved.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

RECIPES = (
    "CogVideoX-5B",
    "CogVideoX-I2V-5B",
    "CogVideoX1.5-5B",
    "Wan2.2-TI2V-5B",
)

_COMMON = {
    "metric_name": "consistency_score",
    "metric_mode": "min",
    "min_gap": 0.05,
    "metric_threshold": 0.8,
    "motion_threshold": 0.001,
    "learning_rate": 5e-6,
    "beta": 1.0,
    "warmup_steps": 500,
    "lora_rank": 64,
    "lora_alpha": 128.0,
    "checkpoint_every_n_steps": 1000,
    "log_every_n_steps": 10,
    "save_top_k": 10,
}

_PER_RECIPE = {
    # reference train/CogVideoX-5B/03_train.py:60-61 (batch 1, accum 2)
    "CogVideoX-5B": {
        "model_path": "THUDM/CogVideoX-5B",
        "max_steps": 10000,
        "batch_size": 1,
        "accumulate_grad_batches": 2,
        "gradient_clip_val": 1.0,
    },
    # reference train/CogVideoX-I2V-5B/03_train.py:39-80 (batch 2)
    "CogVideoX-I2V-5B": {
        "model_path": "THUDM/CogVideoX-5B-I2V",
        "max_steps": 10000,
        "batch_size": 2,
        "gradient_clip_val": 1.0,
    },
    # reference train/CogVideoX1.5-5B/03_train.py:54,95 (max 1500 steps)
    "CogVideoX1.5-5B": {
        "model_path": "THUDM/CogVideoX1.5-5B",
        "max_steps": 1500,
        "batch_size": 1,
        "gradient_clip_val": 1.0,
    },
    # reference train/Wan2.2-TI2V-5B/03_train.py:64-97 (batch 1, accum 2)
    "Wan2.2-TI2V-5B": {
        "model_path": "Wan-AI/Wan2.2-TI2V-5B",
        "max_steps": 10000,
        "batch_size": 1,
        "accumulate_grad_batches": 2,
    },
}


def default_config(recipe: str) -> Dict:
    """DEFAULT_CONFIG for one recipe; DATASET_PATH env read at call time
    (reference scripts read it at import)."""
    if recipe not in _PER_RECIPE:
        raise ValueError(f"unknown recipe {recipe!r}; choose from {RECIPES}")
    dataset_path = os.environ.get("DATASET_PATH", "/path/to/your/dataset")
    cfg = dict(_COMMON)
    cfg.update(_PER_RECIPE[recipe])
    cfg.update(
        metadata_path=f"{dataset_path}/meta_data.json",
        base_path=dataset_path,
        output_dir=f"outputs/{recipe}-dpo",
        experiment_name=f"{recipe}-dpo-tpu",
    )
    return cfg


def build_config(
    recipe: str,
    config_yaml: Optional[str] = None,
    base_path: Optional[str] = None,
) -> Dict:
    """DEFAULT_CONFIG + optional YAML merge under key 'training' + base_path
    override — the shared argument semantics of every 03_train.py script."""
    config = default_config(recipe)
    if config_yaml:
        import yaml

        with open(config_yaml) as f:
            config.update(yaml.safe_load(f).get("training", {}))
    if base_path:
        config["base_path"] = base_path
    config["metadata_path"] = f"{config['base_path']}/meta_data.json"
    return config


def run_recipe(recipe: str, config: Dict, device=None) -> None:
    """Dispatch a resolved config to the right trainer, on ``device`` (the
    card unless ``device="cpu"``). The Wan2.2-TI2V-5B trainer needs the Wan
    checkpoint converter and raises until it is ported (ROADMAP item G)."""
    if recipe not in _PER_RECIPE:
        raise ValueError(f"unknown recipe {recipe!r}; choose from {RECIPES}")
    if recipe == "Wan2.2-TI2V-5B":
        raise NotImplementedError(
            "run_recipe('Wan2.2-TI2V-5B'): train_wan_dpo needs convert_wan and the Wan "
            "loader, not ported yet (ROADMAP item G); drive "
            "train.wan_trainer.make_wan_dpo_train_step directly")
    from videogpa_torch.cli.train_dpo import train_dpo
    from videogpa_torch.models.cogvideox import CogVideoXConfig

    model_cfg, i2v = {
        "CogVideoX-5B": (CogVideoXConfig.cogvideox_5b, False),
        "CogVideoX-I2V-5B": (CogVideoXConfig.cogvideox_5b_i2v, True),
        "CogVideoX1.5-5B": (CogVideoXConfig.cogvideox_1_5_5b, False),
    }[recipe]
    train_dpo(config, model_cfg(), i2v=i2v, device=device)
