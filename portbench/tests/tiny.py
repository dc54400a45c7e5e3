"""Cells of the benchmark cut to a size the CPU runs in a second, for the
tests: every width divided down, two layers, the same traffic mixes."""

from __future__ import annotations

import contextlib
import copy

import torch

from portbench import spec


def tiny_cell(name: str) -> spec.Cell:
    cell = copy.deepcopy(spec.find_cell(name))
    cell.config["model"].update(num_layers=2, num_heads=2, head_dim=16, in_channels=4,
                                out_channels=4, text_embed_dim=32, time_embed_dim=16,
                                max_text_seq_length=8)
    cell.config["video"].update(latent_frames=3, latent_height=8, latent_width=12)
    cell.config["train"].update(lora_rank=4, lora_alpha=8.0)
    return cell


@contextlib.contextmanager
def program_in_f32():
    """The port computes in float32 (its compute_dtype), so that a sound run
    agrees with the reference to rounding and only a planted fault fails."""
    import videogpa_torch.train.trainer as trainer

    config = trainer.TrainerConfig

    def config_f32(**kwargs):
        return config(compute_dtype=torch.float32, **kwargs)

    trainer.TrainerConfig = config_f32
    try:
        yield
    finally:
        trainer.TrainerConfig = config
