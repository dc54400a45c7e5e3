"""Wan2.2-TI2V DPO train step (flow matching)
(``videogpa_tpu/train/wan_trainer.py``).

Shifted-sigma flow-matching noise, the clean image latent as the first
temporal frame, a per-token timestep tensor with t = 0 on the first frame's
tokens, shared noise and timestep for the win/lose pair, velocity target
eps - z0.

As in the CogVideoX trainer: policy = base + LoRA, reference = the bare base
under ``torch.no_grad`` (the 5B weights live on the card once); only the LoRA
tensors require grad; the optimiser updates them in place. Timesteps and
noise come from a ``torch.Generator`` on the model's device, drawn in the JAX
step's order (timesteps, then noise), or are injected, so a test can feed
the JAX draws.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.models.wan.dit import WanTransformer, wan_forward
from videogpa_torch.models.wan.flow_match import (
    flow_add_noise,
    flow_velocity_target,
    sigma_from_timestep,
    ti2v_timestep_tokens,
)
from videogpa_torch.parallel.mesh import get_mesh
from videogpa_torch.parallel.sharding import data_rows, mean_over_data, reduce_grads, take_rows
from videogpa_torch.parallel.tp import is_sharded
from videogpa_torch.train.lora import lora_leaves
from videogpa_torch.train.loss import DPOLoss
from videogpa_torch.train.trainer import TrainerConfig, TrainState, global_norm, make_optimizer


def make_wan_dpo_train_step_unbound(cfg: WanConfig,
                                    tcfg: TrainerConfig) -> Tuple[Callable, Callable]:
    """Build ``(train_step, eval_step)`` with the base model unbound:
    ``step(model, state, batch, generator=None, timesteps=None, noise=None)``.

    ``batch`` holds ``x_win``/``x_lose`` (B, C, F, H, W) latents,
    ``prompt_emb`` (B, L, D) and optionally ``image_latent`` (B, C, 1, H, W),
    as tensors or numpy arrays. Draws come from ``generator`` (on the model's
    device; None means the default generator) unless ``timesteps`` (B,), in
    [1, T), and ``noise`` (B, C, F, H, W) are given. ``train_step`` returns
    ``(state, metrics)`` and updates ``state`` in place; ``eval_step`` returns
    metrics. Metrics are 0-d f32 tensors on the model's device: loss,
    reward_margin, reward_accuracy and, from ``train_step``, grad_norm (the
    unclipped global norm of this call's gradients).

    Under an ambient mesh, as the CogVideoX step (``make_dpo_train_step``):
    ``batch`` is this rank's slice, the draws are for the whole batch, the
    model may be a ``wan_param_specs`` shard and ``attn_impl`` "ring"; the
    LoRA gradients are summed over ``model`` and averaged over ``data``.
    """
    loss_fn = DPOLoss(beta=tcfg.beta)
    optimizer = make_optimizer(tcfg)
    lora_scaling = tcfg.lora_alpha / tcfg.lora_rank

    def forward(model, lora, latents, t, context):
        return wan_forward(model, latents, t, context,
                           remat=tcfg.remat and lora is not None,
                           compute_dtype=tcfg.compute_dtype, lora=lora,
                           lora_scaling=lora_scaling, attn_impl=tcfg.attn_impl)

    def shared_step(model, lora, batch, generator, timesteps, noise):
        device = next(model.parameters()).device

        def as_f32(x) -> torch.Tensor:
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return x.to(device=device, dtype=torch.float32)

        x_win = as_f32(batch["x_win"])  # (B, C, F, H, W)
        x_lose = as_f32(batch["x_lose"])
        context = as_f32(batch["prompt_emb"])
        image_latent = batch.get("image_latent")
        _, _, F, H, W = x_win.shape
        # under data parallelism: draws for the whole batch, this rank's rows
        B, rows = data_rows(get_mesh(), x_win.shape[0])

        if timesteps is None:
            timesteps = torch.randint(1, cfg.num_train_timesteps, (B,), generator=generator,
                                      device=device)
        if noise is None:
            noise = torch.randn((B,) + x_win.shape[1:], generator=generator, device=device,
                                dtype=torch.float32)
        timesteps = take_rows(torch.as_tensor(timesteps, device=device), rows, B, "timesteps")
        noise = take_rows(as_f32(noise), rows, B, "noise")
        sigma = sigma_from_timestep(timesteps, cfg.num_train_timesteps, cfg.shift)

        x_win_noisy = flow_add_noise(x_win, noise, sigma)
        x_lose_noisy = flow_add_noise(x_lose, noise, sigma)
        if image_latent is not None:
            image_latent = as_f32(image_latent)
            x_win_noisy = torch.cat([image_latent, x_win_noisy[:, :, 1:]], dim=2)
            x_lose_noisy = torch.cat([image_latent, x_lose_noisy[:, :, 1:]], dim=2)

        t_tokens = ti2v_timestep_tokens(timesteps, (F, H, W), cfg.patch_size)

        # policy: base + LoRA; frozen reference: the same base, no LoRA
        v_win = forward(model, lora, x_win_noisy, t_tokens, context)
        v_lose = forward(model, lora, x_lose_noisy, t_tokens, context)
        with torch.no_grad():
            v_win_ref = forward(model, None, x_win_noisy, t_tokens, context)
            v_lose_ref = forward(model, None, x_lose_noisy, t_tokens, context)

        v_win_target = flow_velocity_target(x_win, noise)
        v_lose_target = flow_velocity_target(x_lose, noise)

        out = loss_fn(v_win, v_lose, v_win_ref, v_lose_ref, v_win_target, v_lose_target)
        return out.loss, {
            "loss": out.loss.detach(),
            "reward_margin": out.reward_margin.detach(),
            "reward_accuracy": out.accuracy.detach(),
        }

    def train_step(model: WanTransformer, state: TrainState, batch: Dict[str, object],
                   generator: Optional[torch.Generator] = None,
                   timesteps: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        params = lora_leaves(state.lora)
        loss, metrics = shared_step(model, state.lora, batch, generator, timesteps, noise)
        grads = torch.autograd.grad(loss, params)
        mesh = get_mesh()
        grads = reduce_grads(grads, mesh, is_sharded(model.blocks[0].self_attn.q, cfg.dim))
        metrics = mean_over_data(metrics, mesh)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(model: WanTransformer, state: TrainState, batch: Dict[str, object],
                  generator: Optional[torch.Generator] = None,
                  timesteps: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        metrics = shared_step(model, state.lora, batch, generator, timesteps, noise)[1]
        return mean_over_data(metrics, get_mesh())

    return train_step, eval_step


def make_wan_dpo_train_step(model: WanTransformer, cfg: WanConfig,
                            tcfg: TrainerConfig) -> Tuple[Callable, Callable]:
    """``make_wan_dpo_train_step_unbound`` with ``model``'s base weights
    bound: ``train_step(state, batch, generator=None, timesteps=None,
    noise=None)`` and ``eval_step`` with the same arguments."""
    train_step, eval_step = make_wan_dpo_train_step_unbound(cfg, tcfg)
    return functools.partial(train_step, model), functools.partial(eval_step, model)
