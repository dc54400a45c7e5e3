"""Diffusion-DPO LoRA train step for the CogVideoX recipes
(``videogpa_tpu/train/trainer.py:41-251``).

Shared noise and timestep for the win/lose pair, velocity targets, the DPO
loss against a frozen reference, AdamW with a warmup-cosine schedule, a
global-norm clip and optional gradient accumulation. Models with image
channels are conditioned on the VAE-encoded first frame (``_i2v_condition``)
where the batch holds ``image_emb`` and a frozen VAE is given, else on zeros
(``trainer.py:171-176``).

The frozen reference is the policy's own base weights with no LoRA, so the
5B weights live on the card once. Only the LoRA tensors require grad: the
policy forwards run with grad (recomputing each block in the backward when
``remat`` is on) and the reference forwards under ``torch.no_grad``. The
optimiser reproduces the JAX package's optax chain in plain tensor code and
updates the LoRA tensors in place. Timesteps and noise come from a
``torch.Generator`` on the model's device, drawn in the JAX step's order
(timesteps, noise, then the first frame's posterior noise), or are
injected, so a test can feed the JAX draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward
from videogpa_torch.models.cogvideox.scheduler import CogVideoXScheduler
from videogpa_torch.models.cogvideox.vae import CogVideoXVAE, vae_encode
from videogpa_torch.ops.resize import resize_bilinear
from videogpa_torch.parallel.mesh import get_mesh
from videogpa_torch.parallel.sharding import data_rows, mean_over_data, reduce_grads, take_rows
from videogpa_torch.parallel.tp import is_sharded
from videogpa_torch.train.lora import lora_leaves
from videogpa_torch.train.loss import DPOLoss


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    learning_rate: float = 5e-6
    beta: float = 1.0
    warmup_steps: int = 500
    max_steps: int = 10_000
    gradient_clip_val: float = 1.0
    weight_decay: float = 0.01  # torch AdamW default (reference optimizer)
    accumulate_grad_batches: int = 1  # reference: 2 for T2V/Wan recipes
    lora_rank: int = 64
    lora_alpha: float = 128.0
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_impl: str = "auto"  # "flash_int8" is inference only and raises under grad


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class Optimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(c), adamw(schedule,
    weight_decay=wd)), k)`` of ``trainer.py:57-71``, updating in place.

    - schedule: ``warmup_cosine_decay_schedule(0, lr, warmup, max_steps, 0)``;
      the decay span includes the warmup and the first update uses
      schedule(0);
    - clip: g * c / ||g|| when ||g|| >= c, with no epsilon;
    - adamw: b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled
      decay added to the Adam direction before the learning rate;
    - accumulation (k > 1): a running mean of the gradients; every k-th call
      makes one inner update from it, the calls between change nothing.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tcfg: TrainerConfig):
        if tcfg.max_steps <= tcfg.warmup_steps:
            raise ValueError("max_steps must exceed warmup_steps: the cosine span is "
                             "their difference")
        self.tcfg = tcfg
        self.k = tcfg.accumulate_grad_batches

    def schedule(self, count: int) -> float:
        t = self.tcfg
        if count < t.warmup_steps:
            return t.learning_rate * count / t.warmup_steps
        span = t.max_steps - t.warmup_steps
        c = min(count - t.warmup_steps, span)
        return t.learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / span))

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32).detach() for p in params]

        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.k > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=zeros())
        return state

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        if self.k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc_grads"], grads):
                acc.add_((g - acc) / (n + 1))
            if n + 1 < self.k:
                state["mini_step"] = n + 1
                return
            grads = state["acc_grads"]
        g_norm = global_norm(grads)
        clip = self.tcfg.gradient_clip_val
        grads = [torch.where(g_norm < clip, g, g / g_norm * clip) for g in grads]
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        wd = self.tcfg.weight_decay
        for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            direction = (m / c1) / ((v / c2).sqrt() + self.eps) + wd * p
            p.sub_(lr * direction)
        state["count"] = count
        if self.k > 1:
            for acc in state["acc_grads"]:
                acc.zero_()
            state["mini_step"] = 0
            state["gradient_step"] += 1


def make_optimizer(tcfg: TrainerConfig) -> Optimizer:
    return Optimizer(tcfg)


@dataclasses.dataclass
class TrainState:
    """LoRA tensors (leaves that require grad), optimiser state and the
    count of train-step calls. ``train_step`` updates it in place."""

    lora: dict
    opt_state: dict
    step: int = 0

    def __post_init__(self):
        for t in lora_leaves(self.lora):
            t.requires_grad_(True)


def init_train_state(lora: dict, tcfg: TrainerConfig) -> TrainState:
    return TrainState(lora=lora, opt_state=make_optimizer(tcfg).init(lora_leaves(lora)))


@torch.no_grad()
def _i2v_condition(vae: CogVideoXVAE, image_emb: torch.Tensor, latents: torch.Tensor,
                   cfg: CogVideoXConfig, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode the first-frame image and zero-pad it over time (reference
    ``03_train.py:121-130``): resize the image to 8x the latent grid,
    VAE-encode with a sampled posterior (``noise`` or a ``generator`` draw),
    pad F - 1 zero frames. latents (B, F, C, h, w) -> (B, F, z, h, w)."""
    B, F = latents.shape[:2]
    H, W = latents.shape[3] * 8, latents.shape[4] * 8
    img = resize_bilinear(image_emb, (H, W), align_corners=False)
    lat = vae_encode(vae, img[:, :, None], cfg, generator=generator, noise=noise, sample=True)
    lat = lat.transpose(1, 2)  # (B, 1, z, h, w)
    return torch.cat([lat, lat.new_zeros((B, F - 1) + lat.shape[2:])], dim=1)


def make_dpo_train_step(model: CogVideoXTransformer, cfg: CogVideoXConfig,
                        tcfg: TrainerConfig,
                        vae: Optional[CogVideoXVAE] = None) -> Tuple[Callable, Callable]:
    """Build ``(train_step, eval_step)`` over ``model``'s base weights.

    ``train_step(state, batch, generator=None, timesteps=None, noise=None,
    posterior_noise=None)`` returns ``(state, metrics)``; ``eval_step`` with
    the same arguments returns metrics and changes nothing. ``batch`` holds
    ``x_win``/``x_lose`` (B, C, F, H, W) latents, ``prompt_emb`` (B, L, D)
    and, for I2V, ``image_emb`` (B, 3, H, W) in [-1, 1], as tensors or numpy
    arrays (``train.dataset.collate``). With ``image_emb`` and the frozen
    ``vae`` the image channels carry the encoded first frame, else zeros.
    Draws come from ``generator`` (on the model's device; None means the
    default generator) unless ``timesteps`` (B,), ``noise`` (B, F, C, H, W)
    and ``posterior_noise`` (B, z, 1, H/8, W/8) are given. Metrics are 0-d f32
    tensors on the model's device: loss, reward_margin, reward_accuracy,
    winner_reward, loser_reward and, from ``train_step``, grad_norm (the
    unclipped global norm of this call's gradients).

    Under an ambient mesh (``parallel.set_mesh``), as JAX's step under
    ``jax.set_mesh``: ``batch`` is this rank's ``batch_specs`` slice, and
    the draws (made here or given) are for the whole batch of dp slices,
    of which each rank keeps its rows; ``model`` may be a
    ``dit_param_specs`` shard and ``tcfg.attn_impl`` "ring". The LoRA
    gradients are summed over ``model`` (where the DiT is sharded) and
    averaged over ``data`` before the norm, the clip and AdamW, and the
    metrics are averaged over ``data``: the numbers of one process on the
    whole batch.
    """
    scheduler = CogVideoXScheduler()
    loss_fn = DPOLoss(beta=tcfg.beta)
    optimizer = make_optimizer(tcfg)
    lora_scaling = tcfg.lora_alpha / tcfg.lora_rank
    device = next(model.parameters()).device
    tensor_parallel = is_sharded(model.blocks[0].attn1.to_q, cfg.hidden_dim)

    def as_f32(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=device, dtype=torch.float32)

    def forward(lora, latents_noisy, prompt_emb, timesteps):
        return dit_forward(model, latents_noisy, prompt_emb, timesteps,
                           compute_dtype=tcfg.compute_dtype, lora=lora,
                           lora_scaling=lora_scaling, attn_layout="bnhd",
                           remat=tcfg.remat and lora is not None,
                           attn_impl=tcfg.attn_impl)

    def shared_step(lora, batch, generator, timesteps, noise, posterior_noise):
        x_win = as_f32(batch["x_win"]).transpose(1, 2)  # -> (B, F, C, H, W)
        x_lose = as_f32(batch["x_lose"]).transpose(1, 2)
        if cfg.patch_size_t is not None:
            # CogVideoX1.5: trim latents so F divides patch_size_t and H/W
            # divide the spatial patch (reference 1.5 trainer :135-142)
            _, F0, _, H0, W0 = x_win.shape
            nf = F0 - F0 % cfg.patch_size_t
            nh = H0 - H0 % cfg.patch_size
            nw = W0 - W0 % cfg.patch_size
            x_win = x_win[:, :nf, :, :nh, :nw]
            x_lose = x_lose[:, :nf, :, :nh, :nw]
        prompt_emb = as_f32(batch["prompt_emb"])
        # under a mesh with data parallelism the batch is this rank's slice:
        # draws are made for the whole batch and this rank keeps its rows
        B, rows = data_rows(get_mesh(), x_win.shape[0])
        i2v = "image_emb" in batch and vae is not None

        if timesteps is None:
            timesteps = torch.randint(0, scheduler.num_train_timesteps, (B,),
                                      generator=generator, device=device)
        if noise is None:
            noise = torch.randn((B,) + x_win.shape[1:], generator=generator, device=device,
                                dtype=torch.float32)
        if i2v and rows is not None and posterior_noise is None:
            # the draw vae_encode makes for the first frame's posterior
            posterior_noise = torch.randn((B, x_win.shape[2], 1) + x_win.shape[3:],
                                          generator=generator, device=device)
        timesteps = take_rows(torch.as_tensor(timesteps, device=device).long(), rows, B,
                              "timesteps")
        noise = take_rows(as_f32(noise), rows, B, "noise")
        if posterior_noise is not None:
            posterior_noise = take_rows(as_f32(posterior_noise), rows, B, "posterior_noise")

        if i2v:
            img_cond = _i2v_condition(vae, as_f32(batch["image_emb"]), x_win, cfg,
                                      generator=generator, noise=posterior_noise).float()
        elif cfg.in_channels > cfg.out_channels:
            img_cond = torch.zeros_like(x_win)
        else:
            img_cond = None

        def with_cond(x):
            noisy = scheduler.add_noise(x, noise, timesteps)
            if img_cond is not None:
                noisy = torch.cat([noisy, img_cond], dim=2)
            return noisy

        x_win_noisy = with_cond(x_win)
        x_lose_noisy = with_cond(x_lose)

        # policy: base + LoRA; frozen reference: the same base, no LoRA
        v_win = forward(lora, x_win_noisy, prompt_emb, timesteps)
        v_lose = forward(lora, x_lose_noisy, prompt_emb, timesteps)
        with torch.no_grad():
            v_win_ref = forward(None, x_win_noisy, prompt_emb, timesteps)
            v_lose_ref = forward(None, x_lose_noisy, prompt_emb, timesteps)

        v_win_target = scheduler.get_velocity(x_win, noise, timesteps)
        v_lose_target = scheduler.get_velocity(x_lose, noise, timesteps)

        out = loss_fn(v_win, v_lose, v_win_ref, v_lose_ref, v_win_target, v_lose_target)
        metrics = {
            "loss": out.loss.detach(),
            "reward_margin": out.reward_margin.detach(),
            "reward_accuracy": out.accuracy.detach(),
            "winner_reward": out.winner_reward.detach(),
            "loser_reward": out.loser_reward.detach(),
        }
        return out.loss, metrics

    def train_step(state: TrainState, batch: Dict[str, object], generator: Optional[torch.Generator] = None,
                   timesteps: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   posterior_noise: Optional[torch.Tensor] = None):
        params = lora_leaves(state.lora)
        loss, metrics = shared_step(state.lora, batch, generator, timesteps, noise,
                                    posterior_noise)
        grads = torch.autograd.grad(loss, params)
        # the whole step's gradients before the norm, the clip and AdamW
        mesh = get_mesh()
        grads = reduce_grads(grads, mesh, tensor_parallel)
        metrics = mean_over_data(metrics, mesh)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, object], generator: Optional[torch.Generator] = None,
                  timesteps: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  posterior_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        metrics = shared_step(state.lora, batch, generator, timesteps, noise, posterior_noise)[1]
        return mean_over_data(metrics, get_mesh())

    return train_step, eval_step
