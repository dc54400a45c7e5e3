"""The Diffusion-DPO LoRA step of the CogVideoX recipes in plain PyTorch:
the shared noise and timestep of a pair, velocity targets, the DPO loss
against the frozen base model, the mean of the mini-steps' gradients,
a clip by global norm and AdamW with decoupled weight decay on a
warmup-cosine learning rate.

    err    = mean((v - v_target) ** 2) over each sample
    logits = beta * ((err_ref_win - err_win) - (err_ref_lose - err_lose))
    loss   = -mean(log sigmoid(logits))
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8
NUM_TRAIN = 1000


def alphas_cumprod() -> np.ndarray:
    """CogVideoX's training schedule: betas on a sqrt-space
    linspace(sqrt(0.00085), sqrt(0.012), 1000), squared; alphas_cumprod
    shifted by SNR scale 3 (ac / (s + (1 - s) ac)) and rescaled to zero
    terminal SNR; worked out in float64."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, NUM_TRAIN, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ac = ac / (3.0 + (1.0 - 3.0) * ac)
    s = np.sqrt(ac)
    s0, sT = s[0], s[-1]
    s = (s - sT) * s0 / (s0 - sT)
    return s ** 2


def learning_rate(train: dict, count: int) -> float:
    lr, warm, top = train["learning_rate"], train["warmup_steps"], train["max_steps"]
    if count < warm:
        return lr * count / warm
    span = top - warm
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warm, span) / span))


def dpo_loss(forward: Callable, pair: Dict[str, torch.Tensor], lora: dict,
             beta: float) -> torch.Tensor:
    """``forward(latents, text, timesteps, lora)`` -> v; ``lora`` None is the
    frozen base model. pair: x_win, x_lose (B, C, F, H, W), prompt_emb,
    timesteps (B,), noise (B, F, C, H, W)."""
    ac = torch.from_numpy(alphas_cumprod().astype(np.float32)).to(pair["noise"].device)
    a = ac[pair["timesteps"]].reshape(-1, 1, 1, 1, 1)
    noise = pair["noise"].float()
    t, emb = pair["timesteps"], pair["prompt_emb"].float()
    errs = {}
    for side in ("win", "lose"):
        x = pair[f"x_{side}"].float().transpose(1, 2)
        noisy = a.sqrt() * x + (1 - a).sqrt() * noise
        target = a.sqrt() * noise - (1 - a).sqrt() * x
        with torch.no_grad():
            v_ref = forward(noisy, emb, t, None)
        errs["ref_" + side] = ((v_ref - target) ** 2).mean(dim=(1, 2, 3, 4))
        del v_ref
        v = forward(noisy, emb, t, lora)
        errs[side] = ((v - target) ** 2).mean(dim=(1, 2, 3, 4))
        del v
    logits = beta * ((errs["ref_win"] - errs["win"]) - (errs["ref_lose"] - errs["lose"]))
    return -F.logsigmoid(logits).mean()


def train_steps(forward: Callable, pairs: Sequence[Dict[str, torch.Tensor]], lora0: dict,
                train: dict, resume_update: int, second_moment: float) -> dict:
    """The first ``len(pairs)`` mini-steps of a run resumed at update
    ``resume_update`` (first moments 0, second moments ``second_moment``) from
    the LoRA tree ``lora0`` ({target: {"lora_A", "lora_B"}}).

    Returns the readings the benchmark compares: each mini-step's loss, each
    leaf's norm of the first mini-step's gradient, and each leaf's norm of
    the change after the last mini-step."""
    names = [(t, k) for t in lora0 for k in ("lora_A", "lora_B")]
    params = [lora0[t][k].detach().clone().float().requires_grad_(True) for t, k in names]
    start = [p.detach().clone() for p in params]
    tree = {t: (params[2 * i], params[2 * i + 1]) for i, t in enumerate(lora0)}
    acc = [torch.zeros_like(p) for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.full_like(p, second_moment) for p in params]
    k = train["accumulate_grad_batches"]
    count, n_acc = resume_update, 0
    losses: List[float] = []
    first_grad: List[float] = []
    for i, pair in enumerate(pairs):
        loss = dpo_loss(forward, pair, tree, train["beta"])
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for a_, g in zip(acc, grads):
                a_.add_((g - a_) / (n_acc + 1))
            if i == 0:
                first_grad = [float(a_.norm()) for a_ in acc]
            n_acc += 1
            if n_acc < k:
                continue
            norm = torch.sqrt(sum((g ** 2).sum() for g in acc))
            clip = train["gradient_clip_val"]
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            lr = learning_rate(train, count)
            count += 1
            c1, c2 = 1 - B1 ** count, 1 - B2 ** count
            for p, g, m_, v_ in zip(params, acc, m, v):
                g = g * scale
                m_.mul_(B1).add_(g, alpha=1 - B1)
                v_.mul_(B2).addcmul_(g, g, value=1 - B2)
                p.sub_(lr * ((m_ / c1) / ((v_ / c2).sqrt() + EPS) + train["weight_decay"] * p))
            for a_ in acc:
                a_.zero_()
            n_acc = 0
    change = [float((p.detach() - s).norm()) for p, s in zip(params, start)]
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "leaves": [f"{t}.{k}" for t, k in names]}
