"""Diffusion-DPO loss (``videogpa_tpu/train/loss.py``).

Per-sample MSE (f32) of prediction against target for the policy and the
frozen reference; the implicit reward is the improvement over the reference:

    logits = beta * ((ref_win_err - model_win_err) - (ref_lose_err - model_lose_err))
    loss   = -logsigmoid(logits)          (or hinge / label-smoothed BCE)

Errors reduce over all non-batch axes, so any latent layout works.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class LossOutput:
    loss: torch.Tensor
    reward_margin: torch.Tensor
    winner_reward: torch.Tensor
    loser_reward: torch.Tensor
    accuracy: torch.Tensor


def _per_sample_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, pred.ndim))
    return ((pred.float() - target.float()) ** 2).mean(dim=dims)


@dataclasses.dataclass(frozen=True)
class DPOLoss:
    beta: float = 500.0
    label_smoothing: float = 0.0
    loss_type: str = "sigmoid"  # "sigmoid" | "hinge"

    def __call__(
        self,
        v_win: torch.Tensor,
        v_lose: torch.Tensor,
        v_win_ref: torch.Tensor,
        v_lose_ref: torch.Tensor,
        v_win_target: torch.Tensor,
        v_lose_target: torch.Tensor,
    ) -> LossOutput:
        model_win_err = _per_sample_mse(v_win, v_win_target)
        model_lose_err = _per_sample_mse(v_lose, v_lose_target)
        ref_win_err = _per_sample_mse(v_win_ref, v_win_target)
        ref_lose_err = _per_sample_mse(v_lose_ref, v_lose_target)

        win_diff = ref_win_err - model_win_err
        lose_diff = ref_lose_err - model_lose_err

        winner_reward = -model_win_err
        loser_reward = -model_lose_err
        reward_margin = winner_reward - loser_reward

        logits = self.beta * (win_diff - lose_diff)

        if self.loss_type == "sigmoid":
            if self.label_smoothing > 0:
                target = 1.0 - self.label_smoothing
                # BCE-with-logits against a soft target
                loss = torch.mean(
                    torch.clamp(logits, min=0)
                    - logits * target
                    + torch.log1p(torch.exp(-logits.abs()))
                )
            else:
                loss = -torch.mean(F.logsigmoid(logits))
        elif self.loss_type == "hinge":
            loss = torch.mean(F.relu(1.0 - logits))
        else:
            raise ValueError(f"Unknown loss type: {self.loss_type}")

        accuracy = (winner_reward > loser_reward).float().mean()
        return LossOutput(
            loss=loss,
            reward_margin=reward_margin.mean(),
            winner_reward=winner_reward.mean(),
            loser_reward=loser_reward.mean(),
            accuracy=accuracy,
        )


@dataclasses.dataclass(frozen=True)
class SFTLoss:
    def __call__(self, v_pred: torch.Tensor, v_target: torch.Tensor, **_) -> LossOutput:
        loss = torch.mean((v_pred.float() - v_target.float()) ** 2)
        zero = torch.zeros((), device=loss.device)
        return LossOutput(loss, zero, zero, zero, zero)


def create_loss_strategy(strategy: str = "dpo", beta: float = 1.0,
                         label_smoothing: float = 0.0):
    if strategy == "dpo":
        return DPOLoss(beta=beta, label_smoothing=label_smoothing)
    if strategy == "sft":
        return SFTLoss()
    raise ValueError(f"Unknown strategy: {strategy}")
