"""CogVideoX noise schedulers: shared schedule + DDIM and DPM-Solver++ steps.

Counterpart of ``videogpa_tpu/models/cogvideox/scheduler.py``:
- scaled_linear betas sqrt-space linspace(sqrt(0.00085), sqrt(0.012), 1000)
- SNR shift: ac <- ac / (s + (1 - s) * ac) with s = snr_shift_scale = 3.0
- zero-terminal-SNR rescale (Lin et al. 2024)
- v-prediction; "trailing" timestep spacing for sampling

The schedule is built in numpy float64 and cast to float32 at the end. The
table stays on the CPU; step coefficients are 0-d float32 tensors, which
broadcast against samples on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _make_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    snr_shift_scale: float = 3.0,
    rescale_betas_zero_snr: bool = True,
) -> np.ndarray:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod = alphas_cumprod / (
        snr_shift_scale + (1 - snr_shift_scale) * alphas_cumprod
    )
    if rescale_betas_zero_snr:
        sqrt_ac = np.sqrt(alphas_cumprod)
        s0, sT = sqrt_ac[0].copy(), sqrt_ac[-1].copy()
        sqrt_ac = sqrt_ac - sT
        sqrt_ac = sqrt_ac * s0 / (s0 - sT)
        alphas_cumprod = sqrt_ac ** 2
    return alphas_cumprod.astype(np.float32)


def _lam(ac: torch.Tensor) -> torch.Tensor:
    # log(sqrt(ac / (1 - ac))) with the alphas floored: with zero-terminal
    # SNR ac[999] == 0 exactly, and the floor keeps every value finite
    ac = torch.clamp(ac, 1e-20, 1.0 - 1e-12)
    return 0.5 * torch.log(ac / (1 - ac))


@dataclasses.dataclass
class CogVideoXScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 3.0
    rescale_betas_zero_snr: bool = True
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"

    def __post_init__(self):
        self.alphas_cumprod = torch.from_numpy(_make_alphas_cumprod(
            self.num_train_timesteps, self.beta_start, self.beta_end,
            self.snr_shift_scale, self.rescale_betas_zero_snr,
        ))
        # set_alpha_to_one=False in CogVideoX configs -> alphas_cumprod[0]
        self.final_alpha_cumprod = self.alphas_cumprod[0]

    # ------------------------------------------------------------------
    # Training utilities
    # ------------------------------------------------------------------

    def _gather_ac(self, timesteps: torch.Tensor, ndim: int) -> torch.Tensor:
        ac = self.alphas_cumprod.to(timesteps.device)[timesteps]
        return ac.reshape(ac.shape + (1,) * (ndim - ac.ndim))

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        ac = self._gather_ac(timesteps, original.ndim).to(original.dtype)
        return torch.sqrt(ac) * original + torch.sqrt(1 - ac) * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        ac = self._gather_ac(timesteps, sample.ndim).to(sample.dtype)
        return torch.sqrt(ac) * noise - torch.sqrt(1 - ac) * sample

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        if self.timestep_spacing == "trailing":
            step = self.num_train_timesteps / num_inference_steps
            ts = np.round(np.arange(self.num_train_timesteps, 0, -step)).astype(np.int64)
            ts -= 1
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, self.num_train_timesteps - 1, num_inference_steps)
            ts = ts.round()[::-1].astype(np.int64)
        else:
            step = self.num_train_timesteps // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
        return ts

    def _ac_prev(self, prev_timestep: int) -> torch.Tensor:
        if prev_timestep >= 0:
            return self.alphas_cumprod[prev_timestep]
        return self.final_alpha_cumprod

    def _pred_x0_eps(self, sample, model_output, ac_t) -> Tuple[torch.Tensor, torch.Tensor]:
        sqrt_ac = torch.sqrt(ac_t)
        sqrt_1mac = torch.sqrt(1 - ac_t)
        if self.prediction_type == "v_prediction":
            x0 = sqrt_ac * sample - sqrt_1mac * model_output
            eps = sqrt_ac * model_output + sqrt_1mac * sample
        elif self.prediction_type == "epsilon":
            eps = model_output
            x0 = (sample - sqrt_1mac * eps) / torch.clamp(sqrt_ac, min=1e-8)
        else:
            raise ValueError(self.prediction_type)
        return x0, eps

    def ddim_step(self, model_output: torch.Tensor, timestep: int, prev_timestep: int,
                  sample: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM update (the CogVideoX a_t/b_t formulation)."""
        ac_t = self.alphas_cumprod[timestep]
        ac_prev = self._ac_prev(prev_timestep)
        x0, _ = self._pred_x0_eps(sample, model_output, ac_t)
        a_t = torch.sqrt((1 - ac_prev) / torch.clamp(1 - ac_t, min=1e-12))
        b_t = torch.sqrt(ac_prev) - torch.sqrt(ac_t) * a_t
        return a_t * sample + b_t * x0

    def dpm_step(
        self,
        model_output: torch.Tensor,
        timestep: int,
        prev_timestep: int,
        sample: torch.Tensor,
        noise: torch.Tensor,
        old_x0: Optional[torch.Tensor] = None,
        timestep_back: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """diffusers ``CogVideoXDPMScheduler.step`` (SDE DPM-Solver++ 2M).

        Returns (prev_first_order, prev_second_order, pred_x0); callers take
        the 2nd-order result when old_x0 is real and prev_timestep >= 0.
        """
        ac_t = self.alphas_cumprod[timestep]
        ac_prev = self._ac_prev(prev_timestep)
        x0, _ = self._pred_x0_eps(sample, model_output, ac_t)

        lam_t = _lam(ac_t)
        lam_s = _lam(ac_prev)
        h = lam_s - lam_t

        mult1 = torch.sqrt((1 - ac_prev) / torch.clamp(1 - ac_t, min=1e-12)) * torch.exp(-h)
        mult2 = torch.expm1(-2 * h) * torch.sqrt(ac_prev)
        mult_noise = torch.sqrt(1 - ac_prev) * torch.sqrt(
            torch.clamp(1 - torch.exp(-2 * h), min=0.0))

        prev1 = mult1 * sample - mult2 * x0 + mult_noise * noise
        if old_x0 is None:
            return prev1, prev1, x0
        ac_back = self.alphas_cumprod[max(timestep_back, 0) if timestep_back is not None else 0]
        lam_back = _lam(ac_back)
        r = (lam_t - lam_back) / torch.where(h == 0, 1e-12, h)
        r = torch.where(r == 0, 1e-12, r)
        mult3, mult4 = 1 + 1 / (2 * r), 1 / (2 * r)
        # ac_back == 0 (the zero-terminal-SNR t=999 as timestep_back): the true
        # lam_back is -inf, so the 2nd-order correction degenerates to 1st order
        if ac_back <= 1e-19:
            mult3, mult4 = torch.ones_like(mult3), torch.zeros_like(mult4)
        denoised_d = mult3 * x0 - mult4 * old_x0
        prev2 = mult1 * sample - mult2 * denoised_d + mult_noise * noise
        return prev1, prev2, x0
