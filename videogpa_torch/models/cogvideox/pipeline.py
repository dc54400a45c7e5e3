"""CogVideoX denoising loop (``videogpa_tpu/models/cogvideox/pipeline.py:30-125``).

Both CFG branches run as one batch-2 forward per step. The loop is a plain
Python loop over the precomputed timesteps. Random draws come from a
``torch.Generator``; ``init_latents`` and ``step_noise`` may be injected
instead, so a test can feed the JAX package's draws. ``sample_t2v``,
``sample_i2v`` and ``decode_latents`` come with the VAE slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward
from videogpa_torch.models.cogvideox.scheduler import CogVideoXScheduler


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    num_inference_steps: int = 50
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = False
    sampler: str = "dpm"  # "dpm" | "ddim"


def _dynamic_cfg(base: float, step_t: int, num_steps: int, num_train: int) -> torch.Tensor:
    """1 + g * (1 - cos(pi * ((T - t)/T)**5)) / 2 (diffusers dynamic cfg), in f32."""
    frac = (num_train - torch.tensor(step_t, dtype=torch.float32)) / num_train
    return 1.0 + base * (1.0 - torch.cos(math.pi * frac ** 5.0)) / 2.0


@torch.no_grad()
def denoise_loop(
    dit: CogVideoXTransformer,
    text_embeds: torch.Tensor,
    negative_embeds: torch.Tensor,
    settings: SamplerSettings,
    latent_shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    image_latents: Optional[torch.Tensor] = None,
    ofs: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Run the full denoising loop on the DiT's device. latent_shape: (B, F, C, H, W).

    Draws the initial latents and each DPM step's noise from ``generator``
    (a generator on the DiT's device) unless ``init_latents`` / ``step_noise``
    (one tensor per step) are given. ``attn_impl="flash_int8"`` with a DiT
    quantised by ``ops.quant.quantize_dit_int8`` is the int8 inference mode.
    """
    device = next(dit.parameters()).device
    scheduler = CogVideoXScheduler()
    n = settings.num_inference_steps
    ts = [int(t) for t in scheduler.timesteps(n)]
    prev_ts = ts[1:] + [-1]
    back_ts = [0] + ts[:-1]  # ts[i-1], the previous (larger) timestep

    def normal():
        return torch.randn(latent_shape, generator=generator, device=device,
                           dtype=torch.float32)

    lat = (normal() if init_latents is None
           else init_latents.to(device=device, dtype=torch.float32))
    embeds = torch.cat([negative_embeds, text_embeds], dim=0)
    old_x0 = None
    for i, (t, t_prev) in enumerate(zip(ts, prev_ts)):
        model_in = torch.cat([lat, lat], dim=0)
        if image_latents is not None:
            img = torch.cat([image_latents, image_latents], dim=0)
            model_in = torch.cat([model_in, img], dim=2)
        t_b = torch.full((model_in.shape[0],), t, dtype=torch.int64, device=device)
        ofs_b = None if ofs is None else ofs.expand(model_in.shape[0])
        v = dit_forward(dit, model_in, embeds, t_b, ofs=ofs_b, compute_dtype=compute_dtype,
                        attn_layout="bnhd", attn_impl=attn_impl)
        v_uncond, v_text = v.chunk(2, dim=0)
        if settings.use_dynamic_cfg:
            g = _dynamic_cfg(settings.guidance_scale, t, n, scheduler.num_train_timesteps)
        else:
            g = settings.guidance_scale
        v = v_uncond + g * (v_text - v_uncond)

        if settings.sampler == "ddim":
            lat = scheduler.ddim_step(v, t, t_prev, lat)
        else:
            # SDE step with fresh noise; 2nd-order correction except on the
            # first and final steps
            noise = normal() if step_noise is None else step_noise[i].to(device)
            second = i > 0 and t_prev >= 0
            prev1, prev2, old_x0 = scheduler.dpm_step(
                v, t, t_prev, lat, noise,
                old_x0=old_x0 if second else None, timestep_back=back_ts[i])
            lat = prev2 if second else prev1
    return lat
