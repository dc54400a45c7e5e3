"""CogVideoX sampling pipelines, T2V and I2V (``videogpa_tpu/models/cogvideox/pipeline.py``).

Parity targets: the diffusers pipelines of the reference CLIs (50 DPM steps,
cfg 6.0, 49 frames; dynamic cfg for 1.5; I2V first-frame latent
conditioning). Both CFG branches run as one batch-2 forward per step. The
loop is a plain Python loop over the precomputed timesteps. Random draws come
from a ``torch.Generator``; ``init_latents``, ``step_noise`` and the I2V
``posterior_noise`` may be injected instead, so a test can feed the JAX
package's draws. ``decode_latents`` decodes through overlapping VAE tiles
and shrinks the tile on a CUDA out-of-memory error.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward
from videogpa_torch.models.cogvideox.scheduler import CogVideoXScheduler
from videogpa_torch.models.cogvideox.vae import CogVideoXVAE, vae_decode_tiled, vae_encode


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


def num_latent_frames(cfg: CogVideoXConfig, num_frames: int) -> int:
    """The latent frames ``sample_t2v`` denoises for ``num_frames`` video
    frames: (num_frames - 1) / 4 + 1, which the 1.5 models round up to a
    multiple of ``patch_size_t`` (81 frames -> 21 -> 22). Every latent frame
    is decoded, so the video has 4 (F - 1) + 1 frames (85 for 81), as in the
    JAX package."""
    F = (num_frames - 1) // cfg.temporal_compression_ratio + 1
    if cfg.patch_size_t is not None:
        F += cfg.patch_size_t - (F % cfg.patch_size_t or cfg.patch_size_t)
    return F


def sample_t2v(
    dit: CogVideoXTransformer,
    vae: CogVideoXVAE,
    text_embeds: torch.Tensor,
    negative_embeds: torch.Tensor,
    cfg: CogVideoXConfig,
    num_frames: int = 49,
    height: int = 480,
    width: int = 720,
    settings: Optional[SamplerSettings] = None,
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Text-to-video: the decoded video (B, 3, T, H, W) in [-1, 1], f32.
    Draws as ``denoise_loop``'s."""
    settings = settings or SamplerSettings()
    B = text_embeds.shape[0]
    sc = cfg.spatial_compression_ratio
    shape = (B, num_latent_frames(cfg, num_frames), cfg.vae_latent_channels, height // sc,
             width // sc)
    latents = denoise_loop(dit, text_embeds, negative_embeds, settings, shape,
                           generator=generator, init_latents=init_latents,
                           step_noise=step_noise, compute_dtype=compute_dtype,
                           attn_impl=attn_impl)
    return decode_latents(vae, latents, cfg)


@torch.no_grad()
def sample_i2v(
    dit: CogVideoXTransformer,
    vae: CogVideoXVAE,
    text_embeds: torch.Tensor,
    negative_embeds: torch.Tensor,
    image: torch.Tensor,
    cfg: CogVideoXConfig,
    num_frames: int = 49,
    settings: Optional[SamplerSettings] = None,
    generator: Optional[torch.Generator] = None,
    posterior_noise: Optional[torch.Tensor] = None,
    init_latents: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Image-to-video. image: (B, 3, H, W) in [-1, 1]. The first frame's
    sampled posterior (``posterior_noise``, (B, z, 1, H/8, W/8), or a draw
    from ``generator`` first) conditions every step through the DiT's image
    channels, zero-padded over the other latent frames."""
    settings = settings or SamplerSettings()
    device = next(dit.parameters()).device
    B, _, H, W = image.shape
    F = (num_frames - 1) // cfg.temporal_compression_ratio + 1
    img_latent = vae_encode(vae, image.to(device)[:, :, None], cfg, generator=generator,
                            noise=posterior_noise, sample=True)  # (B, z, 1, h, w)
    img_latent = img_latent.transpose(1, 2)  # (B, 1, z, h, w)
    pad = img_latent.new_zeros((B, F - 1) + img_latent.shape[2:])
    image_latents = torch.cat([img_latent, pad], dim=1)
    shape = (B, F, cfg.vae_latent_channels, H // 8, W // 8)
    latents = denoise_loop(dit, text_embeds, negative_embeds, settings, shape,
                           generator=generator, init_latents=init_latents,
                           step_noise=step_noise, image_latents=image_latents,
                           compute_dtype=compute_dtype, attn_impl=attn_impl)
    return decode_latents(vae, latents, cfg)


def decode_tile_sizes() -> Tuple[int, ...]:
    """Latent tile sizes ``decode_latents`` tries in turn: the one that
    ``VIDEOGPA_VAE_TILE`` names, else 32, 16, 8."""
    env = os.environ.get("VIDEOGPA_VAE_TILE")
    return (int(env),) if env else (32, 16, 8)


@torch.no_grad()
def decode_latents(vae: CogVideoXVAE, latents: torch.Tensor, cfg: CogVideoXConfig,
                   log=print) -> torch.Tensor:
    """(B, F, C, h, w) latents -> (B, 3, T, H, W) video in [-1, 1], in the
    latents' dtype (f32 for ``denoise_loop``'s), through overlapping tiles.

    Decoding usually runs with the 5B DiT still resident; if a tile does not
    fit beside it (``torch.cuda.OutOfMemoryError``), the cache is emptied and
    the decode retries with the next smaller tile. Every other error is
    raised. ``log`` gets the tile the decode settled on."""
    z = latents.transpose(1, 2)
    sizes = decode_tile_sizes()
    for i, tile in enumerate(sizes):
        try:
            out = vae_decode_tiled(vae, z, cfg, tile_latent=tile)
        except torch.cuda.OutOfMemoryError:
            if i == len(sizes) - 1:
                raise
        else:
            log(f"decode tile {tile}: {z.shape[-2]}x{z.shape[-1]} latents")
            return torch.clamp(out, -1.0, 1.0)
        # outside the handler, so the failed attempt's tensors are released
        torch.cuda.empty_cache()
        log(f"decode tile {tile} out of memory; retrying with {sizes[i + 1]}")
    raise AssertionError("unreachable")


def video_to_uint8(video: torch.Tensor) -> np.ndarray:
    """(B, 3, T, H, W) [-1, 1] -> (B, T, H, W, 3) uint8 on the host."""
    v = video.detach().float().cpu().numpy()
    v = ((v + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    return v.transpose(0, 2, 3, 4, 1)
