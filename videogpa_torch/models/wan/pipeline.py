"""Wan2.2 TI2V denoise loop (flow matching)
(``videogpa_tpu/models/wan/pipeline.py``).

The image-conditioned path keeps the first latent frame clean (the TI2V
trick) by re-imposing it after every solver sub-update and passing per-token
timesteps with t = 0 on the first frame's tokens. Both CFG branches run as
one forward of batch 2B per model evaluation.

Solvers over the shifted sigma schedule:

- ``"unipc"`` (default): the UniPC predictor-corrector multistep scheme at
  solver order 2 / bh2 / x0-prediction, adapted to flow matching
  (alpha_t = 1 - sigma_t, x0 = x_t - sigma_t * v). One model evaluation per
  step.
- ``"euler"``: first-order flow-matching Euler.
- ``"heun"``: trapezoidal second order, two model evaluations per step but
  the last, which stays Euler.

UniPC's coefficients depend on the sigma grid only, so they are computed once
in float64 numpy and the loop is a plain Python loop carrying the sample, the
last corrected sample and a 2-deep history of x0 predictions. The initial
latents come from a ``torch.Generator`` or are injected (``latents=``), so a
test can feed the JAX package's draw. ``sample_ti2v`` wraps the loop in the
Wan VAE: the image's posterior sample in, the streamed decode out.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.models.wan.dit import WanTransformer, wan_forward
from videogpa_torch.models.wan.flow_match import ti2v_timestep_tokens
from videogpa_torch.models.wan.vae import WanVAE, wan_vae_decode, wan_vae_encode


def shifted_sigmas(num_steps: int, shift: float, device=None) -> torch.Tensor:
    """Descending sigma grid sigma_shift(1 -> 0) over num_steps+1 points, f32."""
    s = torch.linspace(1.0, 0.0, num_steps + 1, dtype=torch.float32, device=device)
    return shift * s / (1 + (shift - 1) * s)


def _unipc_coeffs(num_steps: int, shift: float) -> Dict[str, np.ndarray]:
    """UniPC coefficient tables (order 2, bh2, x0-prediction), float32 numpy.

    Mirrors the Wan repo's ``FlowUniPCMultistepScheduler`` (diffusers'
    UniPCMultistepScheduler with alpha_t = 1 - sigma_t): ``lower_order_final``
    order ramp 1,2,...,2,1 on the predictor, corrector order = previous
    step's predictor order, corrector disabled on step 0. All weights are
    functions of the sigma grid only and are computed in float64.

    Update forms (m = x0 predictions, D1 = divided differences):
      predictor: x' = ratio·x + c_m0·m_t + w_prev·(m_{i-1} - m_t)
      corrector: x  = ratio·last_x + c_m0·m_{i-1}
                     + w_hist·(m_{i-2} - m_{i-1}) + w_new·(m_t - m_{i-1})
    """
    N = num_steps
    s = np.linspace(1.0, 0.0, N + 1)
    sig = shift * s / (1 + (shift - 1) * s)
    with np.errstate(divide="ignore"):
        lam = np.log((1.0 - sig) / sig)  # lam[0] finite, lam[N] = +inf

    pred_order = np.minimum(np.minimum(2, N - np.arange(N)), np.arange(N) + 1)
    corr_order = np.concatenate([[0], pred_order[:-1]])  # 0 = corrector off

    def phi_weights(h):
        """(phi1, B_h, b1, b2) for bh2 at log-SNR gap h (hh = -h)."""
        hh = -h
        phi1 = np.expm1(hh)
        b1 = (phi1 / hh - 1.0) / phi1
        b2 = 2.0 * ((phi1 / hh - 1.0) / hh - 0.5) / phi1
        return phi1, phi1, b1, b2

    out = {k: np.zeros(N) for k in (
        "p_ratio", "p_c_m0", "p_w_prev",
        "c_on", "c_ratio", "c_c_m0", "c_w_hist", "c_w_new",
    )}
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(N):
            # ---- predictor: sig[i] -> sig[i+1]
            s0, t = sig[i], sig[i + 1]
            alpha_t = 1.0 - t
            h = lam[i + 1] - lam[i]
            phi1, B_h, _, _ = phi_weights(h)
            out["p_ratio"][i] = t / s0
            out["p_c_m0"][i] = -alpha_t * phi1
            if pred_order[i] == 2:
                r0 = (lam[i - 1] - lam[i]) / h
                out["p_w_prev"][i] = -alpha_t * B_h * 0.5 / r0
            # ---- corrector for the sample at sig[i], base sig[i-1]
            if corr_order[i] >= 1:
                s0c, tc = sig[i - 1], sig[i]
                alpha_tc = 1.0 - tc
                hc = lam[i] - lam[i - 1]
                phi1c, B_hc, b1, b2 = phi_weights(hc)
                out["c_on"][i] = 1.0
                out["c_ratio"][i] = tc / s0c
                out["c_c_m0"][i] = -alpha_tc * phi1c
                if corr_order[i] == 2:
                    r0c = (lam[i - 2] - lam[i - 1]) / hc
                    # solve [[1, 1], [r0c, 1]] @ [rc0, rc1] = [b1, b2]
                    rc0 = (b1 - b2) / (1.0 - r0c)
                    rc1 = b1 - rc0
                    out["c_w_hist"][i] = -alpha_tc * B_hc * rc0 / r0c
                    out["c_w_new"][i] = -alpha_tc * B_hc * rc1
                else:
                    out["c_w_new"][i] = -alpha_tc * B_hc * 0.5
    assert all(np.isfinite(v).all() for v in out.values())
    return {k: v.astype(np.float32) for k, v in out.items()}


def unipc_loop(velocity: Callable, latents: torch.Tensor, num_steps: int, shift: float,
               reimpose: Optional[Callable] = None) -> torch.Tensor:
    """Integrate dz/dsigma = velocity(z, sigma) from sigma=1 to 0 with UniPC.

    ``velocity(lat, sig) -> v`` (``sig`` a 0-d f32 tensor) is evaluated once
    per step; ``reimpose`` is the optional TI2V first-frame clamp applied
    after every sub-update.
    """
    if reimpose is None:
        def reimpose(lat):
            return lat
    sigmas = shifted_sigmas(num_steps, shift, device=latents.device)
    table = _unipc_coeffs(num_steps, shift)
    C = {k: torch.from_numpy(v).to(latents.device) for k, v in table.items()}

    x, last_x = latents, latents
    m0, m1 = torch.zeros_like(latents), torch.zeros_like(latents)
    for i in range(num_steps):
        sig = sigmas[i]
        # x0 prediction at the (uncorrected) current sample: this one model
        # evaluation feeds both the corrector of step i and the predictor
        # toward step i+1 (UniPC's "free" corrector)
        m_t = x - sig * velocity(x, sig)
        if table["c_on"][i] > 0:
            # corrector: re-derive the sample at sigma[i] from the previous
            # corrected sample using the fresh x0 information
            x = reimpose(
                C["c_ratio"][i] * last_x
                + C["c_c_m0"][i] * m0
                + C["c_w_hist"][i] * (m1 - m0)
                + C["c_w_new"][i] * (m_t - m0)
            )
        # predictor: multistep update to sigma[i+1]
        x_p = (
            C["p_ratio"][i] * x
            + C["p_c_m0"][i] * m_t
            + C["p_w_prev"][i] * (m0 - m_t)
        )
        x, last_x, m0, m1 = reimpose(x_p), x, m_t, m0
    return x


@torch.no_grad()
def wan_denoise_loop(
    model: WanTransformer,
    context: torch.Tensor,
    null_context: torch.Tensor,
    latent_shape: Tuple[int, ...],
    num_steps: int = 50,
    guidance_scale: float = 5.0,
    image_latent: Optional[torch.Tensor] = None,
    ti2v: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    solver: str = "unipc",
    generator: Optional[torch.Generator] = None,
    latents: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Run the denoise loop on the model's device. latent_shape:
    (B, C, F, H, W). Returns the final f32 latents.

    The initial latents are drawn from ``generator`` (on the model's device)
    unless ``latents`` is given; with ``ti2v`` and an ``image_latent``
    (B, C, 1, H, W) the first frame is that latent throughout.
    """
    if solver not in ("euler", "heun", "unipc"):
        raise ValueError(f"unknown solver {solver!r}")
    cfg = model.cfg
    device = next(model.parameters()).device
    B, _, F, H, W = latent_shape
    if latents is None:
        latents = torch.randn(latent_shape, generator=generator, device=device,
                              dtype=torch.float32)
    latents = latents.to(device=device, dtype=torch.float32)
    clamp = ti2v and image_latent is not None
    if clamp:
        image_latent = image_latent.to(device=device, dtype=torch.float32)

    def reimpose(lat):
        if clamp:
            lat = torch.cat([image_latent, lat[:, :, 1:]], dim=2)
        return lat

    latents = reimpose(latents)
    ctx = torch.cat([null_context, context], dim=0).to(device)

    def velocity(lat, sig):
        # invert sigma -> timestep: sigma = shift*s/(1+(shift-1)s)
        s = sig / (cfg.shift - (cfg.shift - 1) * sig)
        t_b = (s * cfg.num_train_timesteps).expand(2 * B)
        t_tok = ti2v_timestep_tokens(t_b, (F, H, W), cfg.patch_size) if ti2v else t_b
        v = wan_forward(model, torch.cat([lat, lat], dim=0), t_tok, ctx,
                        compute_dtype=compute_dtype, attn_impl=attn_impl)
        v_uncond, v_text = v.chunk(2, dim=0)
        return v_uncond + guidance_scale * (v_text - v_uncond)

    if solver == "unipc":
        return unipc_loop(velocity, latents, num_steps, cfg.shift, reimpose)

    sigmas = shifted_sigmas(num_steps, cfg.shift, device=device)
    lat = latents
    for i in range(num_steps):
        sig, sig_next = sigmas[i], sigmas[i + 1]
        dt = sig_next - sig
        # flow ODE: dz/dsigma = v  (z = (1-s) z0 + s eps, v = eps - z0)
        v1 = velocity(lat, sig)
        x_e = reimpose(lat + dt * v1)
        if solver == "euler" or i == num_steps - 1:
            # Heun's final step (sigma_next == 0) stays Euler by convention
            lat = x_e
        else:
            v2 = velocity(x_e, sig_next)
            lat = reimpose(lat + dt * 0.5 * (v1 + v2))
    return lat


@torch.no_grad()
def sample_ti2v(
    model: WanTransformer,
    vae: WanVAE,
    context: torch.Tensor,
    null_context: torch.Tensor,
    cfg: WanConfig,
    image: Optional[torch.Tensor] = None,
    num_frames: int = 81,
    height: int = 704,
    width: int = 1280,
    num_steps: int = 50,
    guidance_scale: float = 5.0,
    attn_impl: str = "auto",
    compute_dtype: torch.dtype = torch.bfloat16,
    solver: str = "unipc",
    generator: Optional[torch.Generator] = None,
    image_noise: Optional[torch.Tensor] = None,
    latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Text(+image)-to-video. ``image``: (B, 3, H, W) in [-1, 1], or None
    (T2V). Returns the decoded video (B, 3, T, H, W) in [-1, 1], f32.

    The image latent is the VAE's posterior sample (``image_noise``, or a
    draw from ``generator``); the denoise loop's initial latents are
    ``latents`` or the generator's next draw (the JAX package splits one key
    into the two draws)."""
    B = context.shape[0]
    st, sh, sw = cfg.vae_stride
    shape = (B, cfg.vae_z_dim, (num_frames - 1) // st + 1, height // sh, width // sw)
    image_latent = None
    if image is not None:
        image_latent = wan_vae_encode(vae, image[:, :, None], cfg, generator=generator,
                                      noise=image_noise, sample=True)
    lat = wan_denoise_loop(model, context, null_context, shape, num_steps=num_steps,
                           guidance_scale=guidance_scale, image_latent=image_latent,
                           ti2v=image is not None, compute_dtype=compute_dtype, solver=solver,
                           generator=generator, latents=latents, attn_impl=attn_impl)
    return wan_vae_decode(vae, lat, cfg).clamp_(-1.0, 1.0)
