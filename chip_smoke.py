#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``videogpa_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             into build/kernels/, one nvcc process per source, all at once.
2. parity  — each kernel against its plain PyTorch version on the card, at
             the shapes the main paths give it and at edge cases (ragged and
             cross lengths, every supported head dim, extreme logits,
             strided views, B*H past CUDA's grid y limit for every attention
             kernel):
             K1 forward (the DiT's and the VGGT global blocks' shapes) and
             K3 backward (and ``attention()`` autograd on CUDA yielding K3's
             gradients); K4 short-row attention (n_valid mask with NaN in
             the masked rows, the VGGT frame shape); K6 in f32 (camera head,
             the f32 scorer's frame and global rows) and bf16 (the Wan
             shapes); K7 (the Wan shapes);
             K5 scatter-min bit for bit on a real packed z-buffer stream,
             sentinel-only, one-slot and random streams.
3. slice   — the tiny CogVideoX DiT, and one tiny DPO train step, on the
             card in bf16 against the same weights on the CPU in f32; the
             tiny VGGT scorer through ``process_frames_batch``, f32 on both;
             a small VGGT in the scorer's dtypes (bf16 trunk, f32 camera
             head) against f32 on the CPU, its blocks through K4 and K1;
             a small Wan DiT at head_dim 128 in bf16 against f32 on the CPU:
             3 UniPC steps with the TI2V first frame, and one DPO step.
4. main    — the CogVideoX-5B denoise path at full width and depth (42
             layers, hidden 3072, 48 heads x 64) on random bf16 weights:
             2 requests, each a CFG pair at 49f@480x720 (latents
             13x16x60x90, 17,550 video + 226 text tokens) with seeded
             stand-in T5 embeddings, 2 DPM steps each. Checks finite output
             and that every attention of the path launched K1 (and no
             other kernel).
   profile — device time by kernel group over one more (profiled) step.
5. train   — the CogVideoX-5B Diffusion-DPO LoRA train step at full width
             and depth with the CogVideoX-5B recipe (batch 1, accumulate 2,
             LoRA r 64 / alpha 128, remat) on a synthetic preference dataset
             of full-size latents written to a temporary directory: 4
             mini-steps, so 2 optimiser updates. Checks finite metrics, LoRA
             B off zero after the second update, the kernels' launch counts,
             and a checkpoint save/restore round trip.
   profile — device time by kernel group over one more (profiled) mini-step.
6. scorer  — the VGGT-1B reward scorer at full width (DINOv2 ViT-L/14, 24 +
             24 aggregator blocks, f32 camera head, DPT heads, LPIPS VGG16)
             on random weights: 3 batches (1 cold, 2 warm) of K = 4 clips x
             10 frames x 518^2 synthetic uint8 frames through
             ``VideoProcessor.process_frames_batch``, packed z-buffer. Checks
             finite scores and the launches per batch (K1 24, K4 48, K6 16,
             K5 4).
   profile — device time by kernel group over one more (profiled) batch.
   wan     — the Wan2.2-TI2V-5B denoise path at full width and depth (30
             layers, dim 3072, 24 heads x 128, text 512 x 4096) on random bf16
             weights: 2 requests, each a CFG pair at 81f@704x1280 (latents
             48x21x44x80, 18,480 tokens) with a synthetic image latent as the
             clean first frame, 3 UniPC steps each. Checks finite output, the
             kept first frame, and that every attention launched K6 (30 self
             + 30 cross per forward) and no other kernel.
   wan-train — the Wan2.2-TI2V-5B DPO LoRA train step with its recipe
             (batch 1, accumulate 2, LoRA r 64 / alpha 128, remat) on a
             synthetic preference set with image latents: 4 mini-steps, 2
             updates. Checks finite metrics, LoRA B off zero after the second
             update, and the launches of K6 (forward, with LSE under grad)
             and K7 (backward).
   profile — one more (profiled) Wan step and Wan mini-step.
   int8    — the int8 inference mode (W8A8 linears from ``ops.quant`` and
             ``attn_impl="flash_int8"``). parity: K8 and K9 against their plain
             version on the same quantised operands at the DiT, VGGT-global
             and Wan shapes and at edge cases (B*H = 66,000 among them);
             quantise + kernel against exact
             f32 attention; ``quantize_qk_int8``, ``linear_w8a8`` and
             ``int8_matmul`` on the card against the CPU. slice: the tiny DiT,
             the tiny scorer and a small bf16 VGGT in int8 mode on the card
             against the same mode on the CPU. main paths at full width:
             CogVideoX-5B (2 requests x 2 DPM steps, K8 168 launches, against
             the exact run's latents), the VGGT-1B scorer (3 batches; a batch
             launches K8 24, K4 48, K6 f32 16, K5 4; drift of each score
             against the exact scorer) and Wan2.2-TI2V-5B (1 request x 3
             UniPC steps; head_dim 128 stays on K6). One profiled int8 denoise
             step and scorer batch.
   slice-sampling — the tiny VAE and a small one (channels 32-128, 2
             resnets a block) with the generator's bf16 weights and f32
             activations: encode with injected posterior noise, decode,
             tiled decode and tiled encode; a small T5 with shared and with
             per-layer bias, one prompt padded; each on the card against the
             CPU on the same weights.
   sample  — the sampling path at full width with [main]'s CogVideoX-5B
             DiT: T5-v1.1-XXL (f32) encodes 2 x 226 ids; ``sample_t2v``
             runs 2 DPM steps at 49f@480x720 and ``decode_latents`` decodes
             the (1, 13, 16, 60, 90) latents through the bf16 VAE with the
             DiT, T5 and VAE resident; ``video_to_uint8``. Prints T5 ms,
             step ms, decode ms and the tile it settled on, peak GB and K1's
             launches (42 a step; T5 and the VAE launch none); one profiled
             decode tile; which operations take a tensor above 2^31
             elements. Then ``sample_i2v`` with the CogVideoX-5B-I2V DiT
             (VAE encode of one 480x720 frame, 2 DPM steps, decode).
   parity_headdim — ``attention()`` at head dims 8, 40, 80 and 96 (zero-
             padded to the next kernel width with the original scale): bf16
             forward on long and short rows and autograd, f32 forward and
             autograd, ``impl="flash_int8"`` at 40 and 80; at 160 (padded to
             192), 256 and 512 in bf16 and f32: forward, autograd and
             ``impl="flash_int8"`` (the exact route, bit for bit, no int8
             launch) through ``flash_attn_fwd_wide`` / ``flash_attn_bwd_wide``;
             the int8 route with f32 operands at 40, 64 and 96 through
             ``flash_attn_int8_f32``, also against exact attention; each
             against the plain version; the launch counters show K1, K3, K4,
             K6 (bf16 and f32), K7, K8, K9, the f32 backward and the three new
             entries ran.
   parity_f32_bwd — the CUDA-core backward against its plain version:
             ``flash_attn_bwd_f32`` at the camera head, the frame rows, one
             long row and B*H = 66,000, ``flash_attn_bwd_wide`` at (1, 4,096,
             16, 256) in f32 and bf16, and edge cases (cross and ragged
             lengths, head dims 16-512, both layouts, strided views, operands
             off 16-byte alignment, more key tiles than the grid's CTAs);
             two runs bit-equal at every shape; ``attention()`` autograd in
             f32; its ms beside its bound and SDPA's backward in the same
             dtype.
   score_files — random VGGT-1B weights written in the upstream key layout
             as safetensors and read by ``load_vggt`` (same outputs as the
             module written); ``cli.score.main`` on 3 groups x 4 clips of 10
             frames at 518^2 at batch 4, batch 1 (async) and ``--int8``,
             frames from memory (the machine has no video decoder); scores
             against ``process_frames_batch``, a resumed run, the per-metric
             path against the fused one on 2 clips.
   train_files — pair metadata from [score_files]'s JSON with 49f@480x720
             latents and T5 embeddings as .npz; ``run_recipe("CogVideoX-5B")``
             for 2 steps with validation and a checkpoint, then a resume to
             step 3; the exported PEFT LoRA against the last checkpoint.
   slice_wan_vae — a small Wan VAE (z 48, bases 32 / 48) in f32 on the
             card against the CPU: encode (mean, and a sample with injected
             noise) and decode at T = 1 and 9, streaming and full-sequence.
   wan_sample — ``sample_ti2v`` at full width and depth with [wan]'s DiT:
             umT5-XXL (f32) encodes 2 x 512 ids, the Wan VAE (f32) encodes a
             704 x 1,280 image, 3 UniPC steps, the streamed decode of 81
             frames; prints umT5, image-encode, step and decode ms, the
             decode's TFLOP/s, peak GB and the launches (K6 bf16 180, every
             other kernel 0).
   encode_files — ``cli.encode_wan.run`` (umT5 + Wan VAE, one group: image
             and an 81-frame 704 x 1,280 clip) and ``cli.encode.run`` (T5-XXL
             + CogVideoX VAE in f32, one group: image and a 49-frame 480 x 720
             clip), frames from memory; artifacts, ms and peak GB.
   wan_train_files — .npz latents (48, 21, 44, 80) with umT5 conditions and
             image latents; ``run_recipe("Wan2.2-TI2V-5B")`` with [wan]'s DiT
             for 2 steps with validation, a resume to step 3, the exported
             PEFT LoRA read back.
7. timing  — ms per denoise step, train mini-step and scorer batch; each
             kernel's ms at its main-path shape beside its bound, its plain
             version and one PyTorch call computing the same function; for
             the wgmma kernels K1 (also at the train shape with LSE and the
             VGGT global shape), K3, K4, K6 (bf16, without and with LSE in
             turns), K7, K8 and K9 also the achieved TFLOP/s, the registers a
             thread and the shared memory a CTA; K8 and K9 in turns with the
             exact kernel at the same shape (K1, K6 bf16); for K6 f32 its
             device time a call beside its time a call at the camera head,
             and its time at the f32 scorer's frame and global rows;
             ``flash_attn_fwd_wide`` at (1, 4,096, 16, 256) in f32 and bf16
             and ``flash_attn_int8_f32`` at the f32 scorer's global rows,
             each against its plain version, beside its bound and SDPA.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM dense peaks (NVIDIA data sheet), the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

# bf16 output: rtol covers one bf16 ulp (<= 2^-7 relative) at any magnitude;
# atol only absorbs f32 summation-order noise near zero, so it scales with the
# reference's RMS (about sqrt(e/N) for unit logits, 0.012 at the DiT's 17,776
# keys) and is capped at 1e-2 for cases whose |O| is of order 1
O_ATOL_RMS_FRAC, O_ATOL_MAX, O_RTOL = 0.05, 1e-2, 1e-2
LSE_ATOL, LSE_RTOL = 1e-3, 1e-5  # f32 logsumexp of identical bf16 scores
# bf16 gradients of K3 against the plain version (same O, LSE and dO): both
# round P and dS to bf16 at the same points, so the differences are f32
# summation order plus the final bf16 rounding (rtol, one ulp); atol absorbs
# order noise near zero and scales with the reference's RMS, which also
# covers the near-cancelling dS of one-hot P (q x 1e3)
GRAD_ATOL_RMS_FRAC, GRAD_RTOL = 0.05, 1e-2
# extreme logits (q x 1e3): near-tied logits give large dS values whose bf16
# rounding flips between the kernel and a bf16 plain version; that case is
# held against the plain version in f32 (no rounding of P or dS) by the
# RMS of the error over the RMS of the reference
EXTREME_REL_RMS = 2e-2
# tiny DPO step, bf16 on the card against f32 on the CPU: relative norm
# error of each LoRA gradient, and the loss within 1e-2 (bf16 carries ~3
# significant digits through two DiT forwards and one backward)
DPO_GRAD_REL, DPO_LOSS_ATOL = 5e-2, 1e-2


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    raise SystemExit(1)


# every line also goes to build/chip_smoke.log beside this script (the
# directory the kernels are built into, which .gitignore lists): a caller that
# keeps only the end of the output still finds the whole run there
_LOG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke.log")


def log(msg: str) -> None:
    print(msg, flush=True)
    os.makedirs(os.path.dirname(_LOG_PATH), exist_ok=True)
    with open(_LOG_PATH, "a") as f:
        f.write(msg + "\n")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wrappers():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from videogpa_torch.geometry.zbuffer_kernel import scatter_min_u32
    from videogpa_torch.ops.attention import (
        flash_attn_bwd, flash_attn_bwd_d128, flash_attn_bwd_f32, flash_attn_bwd_wide,
        flash_attn_fwd, flash_attn_fwd_d128, flash_attn_fwd_f32, flash_attn_fwd_wide,
        flash_attn_int8, flash_attn_int8_d128, flash_attn_int8_f32, flash_attn_short)

    return {f.__name__: f for f in (flash_attn_fwd, flash_attn_bwd, flash_attn_short,
                                    flash_attn_fwd_f32, flash_attn_fwd_d128,
                                    flash_attn_bwd_d128, scatter_min_u32,
                                    flash_attn_int8, flash_attn_int8_d128,
                                    flash_attn_bwd_f32, flash_attn_fwd_wide,
                                    flash_attn_bwd_wide, flash_attn_int8_f32)}


def zero_launches() -> None:
    for f in _wrappers().values():
        f.launches = 0


def read_launches() -> dict:
    return {name: f.launches for name, f in _wrappers().items()}


def phase_build() -> None:
    from videogpa_torch.ops import _kernels

    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"[build] {len(_kernels.SOURCES)} source(s), {len(logs)} compiled in "
        f"{time.perf_counter() - t0:.1f} s -> {_kernels.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "Performance",
                                       "warning")):
                log(f"[build] {name}: {line.strip()}")


def _attn_case(gen, B, Nq, Nk, H, D, layout, q_scale=1.0):
    import torch

    def rnd(n):
        shape = (B, n, H, D) if layout == "bnhd" else (B, H, n, D)
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q = (rnd(Nq).float() * q_scale).to(torch.bfloat16)
    return q, rnd(Nk), rnd(Nk)


def _check(o, lse, ro, rl):
    """(max |dO|, O's atol, max |dLSE|, whether both are within tolerance and finite)."""
    import torch

    ro = ro.float()
    o_atol = min(O_ATOL_MAX, O_ATOL_RMS_FRAC * ro.square().mean().sqrt().item())
    d_o, d_lse = (o.float() - ro).abs(), (lse - rl).abs()
    ok = bool((d_o <= o_atol + O_RTOL * ro.abs()).all()
              and (d_lse <= LSE_ATOL + LSE_RTOL * rl.abs()).all()
              and torch.isfinite(o).all() and torch.isfinite(lse).all())
    return d_o.max().item(), o_atol, d_lse.max().item(), ok


def phase_parity(dit_shape, vggt_global_shape):
    """K1 vs its plain version; returns (max O error, plain ms at the DiT shape)."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_fwd, flash_attn_fwd_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    packed = torch.randn(1, 640, 3, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    cases = [
        ("ragged N=300 bnhd D=64", "bnhd", _attn_case(gen, 2, 300, 300, 4, 64, "bnhd")),
        ("cross Nq=300 Nk=777 bhnd D=64", "bhnd", _attn_case(gen, 1, 300, 777, 3, 64, "bhnd")),
        ("cross Nq=1000 Nk=37 bnhd D=64", "bnhd", _attn_case(gen, 1, 1000, 37, 2, 64, "bnhd")),
        ("D=16 N=517 bnhd", "bnhd", _attn_case(gen, 2, 517, 517, 2, 16, "bnhd")),
        ("D=32 N=517 bhnd", "bhnd", _attn_case(gen, 2, 517, 517, 2, 32, "bhnd")),
        # extreme logits (q x 1e3): the exactness case the TPU's stall fallback
        # (_fwd_kernel_T_stall) exists for; softmax is near one-hot here
        ("extreme logits q*1e3 N=300 D=64", "bnhd",
         _attn_case(gen, 1, 300, 300, 2, 64, "bnhd", q_scale=1e3)),
        # strided operands: views of one packed (B, N, 3, H, D) tensor, no copy
        ("strided views of packed qkv N=640", "bnhd", packed.unbind(2)),
        # past CUDA's grid y limit of 65,535: K1's persistent grid takes any B*H
        ("B*H = 2 x 33,000 = 66,000 N=40 bnhd D=64", "bnhd",
         _attn_case(gen, 2, 40, 40, 33000, 64, "bnhd")),
    ]
    errs = []
    for name, layout, (q, k, v) in cases:
        o, lse = flash_attn_fwd(q, k, v, layout=layout, with_lse=True)
        o_err, o_atol, lse_err, ok = _check(
            o, lse, *flash_attn_fwd_reference(q, k, v, layout=layout, with_lse=True))
        log(f"[parity] {name}: max|dO| {o_err:.3e} (atol {o_atol:.2e} + rtol {O_RTOL}), "
            f"max|dLSE| {lse_err:.3e} (atol {LSE_ATOL} + rtol {LSE_RTOL}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attn_fwd disagrees with its plain version on {name}")
        errs.append(o_err)
    del cases, packed

    # the main paths' shapes at full size: the DiT's, and the VGGT global
    # blocks' (13,740 keys: another ragged last tile and B*H grid), there with
    # q and k as the QK-norm/RoPE outputs and v a view of the qkv projection
    B, N, H, D = dit_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    worst, plain_ms = _parity_full(f"DiT shape {dit_shape}", q, k, v)
    errs.append(worst)
    del q, k, v
    B, N, H, D = vggt_global_shape
    q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    worst, _ = _parity_full(f"VGGT global shape {vggt_global_shape} (v a strided view)",
                            q.contiguous(), k.contiguous(), v)
    errs.append(worst)
    del q, k, v
    torch.cuda.empty_cache()
    return max(errs), plain_ms


def _parity_full(label, q, k, v, chunk: int = 4):
    """K1 against its plain version on a full-size bnhd problem; the plain
    version needs a (N, N) f32 score matrix per head, so it runs over chunks
    of ``chunk`` heads covering every head. Returns (max |dO|, plain ms summed
    over the chunks)."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_fwd, flash_attn_fwd_reference

    B, _, H, _ = q.shape
    o, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain_ms = 0.0
    worst_o = worst_lse = 0.0
    atols = []
    for b in range(B):
        for h in range(0, H, chunk):
            sl = (slice(b, b + 1), slice(None), slice(h, h + chunk))
            start.record()
            ro, rl = flash_attn_fwd_reference(q[sl], k[sl], v[sl], layout="bnhd", with_lse=True)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            o_err, o_atol, lse_err, ok = _check(o[sl], lse[b:b + 1, h:h + chunk], ro, rl)
            atols.append(o_atol)
            worst_o, worst_lse = max(worst_o, o_err), max(worst_lse, lse_err)
            if not ok:
                fail(f"flash_attn_fwd disagrees at the {label}, batch {b}, heads {h}..")
            del ro, rl
    log(f"[parity] {label} bnhd, all {B * H} heads in chunks of {chunk}: "
        f"max|dO| {worst_o:.3e} (atol {min(atols):.2e}..{max(atols):.2e} + rtol {O_RTOL}), "
        f"max|dLSE| {worst_lse:.3e} ok; plain version {plain_ms:.1f} ms over the chunks")
    return worst_o, plain_ms


def phase_slice() -> None:
    """Tiny CogVideoX DiT: the card in bf16 against the CPU in f32."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_forward, dit_init

    cfg = CogVideoXConfig.tiny()
    ref = dit_init(cfg, torch.Generator().manual_seed(2), device="cpu").requires_grad_(False)
    dev = dit_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                    cfg.sample_width, generator=gen)
    txt = torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)
    t = torch.tensor([100, 900])
    want = dit_forward(ref, x, txt, t, compute_dtype=torch.float32, attn_layout="bnhd")
    got = dit_forward(dev, x.cuda(), txt.cuda(), t.cuda(), attn_layout="bnhd").cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[slice] tiny DiT bf16 on the card vs f32 on the CPU: max|d|/max|ref| {rel:.3e} "
        f"(limit 5e-2)")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        fail("tiny DiT on the card disagrees with the CPU reference")


def phase_main(num_requests: int = 2, steps: int = 2):
    import torch

    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, SamplerSettings, denoise_loop, dit_init)

    cfg = CogVideoXConfig.cogvideox_5b()
    t0 = time.perf_counter()
    dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                   dtype=torch.bfloat16).requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"[main] CogVideoX-5B DiT: {cfg.num_layers} layers (no depth cut), hidden "
        f"{cfg.hidden_dim}, {cfg.num_heads}x{cfg.head_dim} heads, {n_params / 1e9:.3f} B "
        f"params in bf16 on the card in {time.perf_counter() - t0:.1f} s")

    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm")
    latent_shape = (1, cfg.sample_frames, cfg.vae_latent_channels,
                    cfg.sample_height, cfg.sample_width)
    torch.cuda.reset_peak_memory_stats()
    request_s, latents = [], []
    zero_launches()
    for r in range(num_requests):
        gen = torch.Generator(device="cuda").manual_seed(100 + r)
        text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim,
                           generator=gen, device="cuda")
        negative = torch.randn(text.shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = denoise_loop(dit, text, negative, settings, latent_shape, generator=gen)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        if tuple(lat.shape) != latent_shape or not bool(torch.isfinite(lat).all()):
            fail(f"request {r}: latents {tuple(lat.shape)} not finite or wrong shape")
        log(f"[main] request {r}: {steps} DPM steps in {request_s[-1]:.3f} s, latents "
            f"{tuple(lat.shape)} finite, std {lat.float().std().item():.4f}")
        latents.append(lat.float().cpu())
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = num_requests * steps * cfg.num_layers
    want = {name: expected if name == "flash_attn_fwd" else 0 for name in launches}
    log(f"[main] launches {json.dumps(launches)}; expected flash_attn_fwd {num_requests} "
        f"requests x {steps} steps x {cfg.num_layers} layers = {expected}, every other 0")
    if launches != want:
        fail("the denoise path did not run every attention through the forward kernel alone")
    settings1 = SamplerSettings(num_inference_steps=1, sampler="dpm")
    profile = profile_device_time("one denoise step (profiled)", lambda: denoise_loop(
        dit, text, negative, settings1, latent_shape,
        generator=torch.Generator(device="cuda").manual_seed(5)))
    return {
        "dit": dit,  # the [sample] phase reuses it, then frees it
        "launches": launches, "request_s": request_s,
        "step_ms": [1e3 * s / steps for s in request_s], "peak_gb": peak_gb,
        "launches_per_step": expected // (num_requests * steps), "profile": profile,
        "latents": latents,
    }


def _kernel_group(name: str) -> str:
    if "flash_attn_int8_kernel<128>" in name:
        return "K9 flash_attn_int8_d128"
    if "flash_attn_int8_kernel" in name:
        return "K8 flash_attn_int8"
    if "attn_f32_kernel" in name:
        return "K6 flash_attn_fwd_f32"
    if "flash_attn_fwd_d128" in name:
        return "K6 flash_attn_fwd_d128"
    if "flash_attn_fwd_kernel" in name:
        return "K1 flash_attn_fwd"
    if "flash_attn_bwd_d128" in name:
        return "K7 flash_attn_bwd_d128"
    if "flash_attn_bwd" in name:
        return "K3 flash_attn_bwd"
    if "flash_attn_short" in name:
        return "K4 flash_attn_short"
    if "scatter_min_kernel" in name:
        return "K5 scatter_min_u32"
    low = name.lower()
    if any(tag in low for tag in ("conv", "fprop", "dgrad", "wgrad", "cudnn")):
        return "cudnn conv"
    if any(tag in low for tag in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "gemm"
    return "other"


def profile_device_time(label: str, run):
    """Device time by kernel group over one call of ``run`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    if busy_ms == 0.0:
        log(f"[profile] {label}: the profiler recorded no device time: breakdown not measured")
        return None
    groups = {}
    for name, ms in by_kernel.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "groups_ms": groups, "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    log(f"[profile] {label}: " + json.dumps(out))
    return out


def _grad_check(got, want):
    """(max |d|, atol, ok) of one bf16 gradient against the plain version."""
    import torch

    want = want.float()
    atol = GRAD_ATOL_RMS_FRAC * want.square().mean().sqrt().item()
    d = (got.float() - want).abs()
    ok = bool((d <= atol + GRAD_RTOL * want.abs()).all() and torch.isfinite(got).all())
    return d.max().item(), atol, ok


def _rel_rms_check(got, want):
    """(max |d|, RMS(d) / RMS(want), ok) against an f32 reference."""
    import torch

    d = got.float() - want
    rel = (d.square().mean().sqrt() / want.square().mean().sqrt()).item()
    return d.abs().max().item(), rel, bool(rel <= EXTREME_REL_RMS and torch.isfinite(got).all())


def _bwd_cases(tag, fwd, bwd, cases, gen):
    """A backward kernel ``bwd`` (on the O and LSE of ``fwd``) against the
    plain version on small cases; returns the element-wise errors."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_bwd_reference

    errs = []
    for name, layout, (q, k, v) in cases:
        extreme = name.startswith("extreme")
        o, lse = fwd(q, k, v, layout=layout, with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
        got = bwd(q, k, v, o, lse, do, layout=layout)
        ops = [q, k, v, o, do]
        if extreme:
            ops = [x.float() for x in ops]
        want = flash_attn_bwd_reference(*ops[:4], lse, ops[4], layout=layout)
        parts = []
        for gname, g, w in zip(("dQ", "dK", "dV"), got, want):
            if extreme:  # |dK| ~ 1e3 here: judged by its RMS ratio, not in max_abs_err
                err, rel, ok = _rel_rms_check(g, w)
                parts.append(f"max|{gname}| {err:.3e} (RMS ratio {rel:.2e})")
            else:
                err, atol, ok = _grad_check(g, w)
                parts.append(f"max|{gname}| {err:.3e} (atol {atol:.2e})")
                errs.append(err)
            if not ok:
                log(f"[parity] {tag} {name}: " + ", ".join(parts) + " MISMATCH")
                fail(f"{bwd.__name__} {gname} disagrees with its plain version on {name}")
        limit = (f"vs the f32 plain version, RMS ratio limit {EXTREME_REL_RMS}" if extreme
                 else f"+ rtol {GRAD_RTOL}")
        log(f"[parity] {tag} {name}: " + ", ".join(parts) + f" {limit} ok")
    return errs


def _autograd_check(tag, fwd, bwd, qkv, gen, atomic_dq=False):
    """attention() on CUDA tensors that require grad: the autograd Function
    runs ``fwd`` with LSE and ``bwd``, bit for bit the direct calls. With
    ``atomic_dq`` (K3, K7: dQ summed over key tiles by f32 reduce-adds, whose
    last bits vary from run to run) dQ is held to the direct call's by the
    gradient tolerance of the parity cases, dK and dV still bit for bit."""
    import torch

    from videogpa_torch.ops.attention import attention

    q, k, v = (x.requires_grad_(True) for x in qkv)
    fwd0, bwd0 = fwd.launches, bwd.launches
    o = attention(q, k, v, layout="bnhd")
    if type(o.grad_fn).__name__ != "_FlashAttentionBackward":
        fail(f"attention() on CUDA tensors that require grad has grad_fn {o.grad_fn}")
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o.backward(do)
    with torch.no_grad():
        o2, lse = fwd(q, k, v, layout="bnhd", with_lse=True)
        direct = bwd(q, k, v, o2, lse, do, layout="bnhd")
    same = all(torch.equal(x.grad, d) for x, d in zip((q, k, v), direct))
    note = ""
    if atomic_dq:
        dq_err, dq_atol, dq_ok = _grad_check(q.grad, direct[0])
        same = dq_ok and all(torch.equal(x.grad, d) for x, d in zip((k, v), direct[1:]))
        note = (f" (dK, dV bit for bit; dQ max|d| {dq_err:.3e}, atol {dq_atol:.2e} + rtol "
                f"{GRAD_RTOL}: f32 reduce-adds)")
    counted = (fwd.launches - fwd0, bwd.launches - bwd0) == (2, 2)
    log(f"[parity] attention() autograd on CUDA at D = {q.shape[-1]}: grad_fn "
        f"_FlashAttentionBackward, q/k/v grads equal to direct {bwd.__name__}: {same}{note}, "
        f"launches counted: {counted}")
    if not (same and counted and torch.equal(o.detach(), o2)):
        fail(f"attention() autograd on CUDA did not yield {tag}'s gradients")


def _bwd_full(tag, label, fwd, bwd, q, k, v, layout, gen, chunk=4):
    """A backward kernel against its plain version on a full-size problem; the
    plain version needs (Nq, Nk) f32 score matrices per head, so it runs over
    chunks of ``chunk`` heads covering every head. Returns ([max |dQ|, |dK|,
    |dV|], plain ms summed over the chunks)."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_bwd_reference

    B, H = (q.shape[0], q.shape[2]) if layout == "bnhd" else q.shape[:2]
    o, lse = fwd(q, k, v, layout=layout, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    grads = bwd(q, k, v, o, lse, do, layout=layout)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain_ms, worst, atols = 0.0, [0.0, 0.0, 0.0], []
    for b in range(B):
        for h in range(0, H, chunk):
            heads = slice(h, h + chunk)
            sl = ((slice(b, b + 1), slice(None), heads) if layout == "bnhd"
                  else (slice(b, b + 1), heads))
            start.record()
            want = flash_attn_bwd_reference(q[sl], k[sl], v[sl], o[sl],
                                            lse[b:b + 1, heads].contiguous(), do[sl],
                                            layout=layout)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            for i, (g, w) in enumerate(zip(grads, want)):
                err, atol, ok = _grad_check(g[sl], w)
                worst[i] = max(worst[i], err)
                atols.append(atol)
                if not ok:
                    fail(f"{bwd.__name__} disagrees at the {label}, batch {b}, "
                         f"heads {h}.., gradient {'QKV'[i]}")
            del want
    log(f"[parity] {tag} {label} {layout}, all {B * H} heads in chunks of "
        f"{chunk}: max|dQ| {worst[0]:.3e}, max|dK| {worst[1]:.3e}, max|dV| {worst[2]:.3e} "
        f"(atol {min(atols):.2e}..{max(atols):.2e} + rtol {GRAD_RTOL}) ok; plain version "
        f"{plain_ms:.1f} ms over the chunks")
    return worst, plain_ms


def phase_parity_bwd(train_shape):
    """K3 against its plain version, and attention() autograd through it;
    returns (max gradient error over the element-wise cases, plain ms at
    the training shape)."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_bwd, flash_attn_fwd

    gen = torch.Generator(device="cuda").manual_seed(11)
    packed = torch.randn(1, 640, 3, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    cases = [
        ("ragged N=300 bnhd D=64", "bnhd", _attn_case(gen, 2, 300, 300, 4, 64, "bnhd")),
        ("cross Nq=300 Nk=777 bhnd D=64", "bhnd", _attn_case(gen, 1, 300, 777, 3, 64, "bhnd")),
        ("cross Nq=1000 Nk=37 bnhd D=64", "bnhd", _attn_case(gen, 1, 1000, 37, 2, 64, "bnhd")),
        ("D=16 N=517 bnhd", "bnhd", _attn_case(gen, 2, 517, 517, 2, 16, "bnhd")),
        ("D=32 N=517 bhnd", "bhnd", _attn_case(gen, 2, 517, 517, 2, 32, "bhnd")),
        # one-hot P: dS = P (dP - delta) cancels
        ("extreme logits q*1e3 N=300 D=64", "bnhd",
         _attn_case(gen, 1, 300, 300, 2, 64, "bnhd", q_scale=1e3)),
        ("strided views of packed qkv N=640", "bnhd", packed.unbind(2)),
        ("cross Nq=333 Nk=512, strided (B, H, N, D) views of projections", "bhnd",
         (_proj_views(gen, 2, 333, 3, 64), _proj_views(gen, 2, 512, 3, 64),
          _proj_views(gen, 2, 512, 3, 64))),
        # past CUDA's grid y limit of 65,535: K3's grid is flat
        ("B*H = 2 x 33,000 = 66,000 N=40 bnhd D=64", "bnhd",
         _attn_case(gen, 2, 40, 40, 33000, 64, "bnhd")),
    ]
    errs = _bwd_cases("K3", flash_attn_fwd, flash_attn_bwd, cases, gen)
    del cases, packed
    _autograd_check("K3", flash_attn_fwd, flash_attn_bwd,
                    _attn_case(gen, 1, 300, 300, 4, 64, "bnhd"), gen, atomic_dq=True)

    B, N, H, D = train_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    worst, plain_ms = _bwd_full("K3", f"training shape {train_shape}", flash_attn_fwd,
                                flash_attn_bwd, q, k, v, "bnhd", gen)
    errs.extend(worst)
    del q, k, v
    torch.cuda.empty_cache()
    return max(errs), plain_ms


def _proj_views(gen, B, N, H, D):
    """One attention operand as the Wan DiT feeds it: a (B, H, N, D) view of
    a (B, N, H*D) projection, strided in n and h with a contiguous last dim."""
    import torch

    y = torch.randn(B, N, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    return y.reshape(B, N, H, D).transpose(1, 2)


def phase_parity_bwd_d128(wan_shape, text_len):
    """K7 against its plain version at head_dim 128, attention() autograd
    through K6 and K7, and K6 with LSE at the shapes this path adds. Returns
    (max gradient error over the element-wise cases, plain ms at the Wan
    self-attention shape, plain ms at the cross shape, K6 max |dO| at the new
    shapes, K6 plain ms at the cross shape)."""
    import torch

    from videogpa_torch.ops.attention import (
        flash_attn_bwd_d128, flash_attn_fwd_d128, flash_attn_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(61)
    cases = [
        ("ragged N=300 bnhd D=128", "bnhd", _attn_case(gen, 2, 300, 300, 3, 128, "bnhd")),
        ("cross Nq=300 Nk=777 bhnd D=128", "bhnd", _attn_case(gen, 1, 300, 777, 2, 128, "bhnd")),
        ("ragged cross Nq=1000 Nk=37 bnhd D=128", "bnhd",
         _attn_case(gen, 1, 1000, 37, 2, 128, "bnhd")),
        ("cross Nq=333 Nk=512, strided (B, H, N, D) views of projections", "bhnd",
         (_proj_views(gen, 2, 333, 3, 128), _proj_views(gen, 2, 512, 3, 128),
          _proj_views(gen, 2, 512, 3, 128))),
        # one-hot P: dS = P (dP - delta) cancels
        ("extreme logits q*1e3 N=300 D=128", "bnhd",
         _attn_case(gen, 1, 300, 300, 2, 128, "bnhd", q_scale=1e3)),
        # past CUDA's grid y limit of 65,535: K7's grid is flat
        ("B*H = 2 x 33,000 = 66,000 N=24 bnhd D=128", "bnhd",
         _attn_case(gen, 2, 24, 24, 33000, 128, "bnhd")),
    ]
    errs = _bwd_cases("K7", flash_attn_fwd_d128, flash_attn_bwd_d128, cases, gen)
    del cases
    _autograd_check("K7", flash_attn_fwd_d128, flash_attn_bwd_d128,
                    _attn_case(gen, 1, 300, 300, 3, 128, "bnhd"), gen, atomic_dq=True)

    # the Wan self-attention shape at full size, operands as the DiT feeds them
    B, N, H, D = wan_shape
    q, k, v = (_proj_views(gen, B, N, H, D) for _ in range(3))
    worst, self_plain_ms = _bwd_full("K7", f"Wan self-attention shape {wan_shape} (strided "
                                     "views)", flash_attn_fwd_d128, flash_attn_bwd_d128,
                                     q, k, v, "bhnd", gen)
    errs.extend(worst)
    # the cross-attention shape: 512 text keys; one chunk holds all heads
    k, v = (_proj_views(gen, B, text_len, H, D) for _ in range(2))
    worst, cross_plain_ms = _bwd_full(
        "K7", f"Wan cross-attention shape Nq {N} x Nk {text_len} (strided views)",
        flash_attn_fwd_d128, flash_attn_bwd_d128, q, k, v, "bhnd", gen, chunk=H)
    errs.extend(worst)

    # K6 with LSE at the cross shape and at B = 2 (the CFG pair)
    k6_errs, k6_cross_plain_ms = [], None
    q2 = _proj_views(gen, 2, N, H, D)
    for label, qq, kk, vv in (
            (f"cross shape Nq {N} x Nk {text_len}", q, k, v),
            ("cross shape at B = 2 (CFG pair)", q2, _proj_views(gen, 2, text_len, H, D),
             _proj_views(gen, 2, text_len, H, D))):
        o, lse = flash_attn_fwd_d128(qq, kk, vv, layout="bhnd", with_lse=True)
        (ro, rl), ms = _timed(lambda: flash_attn_fwd_reference(qq, kk, vv, "bhnd", True))
        k6_cross_plain_ms = ms if k6_cross_plain_ms is None else k6_cross_plain_ms
        o_err, o_atol, lse_err, ok = _check(o, lse, ro, rl)
        log(f"[parity] K6 bf16 with LSE, Wan {label} bhnd (strided views): max|dO| "
            f"{o_err:.3e} (atol {o_atol:.2e} + rtol {O_RTOL}), max|dLSE| {lse_err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}; plain version {ms:.1f} ms")
        if not ok:
            fail(f"flash_attn_fwd_d128 disagrees at the Wan {label}")
        k6_errs.append(o_err)
        del o, lse, ro, rl
    # self-attention at B = 2: two heads of each batch element against the plain version
    k2, v2 = _proj_views(gen, 2, N, H, D), _proj_views(gen, 2, N, H, D)
    o, lse = flash_attn_fwd_d128(q2, k2, v2, layout="bhnd", with_lse=True)
    for h in (0, H - 2):
        sl = (slice(None), slice(h, h + 2))
        ro, rl = flash_attn_fwd_reference(q2[sl], k2[sl], v2[sl], "bhnd", True)
        o_err, _, lse_err, ok = _check(o[sl], lse[sl], ro, rl)
        if not ok:
            fail(f"flash_attn_fwd_d128 disagrees at the Wan self shape with B = 2, heads {h}..")
        k6_errs.append(o_err)
        del ro, rl
    log(f"[parity] K6 bf16 with LSE, Wan self shape at B = 2 bhnd (strided views), heads "
        f"0-1 and {H - 2}-{H - 1} of both: max|dO| {max(k6_errs[2:]):.3e} ok")
    del q, k, v, q2, k2, v2, o, lse
    torch.cuda.empty_cache()
    return max(errs), self_plain_ms, cross_plain_ms, max(k6_errs), k6_cross_plain_ms


def _tiny_dpo_step(model, cfg, lora, batch, draws, compute_dtype, make_step=None):
    """Two train-step calls (accumulate 2, warmup 0) on one batch: the first
    leaves the LoRA gradients in the accumulator, the second updates.
    ``make_step`` defaults to the CogVideoX ``make_dpo_train_step``."""
    import torch

    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)

    make_dpo_train_step = make_step or make_dpo_train_step

    tcfg = TrainerConfig(learning_rate=1e-3, beta=1.0, warmup_steps=0, max_steps=20,
                         lora_rank=4, lora_alpha=8.0, accumulate_grad_batches=2,
                         compute_dtype=compute_dtype, remat=True)
    state = init_train_state(lora, tcfg)
    step, _ = make_dpo_train_step(model, cfg, tcfg)
    state, metrics = step(state, batch, **draws)
    grads = [g.detach().float().cpu().clone() for g in state.opt_state["acc_grads"]]
    state, _ = step(state, batch, **draws)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {n: {k: t.detach().float().cpu() for k, t in ab.items()}
             for n, ab in state.lora.items()})


def phase_slice_dpo() -> None:
    """One tiny DPO train step: bf16 on the card against f32 on the CPU."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
    from videogpa_torch.train.lora import lora_init

    cfg = CogVideoXConfig.tiny()
    ref = dit_init(cfg, torch.Generator().manual_seed(6), device="cpu").requires_grad_(False)
    dev = dit_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
    gen = torch.Generator().manual_seed(7)
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, 4, gen, device="cpu")
    with torch.no_grad():
        for ab in lora.values():
            ab["lora_B"].normal_(0.0, 0.1, generator=gen)  # every adapter live
    shape = (2, cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height, cfg.sample_width)
    batch = {"x_win": torch.randn(shape, generator=gen), "x_lose": torch.randn(shape, generator=gen),
             "prompt_emb": torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim,
                                       generator=gen)}
    draws = {"timesteps": torch.tensor([150, 800]),
             "noise": torch.randn(2, cfg.sample_frames, cfg.vae_latent_channels,
                                  cfg.sample_height, cfg.sample_width, generator=gen)}
    lora_dev = {n: {k: t.detach().to("cuda", copy=True) for k, t in ab.items()}
                for n, ab in lora.items()}
    m_cpu, g_cpu, l_cpu = _tiny_dpo_step(ref, cfg, lora, batch, draws, torch.float32)
    m_dev, g_dev, l_dev = _tiny_dpo_step(
        dev, cfg, lora_dev, {k: v.cuda() for k, v in batch.items()},
        {k: v.cuda() for k, v in draws.items()}, torch.bfloat16)
    grad_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_dev, g_cpu))
    loss_err = abs(m_dev["loss"] - m_cpu["loss"])
    upd_err = max((l_dev[n][k] - l_cpu[n][k]).abs().max().item()
                  for n in l_cpu for k in l_cpu[n])
    log(f"[slice] tiny DPO step bf16 on the card vs f32 on the CPU: loss {m_dev['loss']:.6f} "
        f"vs {m_cpu['loss']:.6f} (|d| {loss_err:.2e}, limit {DPO_LOSS_ATOL}), grad_norm "
        f"{m_dev['grad_norm']:.4e} vs {m_cpu['grad_norm']:.4e}, LoRA gradients max rel-norm "
        f"error {grad_rel:.3e} (limit {DPO_GRAD_REL}), updated LoRA max|d| {upd_err:.2e} "
        f"(limit 2.5 x lr = 2.5e-3)")
    finite = all(math.isfinite(v) for v in m_dev.values())
    if not (finite and loss_err <= DPO_LOSS_ATOL and grad_rel <= DPO_GRAD_REL
            and upd_err <= 2.5e-3):
        fail("the tiny DPO step on the card disagrees with the CPU reference")


def _write_preference_dataset(root: str, lat_shape, text_shape, image_latent_shape=None,
                              seed: int = 0):
    """Two groups of two scored videos with full-size latents (C, F, H, W)
    and a text-encoder-shaped condition (plus, for TI2V, the clean first
    frame's latent), in the metadata schema of train.dataset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "latents"), exist_ok=True)
    groups = []
    for g, scores in enumerate(((0.3, 0.7), (0.2, 0.6))):
        cond = f"latents/cond_{g}.npz"
        arrays = {"encoder_hidden_states": rng.standard_normal(text_shape, dtype=np.float32)}
        if image_latent_shape is not None:
            arrays["image_latent"] = rng.standard_normal(image_latent_shape, dtype=np.float32)
        np.savez(os.path.join(root, cond), **arrays)
        videos = []
        for i, score in enumerate(scores):
            lat = f"latents/lat_{g}_{i}.npz"
            np.savez(os.path.join(root, lat), data=rng.standard_normal(lat_shape, dtype=np.float32))
            videos.append({"video_path": f"v_{g}_{i}.mp4", "consistency_score": score,
                           "motion_norm": 0.1, "latent_path": lat, "condition_path": cond})
        groups.append({"group_id": f"g{g}", "prompt": f"prompt {g}", "videos": videos})
    with open(os.path.join(root, "meta_data.json"), "w") as f:
        json.dump({"groups": groups}, f)


def phase_train(mini_steps: int = 4):
    """The CogVideoX-5B DPO LoRA train step at full width and depth."""
    import tempfile

    import torch

    from videogpa_torch.checkpoint import TrainCheckpointer
    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
    from videogpa_torch.train.dataset import DPODataset, collate
    from videogpa_torch.train.lora import lora_init, lora_leaves
    from videogpa_torch.train.recipes import default_config
    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)

    cfg = CogVideoXConfig.cogvideox_5b()
    recipe = default_config("CogVideoX-5B")
    tcfg = TrainerConfig(
        learning_rate=recipe["learning_rate"], beta=recipe["beta"],
        warmup_steps=recipe["warmup_steps"], max_steps=recipe["max_steps"],
        gradient_clip_val=recipe["gradient_clip_val"],
        accumulate_grad_batches=recipe["accumulate_grad_batches"],
        lora_rank=recipe["lora_rank"], lora_alpha=recipe["lora_alpha"], remat=True)
    torch.cuda.reset_peak_memory_stats()
    dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                   dtype=torch.bfloat16).requires_grad_(False)
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, tcfg.lora_rank,
                     torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n_lora = sum(t.numel() for t in lora_leaves(lora))
    state = init_train_state(lora, tcfg)
    train_step, eval_step = make_dpo_train_step(dit, cfg, tcfg)

    with tempfile.TemporaryDirectory(prefix="videogpa_smoke_") as root:
        _write_preference_dataset(
            os.path.join(root, "data"),
            (cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height, cfg.sample_width),
            (cfg.max_text_seq_length, cfg.text_embed_dim))
        ds = DPODataset(os.path.join(root, "data"), os.path.join(root, "data", "meta_data.json"),
                        metric_name=recipe["metric_name"], metric_mode=recipe["metric_mode"],
                        min_gap=recipe["min_gap"], metric_threshold=recipe["metric_threshold"],
                        motion_threshold=recipe["motion_threshold"])
        if len(ds) != 2:
            fail(f"the synthetic preference dataset gave {len(ds)} pairs, expected 2")
        batches = [collate([ds[i % len(ds)]]) for i in range(mini_steps + 1)]
        log(f"[train] CogVideoX-5B DPO, recipe CogVideoX-5B: batch {recipe['batch_size']}, "
            f"accumulate {tcfg.accumulate_grad_batches}, LoRA r {tcfg.lora_rank} / alpha "
            f"{tcfg.lora_alpha} ({n_lora / 1e6:.2f} M f32 params), lr {tcfg.learning_rate}, "
            f"warmup {tcfg.warmup_steps}, max {tcfg.max_steps}, clip "
            f"{tcfg.gradient_clip_val}, beta {tcfg.beta}, remat {tcfg.remat}; {len(ds)} pairs, "
            f"latents {tuple(batches[0]['x_win'].shape)}, prompt_emb "
            f"{tuple(batches[0]['prompt_emb'].shape)}")

        b_norms, step_ms, metrics_log = [], [], []
        zero_launches()
        for i in range(mini_steps):
            gen = torch.Generator(device="cuda").manual_seed(10 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train_step(state, batches[i], generator=gen)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            m = {k: float(v) for k, v in metrics.items()}
            metrics_log.append(m)
            b_norms.append(sum(float(ab["lora_B"].detach().abs().max())
                               for ab in state.lora.values()))
            log(f"[train] mini-step {i + 1}: {step_ms[-1]:.1f} ms, " + json.dumps(m)
                + f", max|LoRA B| summed over targets {b_norms[-1]:.3e}")
        launches = read_launches()
        fwd, bwd = launches["flash_attn_fwd"], launches["flash_attn_bwd"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        L = cfg.num_layers
        want_fwd, want_bwd = mini_steps * 6 * L, mini_steps * 2 * L
        want = dict.fromkeys(launches, 0)
        want.update(flash_attn_fwd=want_fwd, flash_attn_bwd=want_bwd)
        log(f"[train] launches {json.dumps(launches)}; expected flash_attn_fwd {mini_steps} "
            f"mini-steps x 6 forwards (2 policy, 2 remat recomputes, 2 reference) x {L} layers "
            f"= {want_fwd}, flash_attn_bwd {mini_steps} x 2 policy backwards x {L} = "
            f"{want_bwd}, every other 0; peak allocated {peak_gb:.2f} GB")
        if not all(math.isfinite(v) for m in metrics_log for v in m.values()):
            fail("non-finite train metrics")
        if not (b_norms[1] == 0.0 and b_norms[-1] > 0.0):
            fail(f"LoRA B: expected zero after update 1 (lr schedule(0) = 0) and off zero "
                 f"after update 2, got {b_norms}")
        if launches != want:
            fail("the train path did not run every attention through the kernels")

        ck = TrainCheckpointer(os.path.join(root, "ckpt"), save_top_k=2)
        t0 = time.perf_counter()
        ck.save(state.step, state, metric=metrics_log[-1]["loss"])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ck.restore(ck.latest(), target=state, device="cuda")
        restore_s = time.perf_counter() - t0
        saved = lora_leaves(state.lora) + state.opt_state["mu"] + state.opt_state["nu"]
        loaded = lora_leaves(back.lora) + back.opt_state["mu"] + back.opt_state["nu"]
        same = (back.step == state.step and all(torch.equal(a.detach(), b.detach())
                                                for a, b in zip(saved, loaded)))
        size_mb = os.path.getsize(os.path.join(ck.latest(), "state.pt")) / 1e6
        log(f"[train] TrainCheckpointer round trip of the state (step {state.step}): save "
            f"{save_s:.2f} s, restore {restore_s:.2f} s, {size_mb:.1f} MB, equal: {same}")
        if not same:
            fail("the checkpoint round trip changed the train state")
        del back

        ev = eval_step(state, batches[0], generator=torch.Generator(device="cuda").manual_seed(3))
        if not all(math.isfinite(float(v)) for v in ev.values()):
            fail("non-finite eval metrics")
        profile = profile_device_time("one train mini-step (profiled)", lambda: train_step(
            state, batches[mini_steps], generator=torch.Generator(device="cuda").manual_seed(9)))
    del dit, state, lora
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "update_ms": [step_ms[i] + step_ms[i + 1] for i in range(0, mini_steps - 1, 2)],
            "peak_gb": peak_gb, "profile": profile, "metrics": metrics_log,
            "checkpoint_s": [save_s, restore_s]}


def _fwd_bound(B, Nq, Nk, H, D):
    """(bound ms, what bounds it) of a bf16 attention forward: 4 B H Nq Nk D
    operations against q, k, v read and O written once."""
    return _bound(4.0 * B * H * Nq * Nk * D, 2.0 * B * H * D * (2 * Nq + 2 * Nk),
                  PEAK_BF16_FLOPS)


def phase_timing(dit_shape, train_shape, vggt_global_shape):
    """K1 at the DiT's, the train and the VGGT global blocks' shapes, K3 at
    the train shape, beside their bounds and SDPA on the same operands; K1's
    and K3's achieved TFLOP/s, registers and shared memory."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import (
        BWD_QUERIES, bwd_splits, flash_attn_bwd, flash_attn_fwd)

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, N, H, D = dit_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    out["fwd_ms"] = cuda_ms(lambda: flash_attn_fwd(q, k, v, layout="bnhd"), iters=10)
    # yardstick only: the port never calls SDPA
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["fwd_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
    out["fwd_bound_ms"], out["fwd_bound_by"] = _fwd_bound(B, N, N, H, D)
    out["fwd_tflops"] = 4.0 * B * H * N * N * D / out["fwd_ms"] / 1e9
    attrs = _kernels.kernel_attrs("flash_attn_fwd", D)
    out["fwd_registers_at_launch"], out["fwd_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    del q, k, v, qt, kt, vt

    # the VGGT global blocks: q and k as the QK-norm outputs, v a view of the
    # packed projection
    B, N, H, D = vggt_global_shape
    q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    q, k = q.contiguous(), k.contiguous()
    out["fwd_vggt_ms"] = cuda_ms(lambda: flash_attn_fwd(q, k, v, layout="bnhd"), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["fwd_vggt_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                         iters=10)
    out["fwd_vggt_bound_ms"], out["fwd_vggt_bound_by"] = _fwd_bound(B, N, N, H, D)
    out["fwd_vggt_tflops"] = 4.0 * B * H * N * N * D / out["fwd_vggt_ms"] / 1e9
    del q, k, v, qt, kt, vt

    B, N, H, D = train_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    out["fwd_ms_train_shape"] = cuda_ms(
        lambda: flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True), iters=10)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["fwd_train_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                          iters=10)
    out["fwd_train_bound_ms"], _ = _fwd_bound(B, N, N, H, D)
    out["fwd_train_tflops"] = 4.0 * B * H * N * N * D / out["fwd_ms_train_shape"] / 1e9
    del qt, kt, vt
    o, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out["bwd_ms"] = cuda_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do, layout="bnhd"), iters=5)
    # yardstick only: SDPA's backward on the same operands (bhnd views)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    out["bwd_library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), iters=5)
    # five N x N x D products per head: S, dV, dP, dQ, dK
    flops = 10.0 * B * H * N * N * D
    nbytes = 2.0 * B * H * N * D * 8 + 4.0 * B * H * N * 2  # q k v o dO dQ dK dV, LSE delta
    out["bwd_bound_ms"] = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    out["bwd_bound_by"] = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    out["bwd_tflops"] = flops / out["bwd_ms"] / 1e9
    attrs = _kernels.kernel_attrs("flash_attn_bwd", D)
    out["bwd_registers_at_launch"], out["bwd_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    out["bwd_query_splits"] = bwd_splits(B * H, N, N, BWD_QUERIES)[0]
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return out


# K6's float32 path against its f32 plain version: both f32, differing only
# in summation order and the card's exp2 (a few f32 ulps of each weight)
F32_O_ATOL, F32_O_RTOL = 2e-5, 1e-5
F32_LSE_ATOL, F32_LSE_RTOL = 1e-5, 1e-6
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def _check_o(o, ro):
    """K1's O tolerance without an LSE: (max |dO|, atol, ok)."""
    import torch

    ro = ro.float()
    atol = min(O_ATOL_MAX, O_ATOL_RMS_FRAC * ro.square().mean().sqrt().item())
    d = (o.float() - ro).abs()
    ok = bool((d <= atol + O_RTOL * ro.abs()).all() and torch.isfinite(o).all())
    return d.max().item(), atol, ok


def _timed(fn):
    """(result, ms) of one call, CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_parity_short(vggt_shape):
    """K4 against its plain version in bf16; returns (max |dO|, plain ms at
    the VGGT frame-attention shape)."""
    import torch

    from videogpa_torch.ops.attention import flash_attn_short, flash_attn_short_reference

    gen = torch.Generator(device="cuda").manual_seed(21)
    nan_q, nan_k, nan_v = _attn_case(gen, 1, 200, 256, 2, 64, "bnhd")
    nan_k[:, 200:] = float("nan")
    nan_v[:, 200:] = float("nan")
    packed = torch.randn(1, 640, 3, 4, 64, generator=gen, device="cuda").to(torch.bfloat16)
    cases = [
        ("ragged N=300 D=64", _attn_case(gen, 2, 300, 300, 4, 64, "bnhd"), None),
        ("cross Nq=300 Nk=777 D=64", _attn_case(gen, 1, 300, 777, 3, 64, "bnhd"), None),
        ("cross Nq=1000 Nk=37 D=64", _attn_case(gen, 1, 1000, 37, 2, 64, "bnhd"), None),
        ("D=16 N=517", _attn_case(gen, 2, 517, 517, 2, 16, "bnhd"), None),
        ("D=32 N=517", _attn_case(gen, 2, 517, 517, 2, 32, "bnhd"), None),
        ("n_valid=200 of Nk=256, NaN in K/V rows >= 200", (nan_q, nan_k, nan_v), 200),
        ("extreme logits q*1e3 N=300 D=64",
         _attn_case(gen, 1, 300, 300, 2, 64, "bnhd", q_scale=1e3), None),
        ("strided views of packed qkv N=640", packed.unbind(2), None),
        # past CUDA's grid y limit of 65,535: K4's grid is flat
        ("B*H = 33,000 x 2 = 66,000 N=40 D=64", _attn_case(gen, 33000, 40, 40, 2, 64, "bnhd"),
         None),
    ]
    errs = []
    for name, (q, k, v), n_valid in cases:
        err, atol, ok = _check_o(flash_attn_short(q, k, v, n_valid),
                                 flash_attn_short_reference(q, k, v, n_valid))
        log(f"[parity] K4 {name}: max|dO| {err:.3e} (atol {atol:.2e} + rtol {O_RTOL}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attn_short disagrees with its plain version on {name}")
        errs.append(err)
    del cases, packed, nan_q, nan_k, nan_v

    # the VGGT frame-attention shape, q/k/v as views of one packed projection
    B, N, H, D = vggt_shape
    q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    o = flash_attn_short(q, k, v)
    ro, plain_ms = _timed(lambda: flash_attn_short_reference(q, k, v))
    err, atol, ok = _check_o(o, ro)
    log(f"[parity] K4 VGGT frame shape {vggt_shape} (strided qkv views): max|dO| {err:.3e} "
        f"(atol {atol:.2e} + rtol {O_RTOL}) {'ok' if ok else 'MISMATCH'}; plain version "
        f"{plain_ms:.2f} ms")
    if not ok:
        fail("flash_attn_short disagrees at the VGGT frame shape")
    errs.append(err)
    del q, k, v, o, ro
    torch.cuda.empty_cache()
    return max(errs), plain_ms


def phase_parity_d128(cam_shape, wan_shape, f32_long_shapes):
    """K6 against its plain version: the float32 entry (camera head, every
    head dim it takes, B*H past the grid y limit and the f32 scorer's frame
    and global rows ``f32_long_shapes``) and bf16 at head_dim 128; returns
    (max |dO| f32, max |dO| bf16, plain ms at the camera-head shape, plain ms
    at the Wan shape)."""
    import torch

    from videogpa_torch.ops.attention import (
        flash_attn_fwd_d128, flash_attn_fwd_f32, flash_attn_fwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(31)

    def f32(B, Nq, Nk, H, D, layout):
        shape = (lambda n: (B, n, H, D)) if layout == "bnhd" else (lambda n: (B, H, n, D))
        return tuple(torch.randn(shape(n), generator=gen, device="cuda")
                     for n in (Nq, Nk, Nk))

    f32_cases = [
        ("f32 camera head (4, 10, 16, 128) bnhd", "bnhd", f32(*cam_shape[:2], cam_shape[1],
                                                             *cam_shape[2:], "bnhd")),
        ("f32 cross Nq=37 Nk=53 bhnd D=128", "bhnd", f32(2, 37, 53, 3, 128, "bhnd")),
        ("f32 D=16 N=63 bnhd", "bnhd", f32(2, 63, 63, 2, 16, "bnhd")),
        ("f32 D=64 N=300 bnhd", "bnhd", f32(1, 300, 300, 2, 64, "bnhd")),
        ("f32 D=32 N=50 bhnd", "bhnd", f32(1, 50, 50, 2, 32, "bhnd")),
    ]
    # base addresses off 16 bytes: the kernel stages rows by 4-byte copies
    f32_cases.append(("f32 operands 4 bytes off 16-byte alignment N=70 bnhd D=64", "bnhd",
                      tuple(torch.randn(70 * 2 * 64 + 1, generator=gen, device="cuda")[1:]
                            .view(1, 70, 2, 64) for _ in range(3))))
    # past CUDA's grid y limit of 65,535: the f32 kernel's grid is flat
    f32_cases.append(("f32 B*H = 2 x 33,000 = 66,000 N=24 bnhd D=64", "bnhd",
                      f32(2, 24, 24, 33000, 64, "bnhd")))
    # the f32 scorer's frame and global rows (bnhd, as the blocks feed them);
    # the plain version over chunks of heads (a (N, N) f32 score matrix each)
    for label, (B, N, H, D) in zip(("frame", "global"), f32_long_shapes):
        f32_cases.append((f"f32 scorer {label} rows {(B, N, H, D)} bnhd", "bnhd",
                          f32(B, N, N, H, D, "bnhd")))
    f32_errs, cam_plain_ms = [], None
    for name, layout, (q, k, v) in f32_cases:
        o, lse = flash_attn_fwd_f32(q, k, v, layout=layout, with_lse=True)
        B, Nq, H = (q.shape[:3] if layout == "bnhd" else
                    (q.shape[0], q.shape[2], q.shape[1]))
        Nk = k.shape[1] if layout == "bnhd" else k.shape[2]
        chunk = max(1, 2 ** 30 // (4 * B * Nq * Nk))  # heads a 1 GB score matrix holds
        worst_o = worst_l = 0.0
        ok = True
        for h in range(0, H, chunk):
            hs = slice(h, h + chunk)
            sl = (slice(None), slice(None), hs) if layout == "bnhd" else (slice(None), hs)
            (ro, rl), ms = _timed(lambda: flash_attn_fwd_reference(q[sl], k[sl], v[sl], layout,
                                                                   True))
            if cam_plain_ms is None:
                cam_plain_ms = ms
            d_o, d_l = (o[sl] - ro).abs(), (lse[:, hs] - rl).abs()
            ok = ok and bool((d_o <= F32_O_ATOL + F32_O_RTOL * ro.abs()).all()
                             and (d_l <= F32_LSE_ATOL + F32_LSE_RTOL * rl.abs()).all()
                             and torch.isfinite(o[sl]).all())
            worst_o, worst_l = max(worst_o, d_o.max().item()), max(worst_l, d_l.max().item())
            del ro, rl, d_o, d_l
        log(f"[parity] K6 {name}: max|dO| {worst_o:.3e} (atol {F32_O_ATOL} + rtol "
            f"{F32_O_RTOL}), max|dLSE| {worst_l:.3e} (atol {F32_LSE_ATOL} + rtol "
            f"{F32_LSE_RTOL}), heads in chunks of {min(chunk, H)} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attn_fwd_f32 disagrees with its plain version on {name}")
        f32_errs.append(worst_o)
        del q, k, v, o, lse

    bf16_cases = [
        ("bf16 ragged N=300 bnhd D=128", "bnhd", _attn_case(gen, 2, 300, 300, 3, 128, "bnhd")),
        ("bf16 cross Nq=100 Nk=777 bhnd D=128", "bhnd",
         _attn_case(gen, 1, 100, 777, 2, 128, "bhnd")),
        ("bf16 ragged cross Nq=1000 Nk=37 bnhd D=128", "bnhd",
         _attn_case(gen, 1, 1000, 37, 2, 128, "bnhd")),
        ("bf16 cross Nq=333 Nk=512, strided (B, H, N, D) views of projections", "bhnd",
         (_proj_views(gen, 2, 333, 3, 128), _proj_views(gen, 2, 512, 3, 128),
          _proj_views(gen, 2, 512, 3, 128))),
        ("bf16 extreme logits q*1e3 N=300 D=128", "bnhd",
         _attn_case(gen, 1, 300, 300, 2, 128, "bnhd", q_scale=1e3)),
        # past CUDA's grid y limit of 65,535: K6's persistent grid takes any B*H
        ("bf16 B*H = 2 x 33,000 = 66,000 N=24 bnhd D=128", "bnhd",
         _attn_case(gen, 2, 24, 24, 33000, 128, "bnhd")),
    ]
    bf16_errs = []
    for name, layout, (q, k, v) in bf16_cases:
        o, lse = flash_attn_fwd_d128(q, k, v, layout=layout, with_lse=True)
        o_err, o_atol, lse_err, ok = _check(
            o, lse, *flash_attn_fwd_reference(q, k, v, layout=layout, with_lse=True))
        # the entry without LSE runs the same kernel: the same O bit for bit
        same = torch.equal(flash_attn_fwd_d128(q, k, v, layout=layout)[0], o)
        log(f"[parity] K6 {name}: max|dO| {o_err:.3e} (atol {o_atol:.2e} + rtol {O_RTOL}), "
            f"max|dLSE| {lse_err:.3e} (atol {LSE_ATOL} + rtol {LSE_RTOL}), O without LSE "
            f"equal: {same} {'ok' if ok and same else 'MISMATCH'}")
        if not (ok and same):
            fail(f"flash_attn_fwd_d128 disagrees with its plain version on {name}")
        bf16_errs.append(o_err)
    del f32_cases, bf16_cases

    # the Wan shape in bf16 with LSE; the plain version over chunks of 4 heads
    B, N, H, D = wan_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    o, lse = flash_attn_fwd_d128(q, k, v, layout="bnhd", with_lse=True)
    chunk, wan_plain_ms, worst = 4, 0.0, 0.0
    for h in range(0, H, chunk):
        sl = (slice(None), slice(None), slice(h, h + chunk))
        (ro, rl), ms = _timed(lambda: flash_attn_fwd_reference(q[sl], k[sl], v[sl], "bnhd", True))
        wan_plain_ms += ms
        o_err, _, _, ok = _check(o[sl], lse[:, h:h + chunk], ro, rl)
        worst = max(worst, o_err)
        if not ok:
            fail(f"flash_attn_fwd_d128 disagrees at the Wan shape, heads {h}..")
        del ro, rl
    log(f"[parity] K6 bf16 Wan shape {wan_shape} bnhd with LSE, all {H} heads in chunks of "
        f"{chunk}: max|dO| {worst:.3e} ok; plain version {wan_plain_ms:.1f} ms over the chunks")
    bf16_errs.append(worst)
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return max(f32_errs), max(bf16_errs), cam_plain_ms, wan_plain_ms


def synthetic_clip(S: int = 10, H: int = 518, W: int = 518, device="cuda"):
    """A clip-shaped cloud: S smooth depth maps with object edges, seen from
    S cameras on a small arc, unprojected to S*H*W world points. Returns
    (points (S*H*W, 3), intrinsics (S, 3, 3), extrinsics (S, 3, 4))."""
    import torch

    from videogpa_torch.geometry.transforms import depth_to_world_points

    yy, xx = torch.meshgrid(torch.linspace(0, 1, H, device=device),
                            torch.linspace(0, 1, W, device=device), indexing="ij")
    depth = torch.stack([
        2.0 + 0.5 * torch.sin(6 * xx + 0.3 * s) * torch.cos(4 * yy)
        + 0.8 * ((xx - 0.5).abs() < 0.15).float() * ((yy - 0.4).abs() < 0.2).float()
        for s in range(S)])
    f = 0.8 * W
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], device=device).expand(S, 3, 3)
    ang = torch.linspace(-0.15, 0.15, S, device=device)
    c, sn, zero, one = torch.cos(ang), torch.sin(ang), torch.zeros_like(ang), torch.ones_like(ang)
    R = torch.stack([torch.stack([c, zero, sn], -1), torch.stack([zero, one, zero], -1),
                     torch.stack([-sn, zero, c], -1)], -2)
    t = torch.stack([0.3 * ang, 0.05 * ang, zero], -1)[..., None]
    E = torch.cat([R, t], -1)
    return depth_to_world_points(depth, E, K).reshape(-1, 3), K.contiguous(), E


def zbuffer_stream(S: int = 10, H: int = 518, W: int = 518):
    """One clip's packed z-buffer update stream: (lin, key, n_slots, pid_bits)."""
    from videogpa_torch.geometry.projection import packed_keys

    points, K, E = synthetic_clip(S, H, W)
    lin, key, pid_bits = packed_keys(points, K, E, H, W)
    return lin.reshape(-1), key.reshape(-1), S * (H * W + 1), pid_bits


def phase_parity_zbuffer():
    """K5 against its plain version on the card, bit for bit; returns the
    plain ms on one clip's real packed-key stream."""
    import torch

    from videogpa_torch.geometry.zbuffer_kernel import (
        SENTINEL, scatter_min_u32, scatter_min_u32_reference)

    S, H, W = 10, 518, 518
    lin, key, n_slots, pid_bits = zbuffer_stream(S, H, W)
    gen = torch.Generator(device="cuda").manual_seed(41)
    U = lin.numel()
    rnd_key = torch.randint(0, 2 ** 32, (U,), generator=gen, device="cuda", dtype=torch.int64)
    rnd_key[::7] = SENTINEL
    n_one = min(U, 1 << 22)
    cases = [
        (f"real packed-key stream ({S} views x {H}x{W} points, pid_bits {pid_bits}, "
         f"{int((key != SENTINEL).sum())} of {U} updates live)", lin, key, n_slots),
        ("sentinel-only stream", lin, torch.full_like(key, SENTINEL), n_slots),
        (f"all updates on one slot (contention), {n_one} random keys",
         torch.zeros(n_one, dtype=torch.int64, device="cuda"), rnd_key[:n_one], 1),
        ("random addresses and keys, every 7th a sentinel",
         torch.randint(0, n_slots, (U,), generator=gen, device="cuda"), rnd_key, n_slots),
    ]
    plain_ms = None
    for name, l, k, n in cases:
        got = scatter_min_u32(l, k, n)
        want, ms = _timed(lambda: scatter_min_u32_reference(l, k, n))
        plain_ms = ms if plain_ms is None else plain_ms
        same = torch.equal(got, want)
        log(f"[parity] K5 {name}: bit-identical to the plain version: {same}; "
            f"{int((want != SENTINEL).sum())} slots written")
        if not same:
            fail(f"scatter_min_u32 differs from its plain version on {name}")
    del cases, rnd_key, lin, key
    torch.cuda.empty_cache()
    return plain_ms


# [slice_scorer]: the tiny VGGT scorer, f32 on the card against f32 on the
# CPU. Backbone outputs differ by summation order only (cuBLAS vs the CPU's
# BLAS, K6's f32 kernel vs the plain version, f32 convolutions with TF32
# off): pose_enc within SCORER_POSE_ATOL, depth and conf within
# SCORER_DENSE_RTOL of their largest value. A score may move further where a
# pixel's z-buffer winner flips under that noise (near-equal depths): one
# flipped pixel moves a clip's MSE by at most 1 / (S*H*W), so MSE and the
# consistency score are held within SCORER_FLIPS such pixels (+1e-5), PSNR
# within the log of that change, SSIM and LPIPS (local windows of the same
# frames) within 1e-2 and 1e-3, motion_norm and MVCS (no z-buffer) within 1e-4
SCORER_POSE_ATOL, SCORER_DENSE_RTOL, SCORER_FLIPS = 1e-4, 1e-4, 10


def regular_camera_(model) -> None:
    """Shift the random camera head's fov outputs by +1 rad. A random head
    can emit fov 0 after its ReLU (focal length inf, NaN pixels), where the
    z-buffer would see no geometry at all; with this the scorer does real
    reprojection work on random weights."""
    import torch

    with torch.no_grad():
        model.camera_head.pose_branch.fc2.bias[7:9] += 1.0


def synthetic_frames(K: int, S: int, size: int, seed: int):
    """K clips of S uint8 frames (size x size x 3): a smooth random texture
    panning a few pixels a frame, as a slow camera move would."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(K):
        small = rng.uniform(0, 255, (size // 8 + 2, size // 8 + S + 2, 3))
        big = np.kron(small, np.ones((8, 8, 1)))  # blocky texture, 8-pixel cells
        clips.append(np.stack([big[:size, 2 * t: 2 * t + size] for t in range(S)])
                     .astype(np.uint8))
    return clips


def device_metrics(metrics: dict) -> dict:
    """The metric set without Epipolar: its SIFT matching needs OpenCV on the
    host, which the card's machine lacks; the CPU tests hold it."""
    return {name: m for name, m in metrics.items() if name != "Epipolar"}


def phase_slice_scorer() -> None:
    """The tiny VGGT scorer through process_frames_batch, f32 on the card
    against the same weights and frames in f32 on the CPU."""
    import numpy as np
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init
    from videogpa_torch.reward import VideoProcessor

    cfg = VGGTConfig.tiny()
    ref = vggt_init(cfg, torch.Generator().manual_seed(8), device="cpu").eval()
    regular_camera_(ref)
    dev = vggt_init(cfg, device="cuda").eval()
    dev.load_state_dict(ref.state_dict())
    lp_ref = lpips_init(torch.Generator().manual_seed(9), device="cpu")
    lp_dev = lpips_init(device="cuda")
    lp_dev.load_state_dict(lp_ref.state_dict())
    clips = synthetic_frames(2, 4, cfg.img_size, seed=10)
    S, H, W = clips[0].shape[:3]

    imgs = torch.from_numpy(np.stack(clips)).float().permute(0, 1, 4, 2, 3) / 255.0
    with torch.no_grad():
        want = vggt_forward(ref, imgs, compute_dtype=torch.float32)
        got = vggt_forward(dev, imgs.cuda(), compute_dtype=torch.float32)
    pose_err = (got["pose_enc"].cpu() - want["pose_enc"]).abs().max().item()
    dense = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
             for k in ("depth", "depth_conf")}
    log(f"[slice] tiny VGGT f32 card vs CPU: max|d pose_enc| {pose_err:.2e} (limit "
        f"{SCORER_POSE_ATOL}), depth {dense['depth']:.2e}, conf {dense['depth_conf']:.2e} "
        f"relative to the largest value (limit {SCORER_DENSE_RTOL})")
    if pose_err > SCORER_POSE_ATOL or max(dense.values()) > SCORER_DENSE_RTOL:
        fail("the tiny VGGT forward on the card disagrees with the CPU")

    def score(model, lp, device):
        vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model, compute_dtype=torch.float32,
                            zbuffer_impl="packed", device=device)
        return vp.process_frames_batch(clips, [0])

    got_s, want_s = score(dev, lp_dev, "cuda"), score(ref, lp_ref, "cpu")
    flip = SCORER_FLIPS / (S * H * W)
    worst = {}
    for g, w in zip(got_s, want_s):
        for name, b in w[0].items():
            a = g[0][name]
            if name in ("MSE", "Consistency_Score"):
                lim = flip + 1e-5
            elif name == "PSNR":
                lim = 10 * np.log10(1 + flip / max(w[0]["MSE"], 1e-12)) + 1e-4
            else:
                lim = {"SSIM": 1e-2, "LPIPS": 1e-3}.get(name, 1e-4)
            d = abs(a - b)
            worst[name] = max(worst.get(name, 0.0), d)
            if not (np.isfinite(a) and d <= lim):
                fail(f"tiny scorer {name}: card {a} vs CPU {b} (limit {lim:.2e})")
    log(f"[slice] tiny scorer (2 clips x {S} frames at {H}^2, packed z-buffer) f32 card vs "
        f"CPU, max |d| per score: " + json.dumps({k: float(f"{v:.3e}") for k, v in
                                                  worst.items()})
        + f"; MSE limit {SCORER_FLIPS} flipped pixels = {flip + 1e-5:.2e}")


# [slice_vggt_bf16]: a small VGGT with the scorer's dtypes on the card (trunk
# and DPT bf16, camera head f32) against the same weights in f32 on the CPU.
# Its config keeps the full model's head dims (64 in the blocks, 128 in the
# camera head) and rows long enough that the global blocks reach K1 (6 frames
# x 405 tokens = 2,430 keys, past K4's 2,048) and the frame and DINOv2 blocks
# K4. The bf16 rounding of activations alone moves pose_enc by about 1e-2 (one
# bf16 ulp of the fov terms near 2), depth and its confidence by < 1e-3 and
# the world points by < 1e-2 of their largest value (the plain versions in
# bf16 on the CPU: 1.2e-2, 9.2e-4 and 8.8e-3 over three seeds); the limits
# are about four times that. One V row out of place in either attention moves
# pose_enc by 0.17 to 0.4 there.
BF16_POSE_ATOL, BF16_DENSE_RTOL, BF16_POINTS_RTOL = 5e-2, 5e-3, 3e-2


def phase_slice_vggt_bf16() -> None:
    """A small VGGT in the scorer's dtypes on the card against f32 on the CPU,
    so that the blocks feed K4 and K1 (and the camera head K6's f32 entry)
    inside the model."""
    import dataclasses

    import numpy as np
    import torch

    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init

    cfg = dataclasses.replace(VGGTConfig.tiny(), img_size=280, backbone_dim=128,
                              backbone_heads=2, embed_dim=128, num_heads=2)
    dev = vggt_init(cfg, torch.Generator(device="cuda").manual_seed(12), device="cuda",
                    dtype=torch.bfloat16).eval()
    regular_camera_(dev)
    dev.camera_head.float()
    ref = vggt_init(cfg, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu() for k, v in dev.state_dict().items()})
    clips = synthetic_frames(1, 6, cfg.img_size, seed=12)
    imgs = torch.from_numpy(np.stack(clips)).float().permute(0, 1, 4, 2, 3) / 255.0
    with torch.no_grad():
        want = vggt_forward(ref, imgs, compute_dtype=torch.float32)
        zero_launches()
        got = vggt_forward(dev, imgs.cuda(), compute_dtype=torch.bfloat16,
                           dpt_dtype=torch.bfloat16)
        torch.cuda.synchronize()
    launches = read_launches()
    expect = {name: 0 for name in launches}
    expect.update(flash_attn_fwd=cfg.depth, flash_attn_short=cfg.backbone_depth + cfg.depth,
                  flash_attn_fwd_f32=cfg.camera_trunk_depth * cfg.camera_iterations)
    pose_err = (got["pose_enc"].float().cpu() - want["pose_enc"]).abs().max().item()
    rel = {k: ((got[k].float().cpu() - want[k]).abs().max() / want[k].abs().max()).item()
           for k in ("depth", "depth_conf", "world_points", "world_points_conf")}
    log(f"[slice] small VGGT ({cfg.img_size}^2, 6 frames, blocks 2 x 64, camera head 2 x "
        f"128) bf16 trunk and DPT on the card vs f32 on the CPU: max|d pose_enc| "
        f"{pose_err:.3e} (limit {BF16_POSE_ATOL}), max|d| / max|ref| " + json.dumps(
            {k: float(f"{v:.3e}") for k, v in rel.items()})
        + f" (limits {BF16_DENSE_RTOL}, world_points {BF16_POINTS_RTOL}); launches "
        + json.dumps(launches))
    if launches != expect:
        fail(f"the small bf16 VGGT did not reach K1, K4 and K6 as expected {expect}")
    if not (pose_err <= BF16_POSE_ATOL and rel["world_points"] <= BF16_POINTS_RTOL
            and max(v for k, v in rel.items() if k != "world_points") <= BF16_DENSE_RTOL):
        fail("the small bf16 VGGT on the card disagrees with the CPU reference")


def phase_scorer(num_batches: int = 3, K: int = 4, S: int = 10):
    """The VGGT-1B scorer at full width: K clips x S frames x 518^2 per batch,
    packed z-buffer, dpt_chunk 8, the fusable metrics with a VGG16 LPIPS."""
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.models.vggt import VGGTConfig, vggt_init
    from videogpa_torch.reward import VideoProcessor

    cfg = VGGTConfig()
    t0 = time.perf_counter()
    model = vggt_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                      dtype=torch.bfloat16).eval()
    regular_camera_(model)
    model.camera_head.float()  # the camera head runs in f32
    lp = lpips_init(torch.Generator(device="cuda").manual_seed(1), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[scorer] VGGT-1B: DINOv2 ViT-L/14 {cfg.backbone_depth} blocks, aggregator "
        f"{cfg.depth} frame + {cfg.depth} global blocks at {cfg.embed_dim} ({cfg.num_heads}x"
        f"{cfg.embed_dim // cfg.num_heads}), camera head {cfg.camera_trunk_depth} blocks at "
        f"{cfg.tokens_dim} x {cfg.camera_iterations} iterations (f32), DPT {cfg.dpt_features}; "
        f"{n_params / 1e9:.3f} B params (trunk and DPT bf16), LPIPS VGG16 f32; built in "
        f"{time.perf_counter() - t0:.1f} s")
    vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model, compute_dtype=torch.bfloat16,
                        dpt_chunk=8, zbuffer_impl="packed", device="cuda")
    batches = [synthetic_frames(K, S, cfg.img_size, seed=100 + b) for b in range(num_batches)]

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    batch_ms, results, all_results = [], None, []
    for b, clips in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = vp.process_frames_batch(clips, [0])
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        all_results.append(results)
        log(f"[scorer] batch {b} ({'cold' if b == 0 else 'warm'}): {batch_ms[-1]:.1f} ms, "
            f"{K / (batch_ms[-1] / 6e4):.1f} clips/min; clip 0: "
            + json.dumps({k: round(v, 6) for k, v in results[0][0].items()}))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_batch = {k: v / num_batches for k, v in launches.items()}
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attn_fwd": cfg.depth,
                 "flash_attn_short": cfg.backbone_depth + cfg.depth,
                 "flash_attn_fwd_f32": cfg.camera_trunk_depth * cfg.camera_iterations,
                 "scatter_min_u32": K})
    log(f"[scorer] launches per batch {json.dumps(per_batch)}; expected {json.dumps(want)} "
        f"(K1: the {cfg.depth} global blocks; K4: {cfg.backbone_depth} DINOv2 + {cfg.depth} "
        f"frame blocks; K6 f32: {cfg.camera_trunk_depth} trunk blocks x "
        f"{cfg.camera_iterations} iterations; K5: one packed z-buffer per clip); peak "
        f"allocated {peak_gb:.2f} GB")
    if per_batch != want:
        fail("the scorer did not run each attention and z-buffer through its kernel")
    for r in results:
        for name, v in r[0].items():
            if not math.isfinite(v):
                fail(f"non-finite score {name} = {v}")
        if len(r["_extrinsic"]) != S:
            fail("extrinsics of the wrong shape")
    profile = profile_device_time("one scorer batch (profiled)",
                                  lambda: vp.process_frames_batch(batches[-1], [0]))
    del vp, model, lp
    torch.cuda.empty_cache()
    return {"batch_ms": batch_ms, "clips_per_min": [K / (ms / 6e4) for ms in batch_ms],
            "peak_gb": peak_gb, "launches": launches, "per_batch": per_batch,
            "profile": profile, "results": all_results}


# [slice_wan]: a small Wan DiT that keeps the full model's head_dim (128, the
# only one K6's bf16 kernel and K7 take) on the card in the path's dtypes (bf16
# blocks, f32 modulation and norms) against the same weights in f32 on the
# CPU. The plain versions in bf16 on the CPU differ from f32 by less than
# 1e-2 in the rel-norm of the loop's latents, 3e-2 in the rel-norm of a LoRA
# gradient and 2e-4 in the loss (near ln 2 at beta 1), which
# tests/test_torch_wan.py::test_small_wan_of_the_smoke_run_in_bf16_plain_versions
# holds on three seeds; the limits are about three times the first two, and
# 2e-3 for the loss. The first AdamW update moves every element by about lr,
# so a sign that flips under bf16 moves it by 2 x lr, as in the CogVideoX step.
WAN_LOOP_REL, WAN_DPO_GRAD_REL, WAN_DPO_LOSS_ATOL = 3e-2, 8e-2, 2e-3


def small_wan_config():
    """2 layers, 2 heads x 128, text 32 x 64: every attention at head_dim 128."""
    from videogpa_torch.models.wan import WanConfig

    return WanConfig(num_layers=2, dim=256, ffn_dim=512, num_heads=2, in_channels=8,
                     out_channels=8, text_dim=64, text_len=32, freq_dim=64, vae_z_dim=8)


def small_wan_case(cfg, seed: int = 14):
    """(f32 CPU model, LoRA with live B, DPO batch with image latents, draws,
    denoise inputs) for the small Wan, all from one seed on the CPU."""
    import torch

    from videogpa_torch.models.wan import wan_init
    from videogpa_torch.train.lora import lora_init

    gen = torch.Generator().manual_seed(seed)
    ref = wan_init(cfg, gen, device="cpu").requires_grad_(False)
    lora = lora_init(cfg.num_layers, cfg.dim, 4, gen, device="cpu")
    with torch.no_grad():
        for ab in lora.values():
            ab["lora_B"].normal_(0.0, 0.1, generator=gen)  # every adapter live
    lat = (cfg.in_channels, 5, 16, 16)  # 5 x 8 x 8 = 320 tokens

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    batch = {"x_win": rnd(2, *lat), "x_lose": rnd(2, *lat),
             "prompt_emb": rnd(2, cfg.text_len, cfg.text_dim),
             "image_latent": rnd(2, lat[0], 1, *lat[2:])}
    draws = {"timesteps": torch.tensor([150, 800]), "noise": rnd(2, *lat)}
    loop = {"context": rnd(1, cfg.text_len, cfg.text_dim),
            "null_context": rnd(1, cfg.text_len, cfg.text_dim),
            "latents": rnd(1, *lat), "image_latent": rnd(1, lat[0], 1, *lat[2:])}
    return ref, lora, batch, draws, loop


def small_wan_run(model, cfg, lora, batch, draws, loop, compute_dtype):
    """3 UniPC steps with the TI2V first frame (guidance 3), then the two
    calls of ``_tiny_dpo_step`` through the Wan train step."""
    from videogpa_torch.models.wan import wan_denoise_loop
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    lat = wan_denoise_loop(model, loop["context"], loop["null_context"],
                           tuple(loop["latents"].shape), num_steps=3, guidance_scale=3.0,
                           image_latent=loop["image_latent"], ti2v=True,
                           compute_dtype=compute_dtype, latents=loop["latents"])
    return lat.float().cpu(), _tiny_dpo_step(model, cfg, lora, batch, draws, compute_dtype,
                                             make_step=make_wan_dpo_train_step)


def phase_slice_wan() -> None:
    """The small Wan at head_dim 128: bf16 on the card (K6 and K7) against f32
    on the CPU, the denoise loop and one DPO step, with their launch counts."""
    import torch

    from videogpa_torch.models.wan import wan_init

    cfg = small_wan_config()
    ref, lora, batch, draws, loop = small_wan_case(cfg)
    dev = wan_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
    lora_dev = {n: {k: t.detach().to("cuda", copy=True) for k, t in ab.items()}
                for n, ab in lora.items()}

    def cuda(d):
        return {k: v.cuda() for k, v in d.items()}

    lat_cpu, (m_cpu, g_cpu, l_cpu) = small_wan_run(ref, cfg, lora, batch, draws, loop,
                                                   torch.float32)
    zero_launches()
    lat_dev, (m_dev, g_dev, l_dev) = small_wan_run(dev, cfg, lora_dev, cuda(batch), cuda(draws),
                                                   cuda(loop), torch.bfloat16)
    torch.cuda.synchronize()
    launches = read_launches()
    L = cfg.num_layers
    # loop: 3 forwards x (self + cross) x L; each of the 2 DPO calls: 2
    # reference forwards, 2 policy forwards and their 2 recomputations
    want = dict.fromkeys(launches, 0)
    want.update(flash_attn_fwd_d128=3 * 2 * L + 2 * 6 * 2 * L, flash_attn_bwd_d128=2 * 2 * 2 * L)
    loop_rel = ((lat_dev - lat_cpu).norm() / lat_cpu.norm()).item()
    first_frame = torch.equal(lat_dev[:, :, :1], loop["image_latent"])
    grad_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_dev, g_cpu))
    loss_err = abs(m_dev["loss"] - m_cpu["loss"])
    upd_err = max((l_dev[n][k] - l_cpu[n][k]).abs().max().item()
                  for n in l_cpu for k in l_cpu[n])
    log(f"[slice] small Wan ({L} layers, {cfg.num_heads} x {cfg.head_dim} heads, 320 tokens, "
        f"text {cfg.text_len}) bf16 on the card vs f32 on the CPU: 3 UniPC steps with ti2v "
        f"rel-norm error {loop_rel:.3e} (limit {WAN_LOOP_REL}), first frame kept: "
        f"{first_frame}; DPO step loss {m_dev['loss']:.6f} vs {m_cpu['loss']:.6f} (|d| "
        f"{loss_err:.2e}, limit {WAN_DPO_LOSS_ATOL}), grad_norm {m_dev['grad_norm']:.4e} vs "
        f"{m_cpu['grad_norm']:.4e}, LoRA gradients max rel-norm error {grad_rel:.3e} (limit "
        f"{WAN_DPO_GRAD_REL}), updated LoRA max|d| {upd_err:.2e} (limit 2.5 x lr = 2.5e-3); "
        f"launches {json.dumps(launches)}")
    if launches != want:
        fail(f"the small Wan did not reach K6 and K7 as expected {want}")
    finite = all(math.isfinite(v) for v in m_dev.values()) and bool(lat_dev.isfinite().all())
    if not (finite and first_frame and loop_rel <= WAN_LOOP_REL
            and loss_err <= WAN_DPO_LOSS_ATOL and grad_rel <= WAN_DPO_GRAD_REL
            and upd_err <= 2.5e-3):
        fail("the small Wan on the card disagrees with the CPU reference")


WAN_LATENT = (48, 21, 44, 80)  # 81 frames at 704 x 1280 -> 21 x 22 x 40 = 18,480 tokens


def _wan_5b():
    import torch

    from videogpa_torch.models.wan import WanConfig, wan_init

    cfg = WanConfig.ti2v_5b()
    t0 = time.perf_counter()
    model = wan_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                     dtype=torch.bfloat16).requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    return cfg, model, (f"Wan2.2-TI2V-5B DiT: {cfg.num_layers} layers (no depth cut), dim "
                        f"{cfg.dim}, {cfg.num_heads}x{cfg.head_dim} heads, FFN {cfg.ffn_dim}, "
                        f"text {cfg.text_len} x {cfg.text_dim}, {n_params / 1e9:.3f} B params "
                        f"in bf16 on the card in {time.perf_counter() - t0:.1f} s")


def phase_wan(num_requests: int = 2, steps: int = 3):
    """The Wan2.2-TI2V-5B denoise path at full width and depth: CFG pair,
    UniPC, the clean first frame re-imposed and per-token timesteps."""
    import torch

    from videogpa_torch.models.wan import wan_denoise_loop

    cfg, model, what = _wan_5b()
    log(f"[wan] {what}")
    latent_shape = (1,) + WAN_LATENT
    torch.cuda.reset_peak_memory_stats()
    request_s = []
    zero_launches()
    for r in range(num_requests):
        gen = torch.Generator(device="cuda").manual_seed(200 + r)
        text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device="cuda")
        negative = torch.randn(text.shape, generator=gen, device="cuda")
        image = torch.randn(1, WAN_LATENT[0], 1, *WAN_LATENT[2:], generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = wan_denoise_loop(model, text, negative, latent_shape, num_steps=steps,
                               image_latent=image, ti2v=True, generator=gen)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        if tuple(lat.shape) != latent_shape or not bool(torch.isfinite(lat).all()):
            fail(f"wan request {r}: latents {tuple(lat.shape)} not finite or wrong shape")
        if not torch.equal(lat[:, :, :1], image):
            fail(f"wan request {r}: the first latent frame is not the image latent")
        log(f"[wan] request {r}: {steps} UniPC steps (CFG pair, ti2v) in {request_s[-1]:.3f} "
            f"s, latents {tuple(lat.shape)} finite, first frame kept, std of the rest "
            f"{lat[:, :, 1:].std().item():.4f}")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = num_requests * steps * 2 * cfg.num_layers
    want = dict.fromkeys(launches, 0)
    want["flash_attn_fwd_d128"] = expected
    log(f"[wan] launches {json.dumps(launches)}; expected flash_attn_fwd_d128 {num_requests} "
        f"requests x {steps} steps x ({cfg.num_layers} self + {cfg.num_layers} cross) = "
        f"{expected}, every other 0; peak allocated {peak_gb:.2f} GB")
    if launches != want:
        fail("the Wan denoise path did not run every attention through K6 alone")
    profile = profile_device_time("one Wan denoise step (profiled)", lambda: wan_denoise_loop(
        model, text, negative, latent_shape, num_steps=1, image_latent=image, ti2v=True,
        generator=torch.Generator(device="cuda").manual_seed(5)))
    return {"launches": launches, "request_s": request_s,
            "step_ms": [1e3 * s / steps for s in request_s], "peak_gb": peak_gb,
            "launches_per_step": 2 * cfg.num_layers, "profile": profile, "dit": model}


def phase_wan_train(mini_steps: int = 4):
    """The Wan2.2-TI2V-5B DPO LoRA train step at full width and depth."""
    import tempfile

    import torch

    from videogpa_torch.train.dataset import DPODataset, collate
    from videogpa_torch.train.lora import lora_init, lora_leaves
    from videogpa_torch.train.recipes import default_config
    from videogpa_torch.train.trainer import TrainerConfig, init_train_state
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    recipe = default_config("Wan2.2-TI2V-5B")
    tcfg = TrainerConfig(
        learning_rate=recipe["learning_rate"], beta=recipe["beta"],
        warmup_steps=recipe["warmup_steps"], max_steps=recipe["max_steps"],
        accumulate_grad_batches=recipe["accumulate_grad_batches"],
        lora_rank=recipe["lora_rank"], lora_alpha=recipe["lora_alpha"], remat=True)
    torch.cuda.reset_peak_memory_stats()
    cfg, model, what = _wan_5b()
    lora = lora_init(cfg.num_layers, cfg.dim, tcfg.lora_rank,
                     torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n_lora = sum(t.numel() for t in lora_leaves(lora))
    state = init_train_state(lora, tcfg)
    train_step, eval_step = make_wan_dpo_train_step(model, cfg, tcfg)

    with tempfile.TemporaryDirectory(prefix="videogpa_smoke_") as root:
        _write_preference_dataset(os.path.join(root, "data"), WAN_LATENT,
                                  (cfg.text_len, cfg.text_dim),
                                  image_latent_shape=(WAN_LATENT[0], 1, *WAN_LATENT[2:]))
        ds = DPODataset(os.path.join(root, "data"), os.path.join(root, "data", "meta_data.json"),
                        metric_name=recipe["metric_name"], metric_mode=recipe["metric_mode"],
                        min_gap=recipe["min_gap"], metric_threshold=recipe["metric_threshold"],
                        motion_threshold=recipe["motion_threshold"])
        if len(ds) != 2:
            fail(f"the synthetic preference dataset gave {len(ds)} pairs, expected 2")
        batches = [collate([ds[i % len(ds)]]) for i in range(mini_steps + 1)]
    if "image_latent" not in batches[0]:
        fail("the Wan preference batches carry no image_latent")
    log(f"[wan-train] {what}; recipe Wan2.2-TI2V-5B: batch {recipe['batch_size']}, accumulate "
        f"{tcfg.accumulate_grad_batches}, LoRA r {tcfg.lora_rank} / alpha {tcfg.lora_alpha} "
        f"({n_lora / 1e6:.2f} M f32 params), lr {tcfg.learning_rate}, warmup "
        f"{tcfg.warmup_steps}, max {tcfg.max_steps}, clip {tcfg.gradient_clip_val}, beta "
        f"{tcfg.beta}, remat {tcfg.remat}; {len(ds)} pairs, latents "
        f"{tuple(batches[0]['x_win'].shape)}, image_latent "
        f"{tuple(batches[0]['image_latent'].shape)}, prompt_emb "
        f"{tuple(batches[0]['prompt_emb'].shape)}")

    b_norms, step_ms, metrics_log = [], [], []
    zero_launches()
    for i in range(mini_steps):
        gen = torch.Generator(device="cuda").manual_seed(20 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i], generator=gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        m = {k: float(v) for k, v in metrics.items()}
        metrics_log.append(m)
        b_norms.append(sum(float(ab["lora_B"].detach().abs().max())
                           for ab in state.lora.values()))
        log(f"[wan-train] mini-step {i + 1}: {step_ms[-1]:.1f} ms, " + json.dumps(m)
            + f", max|LoRA B| summed over targets {b_norms[-1]:.3e}")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_layers
    want_fwd, want_bwd = mini_steps * 6 * 2 * L, mini_steps * 2 * 2 * L
    want = dict.fromkeys(launches, 0)
    want.update(flash_attn_fwd_d128=want_fwd, flash_attn_bwd_d128=want_bwd)
    log(f"[wan-train] launches {json.dumps(launches)}; expected flash_attn_fwd_d128 "
        f"{mini_steps} mini-steps x 6 forwards (2 reference, 2 policy, 2 remat recomputes) x "
        f"({L} self + {L} cross) = {want_fwd}, flash_attn_bwd_d128 {mini_steps} x 2 policy "
        f"backwards x {2 * L} = {want_bwd}, every other 0; peak allocated {peak_gb:.2f} GB")
    if not all(math.isfinite(v) for m in metrics_log for v in m.values()):
        fail("non-finite Wan train metrics")
    if set(metrics_log[0]) != {"loss", "reward_margin", "reward_accuracy", "grad_norm"}:
        fail(f"the Wan train step returned metrics {sorted(metrics_log[0])}")
    if not (b_norms[1] == 0.0 and b_norms[-1] > 0.0):
        fail(f"LoRA B: expected zero after update 1 (lr schedule(0) = 0) and off zero "
             f"after update 2, got {b_norms}")
    if launches != want:
        fail("the Wan train path did not run every attention through K6 and K7")
    ev = eval_step(state, batches[0], generator=torch.Generator(device="cuda").manual_seed(3))
    if not all(math.isfinite(float(v)) for v in ev.values()):
        fail("non-finite Wan eval metrics")
    profile = profile_device_time("one Wan train mini-step (profiled)", lambda: train_step(
        state, batches[mini_steps], generator=torch.Generator(device="cuda").manual_seed(9)))
    del model, state, lora
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "update_ms": [step_ms[i] + step_ms[i + 1] for i in range(0, mini_steps - 1, 2)],
            "peak_gb": peak_gb, "profile": profile, "metrics": metrics_log}


# ---------------------------------------------------------------------------
# The Wan VAE, Wan sampling, the encode leg and Wan training from files
# ---------------------------------------------------------------------------

# the Wan VAE in f32 with TF32 off on the card and on the CPU: the two sum the
# convolutions in other orders, so outputs differ by f32 rounding; a fault
# moves them by their own size
WAN_VAE_REL = 1e-4


def small_wan_vae_config():
    """Wan2.2's VAE (z 48, 2 x 2 patchify, 4 scales, temporal resampling at
    two of them, mid attention) at a fifth of its widths."""
    import dataclasses

    from videogpa_torch.models.wan import WanConfig

    return dataclasses.replace(WanConfig.ti2v_5b(), vae_base_ch=32, vae_dec_base_ch=48)


def phase_slice_wan_vae() -> None:
    """A small Wan VAE on the card in f32 against the CPU on the same weights
    and latent statistics: encode (posterior mean, and a sample with the
    noise injected) and decode at T = 1 and 9, in the streaming and the
    full-sequence forms."""
    import torch

    from videogpa_torch.models.wan import wan_vae_decode, wan_vae_encode, wan_vae_init

    cfg = small_wan_vae_config()
    gen = torch.Generator().manual_seed(60)
    ref = wan_vae_init(cfg, gen, device="cpu")
    with torch.no_grad():
        ref.latents_mean.normal_(0.0, 0.3, generator=gen)
        ref.latents_std.uniform_(0.8, 1.5, generator=gen)
    dev = wan_vae_init(cfg, device="cuda")
    dev.load_state_dict(ref.state_dict())
    H, W, z = 64, 96, cfg.vae_z_dim
    zero_launches()
    errs = {}
    for T in (1, 9):
        t_lat = 1 + (T - 1) // 4
        video = torch.rand(1, 3, T, H, W, generator=gen) * 2 - 1
        noise = torch.randn(1, z, t_lat, H // 16, W // 16, generator=gen)
        lat = torch.randn(1, z, t_lat, H // 16, W // 16, generator=gen)
        outs = {}
        for stream in (True, False):
            form = "stream" if stream else "full"
            cases = {
                f"encode {form}": lambda m, d: wan_vae_encode(m, video.to(d), cfg, stream=stream),
                f"encode sample {form}": lambda m, d: wan_vae_encode(
                    m, video.to(d), cfg, noise=noise.to(d), sample=True, stream=stream),
                f"decode {form}": lambda m, d: wan_vae_decode(m, lat.to(d), cfg, stream=stream),
            }
            for case, fn in cases.items():
                want = fn(ref, "cpu")
                got = fn(dev, "cuda")
                torch.cuda.synchronize()
                errs[f"T={T} {case}"] = _rel(got, want)
                outs[case] = got
                if not (bool(torch.isfinite(got).all()) and got.shape == want.shape
                        and errs[f"T={T} {case}"] <= WAN_VAE_REL):
                    fail(f"the small Wan VAE's {case} at T={T} on the card disagrees with the "
                         f"CPU: rel-norm error {errs[f'T={T} {case}']:.3e}")
        for case in ("encode", "encode sample", "decode"):
            errs[f"T={T} {case} stream vs full on the card"] = _rel(
                outs[f"{case} stream"], outs[f"{case} full"].cpu())
    log(f"[slice_wan_vae] small Wan VAE (z {z}, encoder base {cfg.vae_base_ch}, decoder base "
        f"{cfg.vae_dec_base_ch}, {H}x{W}) f32 on the card vs the CPU: rel-norm errors "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {WAN_VAE_REL})")
    if max(errs.values()) > WAN_VAE_REL:
        fail("the Wan VAE's streaming and full-sequence forms disagree on the card")
    launches = read_launches()
    if any(launches.values()):
        fail(f"the Wan VAE launched an attention kernel: {launches}")


def meta_tflop(run) -> float:
    """The convolutions' and products' TFLOP of ``run()``, counted by
    ``torch.utils.flop_counter`` on meta tensors: nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    return counter.get_total_flops() / 1e12


def wan_vae_tflop(cfg, encode: bool, shape) -> float:
    """TFLOP of one Wan VAE call at ``shape`` (a video to encode or latents
    to decode)."""
    import torch

    from videogpa_torch.models.wan import WanVAE, wan_vae_decode, wan_vae_encode

    vae = WanVAE(cfg, device="meta")
    x = torch.empty(shape, device="meta")
    return meta_tflop(lambda: (wan_vae_encode if encode else wan_vae_decode)(vae, x, cfg))


def phase_wan_sample(dit, steps: int = 3):
    """``sample_ti2v`` at full width and depth: umT5-XXL (f32) encodes a
    prompt and the empty negative (2 x 512 ids), the Wan VAE (f32) encodes a
    704 x 1,280 image (posterior sample), ``steps`` UniPC steps of the [wan]
    phase's Wan2.2-TI2V-5B DiT (bf16) run the CFG pair with the clean first
    frame, and the VAE decodes the (1, 48, 21, 44, 80) latents to 81 frames,
    streaming, with the DiT, umT5 and the VAE resident. Returns the VAE and
    umT5 for [encode_files]."""
    import torch

    from videogpa_torch.models.t5 import T5Config, t5_encode, t5_encoder_init
    from videogpa_torch.models.wan import WanConfig, pipeline, sample_ti2v, wan_vae_init

    cfg, t5_cfg = WanConfig.ti2v_5b(), T5Config.umt5_xxl()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t5 = t5_encoder_init(t5_cfg, torch.Generator(device="cuda").manual_seed(61), device="cuda")
    vae = wan_vae_init(cfg, torch.Generator(device="cuda").manual_seed(62), device="cuda")
    torch.cuda.synchronize()
    n_t5 = sum(p.numel() for p in t5.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    log(f"[wan_sample] umT5-XXL ({t5_cfg.num_layers} layers, d_model {t5_cfg.d_model}, vocab "
        f"{t5_cfg.vocab_size}, per-layer bias, {n_t5 / 1e9:.3f} B params, f32) and the Wan VAE "
        f"({n_vae / 1e6:.1f} M params, f32) on the card in {time.perf_counter() - t0:.1f} s, "
        f"beside the [wan] DiT")
    gen = torch.Generator().manual_seed(63)
    ids = torch.randint(1, t5_cfg.vocab_size, (2, cfg.text_len), generator=gen)
    mask = torch.ones_like(ids)
    ids[1, 1:], mask[1, 1:] = 0, 0  # the empty negative: EOS, then padding
    ids, mask = ids.cuda(), mask.cuda()
    zero_launches()
    with torch.no_grad():
        t5_encode(t5, ids, mask)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = t5_encode(t5, ids, mask)
        torch.cuda.synchronize()
    t5_ms = 1e3 * (time.perf_counter() - t0)
    if emb.shape != (2, cfg.text_len, t5_cfg.d_model) or not bool(torch.isfinite(emb).all()):
        fail(f"umT5 embeddings {tuple(emb.shape)} not finite or wrong shape")
    log(f"[wan_sample] t5_encode 2 x {cfg.text_len} ids (umT5-XXL): {t5_ms:.1f} ms, embeddings "
        f"{tuple(emb.shape)} finite")

    timing = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[name] = time.perf_counter() - t1
            return out
        return run

    real = {n: getattr(pipeline, n) for n in ("wan_vae_encode", "wan_denoise_loop",
                                              "wan_vae_decode")}
    image = torch.rand(1, 3, 704, 1280, generator=torch.Generator(device="cuda").manual_seed(64),
                       device="cuda") * 2 - 1
    for n, fn in real.items():
        setattr(pipeline, n, timed(n, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = sample_ti2v(dit, vae, emb[:1], emb[1:], cfg, image=image, num_steps=steps,
                            generator=torch.Generator(device="cuda").manual_seed(65))
        torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
    total_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(launches, 0)
    want["flash_attn_fwd_d128"] = steps * 2 * cfg.num_layers
    decode_tflop = wan_vae_tflop(cfg, False, (1,) + WAN_LATENT)
    image_tflop = wan_vae_tflop(cfg, True, (1, 3, 1, 704, 1280))
    out = {"t5_ms": t5_ms, "image_encode_ms": 1e3 * timing["wan_vae_encode"],
           "step_ms": 1e3 * timing["wan_denoise_loop"] / steps,
           "decode_ms": 1e3 * timing["wan_vae_decode"], "total_s": total_s, "peak_gb": peak_gb,
           "decode_tflop": decode_tflop,
           "decode_tflops": decode_tflop / timing["wan_vae_decode"],
           "decode_bound_ms": 1e3 * 1e12 * decode_tflop / PEAK_F32_FLOPS,
           "image_encode_tflop": image_tflop, "launches": launches}
    log(f"[wan_sample] sample_ti2v 81f@704x1280, {steps} UniPC steps (CFG pair, ti2v): image "
        f"encode {out['image_encode_ms']:.1f} ms ({image_tflop:.2f} TFLOP), {out['step_ms']:.1f} "
        f"ms a step, decode {out['decode_ms']:.1f} ms ({decode_tflop:.1f} TFLOP, "
        f"{out['decode_tflops']:.1f} TFLOP/s, bound {out['decode_bound_ms'] / 1e3:.2f} s at the "
        f"f32 peak of {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), total {total_s:.3f} s; video "
        f"{tuple(video.shape)} {video.dtype}, finite {bool(torch.isfinite(video).all())}, "
        f"min {video.min().item():.4f} max {video.max().item():.4f}, std "
        f"{video.std().item():.4f}; peak allocated {peak_gb:.2f} GB with the DiT, umT5 and "
        f"the VAE resident; launches {json.dumps(launches)}; expected flash_attn_fwd_d128 "
        f"{steps} steps x ({cfg.num_layers} self + {cfg.num_layers} cross) = "
        f"{want['flash_attn_fwd_d128']}, every other 0 (umT5 and the VAE attend in plain "
        f"PyTorch)")
    if (tuple(video.shape) != (1, 3, 81, 704, 1280) or not bool(torch.isfinite(video).all())
            or float(video.abs().max()) > 1.0):
        fail("sample_ti2v's video is not finite in [-1, 1] at 81f@704x1280")
    if launches != want:
        fail(f"the Wan sampling path's launches {launches} are not K6's "
             f"{want['flash_attn_fwd_d128']} alone")
    del video, emb
    torch.cuda.empty_cache()
    out.update(vae=vae, t5=t5)
    return out


class _StubTokenizer:
    """Seeded ids of the asked length (the card's machine has no tokenizer
    files); the mask marks the first half as text."""

    def __init__(self, vocab: int, seed: int):
        import numpy as np

        self.vocab, self.rng = vocab, np.random.default_rng(seed)

    def __call__(self, text, max_length, **kw):
        import numpy as np

        ids = self.rng.integers(1, self.vocab, (1, max_length))
        mask = np.zeros((1, max_length), np.int64)
        mask[:, :max_length // 2] = 1
        return {"input_ids": ids * mask, "attention_mask": mask}


def _encode_from_memory(tag, cli, args, vae, t5, tokenizer, cfg, clips, images, lat_shape,
                        cond_shapes):
    """``cli.run`` (the encode CLI after loading) on one group whose video
    and image come from memory (``video_io.read_video_frames`` and the CLI's
    ``read_image`` replaced): no OpenCV on the card's machine. Checks the
    artifacts and returns the run's seconds, peak GB and per-call ms."""
    import numpy as np
    import torch

    from videogpa_torch.cli import encode as encode_cli
    from videogpa_torch.data import video_io

    real = (video_io.read_video_frames, encode_cli.read_image, cli.video_latent)
    calls = []

    def video_latent(*a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real[2](*a, **k)
        calls.append((a[1].shape[0], 1e3 * (time.perf_counter() - t1)))
        return out

    video_io.read_video_frames = lambda path, idx: clips[os.path.basename(path)][idx]
    encode_cli.read_image = lambda path, h, w: images[os.path.basename(path)]
    cli.video_latent = video_latent
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.run(args, vae, t5, tokenizer, cfg)
        torch.cuda.synchronize()
    finally:
        video_io.read_video_frames, encode_cli.read_image, cli.video_latent = real
    run_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out_dir = os.path.join(args.base_dir, args.output_dir)
    with np.load(os.path.join(out_dir, "latent_g0_0.npz")) as f:
        lat = f["data"]
    with np.load(os.path.join(out_dir, "condition_g0.npz")) as f:
        cond = {k: f[k].shape for k in f.files}
    with open(args.metadata) as f:
        paths = json.load(f)["groups"][0]["videos"][0]
    log(f"[encode_files] {tag}: cli run {run_s:.3f} s (video and image encodes "
        + ", ".join(f"{n} frames {ms:.1f} ms" for n, ms in calls)
        + f"), latent {lat.shape} finite {bool(np.isfinite(lat).all())} std "
        f"{float(lat.std()):.4f}, condition {cond}; metadata paths "
        f"{paths['latent_path']}, {paths['condition_path']}; peak allocated {peak_gb:.2f} GB; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if lat.shape != lat_shape or not np.isfinite(lat).all() or cond != cond_shapes:
        fail(f"{tag}: the encode artifacts are not finite or have the wrong shapes")
    if any(launches.values()):
        fail(f"{tag}: the encode path launched an attention kernel: {launches}")
    return {"run_s": run_s, "peak_gb": peak_gb, "encode_ms": calls, "launches": launches}


def _smooth_clip(T, H, W, seed):
    """(T, H, W, 3) uint8 frames of moving colour waves, made on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    phase = torch.rand(3, generator=g, device="cuda") * 6.28
    t = torch.arange(T, device="cuda", dtype=torch.float32)[:, None, None, None]
    y = torch.arange(H, device="cuda", dtype=torch.float32)[None, :, None, None]
    x = torch.arange(W, device="cuda", dtype=torch.float32)[None, None, :, None]
    f = torch.sin(x / 37.0 + y / 53.0 + 0.2 * t + phase) * 110 + 128
    return f.clamp(0, 255).to(torch.uint8).cpu().numpy()


def phase_encode_files_wan(vae, t5):
    """``cli.encode_wan``'s device part at full size, from memory: one group
    with an image and one 81-frame 704 x 1,280 clip through ``run`` with
    [wan_sample]'s umT5 and Wan VAE (the DiT resident beside them): the umT5
    condition (512 ids), the image latent and the streamed clip latent."""
    import shutil

    import torch

    from videogpa_torch.cli import encode_wan
    from videogpa_torch.models.wan import WanConfig

    cfg = WanConfig.ti2v_5b()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "encode_files")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    clip = _smooth_clip(81, 704, 1280, 70)
    meta = os.path.join(root, "meta_wan.json")
    with open(meta, "w") as f:
        json.dump({"groups": [{"group_id": "g0", "prompt": "waves", "image_path": "i0.png",
                               "videos": [{"video_path": "w0.mp4", "generation_id": 0}]}]}, f)
    args = encode_wan.parse_args(["--metadata", meta, "--base_dir", root,
                                  "--output_dir", "wan_latents"])
    out = _encode_from_memory(
        "Wan2.2-TI2V-5B (81f@704x1280, umT5-XXL f32, Wan VAE f32)", encode_wan, args, vae, t5,
        _StubTokenizer(t5.cfg.vocab_size, 71), cfg, {"w0.mp4": clip}, {"i0.png": clip[0]},
        (cfg.vae_z_dim, 21, 44, 80),
        {"encoder_hidden_states": (cfg.text_len, cfg.text_dim),
         "image_latent": (cfg.vae_z_dim, 1, 44, 80)})
    out["clip_tflop"] = wan_vae_tflop(cfg, True, (1, 3, 81, 704, 1280))
    log(f"[encode_files] Wan clip encode: {out['clip_tflop']:.1f} TFLOP, "
        f"{out['clip_tflop'] / (out['encode_ms'][-1][1] / 1e3):.1f} TFLOP/s")
    del vae, t5
    torch.cuda.empty_cache()
    return out


def phase_encode_files_cogvideox():
    """``cli.encode``'s device part at full size, from memory: T5-v1.1-XXL
    (f32) and the CogVideoX VAE (f32, as the encode script loads it) on
    random weights; one group with an image and one 49-frame 480 x 720 clip
    through ``run`` (the posterior sampled with the group's generator)."""
    import shutil

    import torch

    from videogpa_torch.cli import encode as encode_cli
    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, CogVideoXVAE, vae_encode, vae_init)
    from videogpa_torch.models.t5 import T5Config, t5_encoder_init

    cfg = CogVideoXConfig.cogvideox_5b_i2v()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "encode_files")
    torch.cuda.reset_peak_memory_stats()
    t5 = t5_encoder_init(T5Config.t5_v1_1_xxl(), torch.Generator(device="cuda").manual_seed(72),
                         device="cuda")
    vae = vae_init(cfg, torch.Generator(device="cuda").manual_seed(73), device="cuda")
    clip = _smooth_clip(49, 480, 720, 74)
    meta = os.path.join(root, "meta_cogvideox.json")
    with open(meta, "w") as f:
        json.dump({"groups": [{"group_id": "g0", "prompt": "waves", "image_path": "i0.png",
                               "videos": [{"video_path": "c0.mp4", "generation_id": 0}]}]}, f)
    args = encode_cli.parse_args(["--metadata", meta, "--base_dir", root,
                                  "--output_dir", "cogvideox_latents"])
    out = _encode_from_memory(
        "CogVideoX-I2V-5B (49f@480x720, T5-v1.1-XXL f32, VAE f32)", encode_cli, args, vae, t5,
        _StubTokenizer(t5.cfg.vocab_size, 75), cfg, {"c0.mp4": clip}, {"i0.png": clip[0]},
        (cfg.vae_latent_channels, 13, 60, 90),
        {"encoder_hidden_states": (cfg.max_text_seq_length, cfg.text_embed_dim),
         "image_embeds": (3, 480, 720)})
    meta_vae = CogVideoXVAE(cfg, device="meta")
    out["clip_tflop"] = meta_tflop(lambda: vae_encode(
        meta_vae, torch.empty(1, 3, 49, 480, 720, device="meta"), cfg,
        noise=torch.empty(1, cfg.vae_latent_channels, 13, 60, 90, device="meta")))
    log(f"[encode_files] CogVideoX clip encode: {out['clip_tflop']:.1f} TFLOP, "
        f"{out['clip_tflop'] / (out['encode_ms'][-1][1] / 1e3):.1f} TFLOP/s")
    del vae, t5
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out


def phase_wan_train_files(dit, steps: int = 2):
    """The Wan train leg from files at full width: three groups of two
    videos with .npz latents (48, 21, 44, 80) and conditions holding umT5
    embeddings (512, 4096) and the first frame's ``image_latent``;
    ``run_recipe("Wan2.2-TI2V-5B", config)`` runs ``train_wan_dpo`` for
    ``steps`` steps with validation on 1 pair and a checkpoint at the last
    step, then resumes to ``steps + 1``; the exported PEFT LoRA is read back
    and held against the last checkpoint's. ``load_wan`` is handed the [wan]
    phase's DiT (bf16, as the trainer loads it) in memory."""
    import shutil

    import numpy as np
    import torch

    import videogpa_torch.cli.train_dpo as train_cli
    from videogpa_torch.models.wan import WanConfig
    from videogpa_torch.train.lora import import_peft
    from videogpa_torch.train.recipes import build_config, run_recipe

    cfg = WanConfig.ti2v_5b()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "wan_train_files")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    os.makedirs(os.path.join(data_dir, "latents"))
    rng = np.random.default_rng(0)
    groups = []
    for g in range(3):
        cond = f"latents/condition_g{g}.npz"
        np.savez(os.path.join(data_dir, cond),
                 encoder_hidden_states=rng.standard_normal((cfg.text_len, cfg.text_dim),
                                                           dtype=np.float32),
                 image_latent=rng.standard_normal((WAN_LATENT[0], 1) + WAN_LATENT[2:],
                                                  dtype=np.float32))
        videos = []
        for i, score in enumerate((0.2 + 0.1 * g, 0.7)):
            lat = f"latents/latent_g{g}_{i}.npz"
            np.savez(os.path.join(data_dir, lat),
                     data=rng.standard_normal(WAN_LATENT, dtype=np.float32))
            videos.append({"video_path": f"g{g}_{i}.mp4", "consistency_score": score,
                           "motion_norm": 0.1, "latent_path": lat, "condition_path": cond})
        groups.append({"group_id": f"g{g}", "prompt": f"prompt {g}", "videos": videos})
    with open(os.path.join(data_dir, "meta_data.json"), "w") as f:
        json.dump({"groups": groups}, f)
    config = build_config("Wan2.2-TI2V-5B", base_path=data_dir)
    config.update(output_dir=os.path.join(root, "out"), max_steps=steps,
                  checkpoint_every_n_steps=steps, log_every_n_steps=1, metric_threshold=None,
                  min_gap=0.0, motion_threshold=0.0, warmup_steps=1)
    log(f"[wan_train_files] 3 groups of 2 videos, latents {WAN_LATENT} and umT5 embeddings "
        f"({cfg.text_len}, {cfg.text_dim}) with an image_latent as .npz; recipe Wan2.2-TI2V-5B "
        f"(batch {config['batch_size']}, accumulate {config['accumulate_grad_batches']}, LoRA "
        f"r {config['lora_rank']}), max_steps {steps}, checkpoint every {steps}; load_wan is "
        f"handed the [wan] DiT in memory (tests/test_torch_wan_convert.py holds the loader)")
    real_load = train_cli.load_wan
    train_cli.load_wan = lambda *a, **k: dit
    out = {}
    try:
        for tag, max_steps in (("run", steps), ("resume", steps + 1)):
            config["max_steps"] = max_steps
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_recipe("Wan2.2-TI2V-5B", config)
            torch.cuda.synchronize()
            out[f"{tag}_s"] = time.perf_counter() - t0
            out[f"{tag}_launches"] = read_launches()
    finally:
        train_cli.load_wan = real_load
    with open(os.path.join(root, "out", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    steps_seen = [r["step"] for r in train]
    log(f"[wan_train_files] metrics.jsonl train records: " + json.dumps(
        [{k: r[k] for k in ("step", "time", "train/loss", "stats/samples_per_sec",
                            "stats/max_memory_gb")} for r in train]))
    if steps_seen != list(range(1, steps + 2)):
        fail(f"train_wan_dpo took steps {steps_seen}, expected 1..{steps} then {steps + 1} "
             "resumed")
    if not all(math.isfinite(r["train/loss"]) for r in train):
        fail("non-finite Wan train loss")
    L2 = 2 * cfg.num_layers  # self + cross attention a forward
    for tag, n in (("run", steps), ("resume", 1)):
        want = dict.fromkeys(out[f"{tag}_launches"], 0)
        want.update(flash_attn_fwd_d128=n * 6 * L2 + 4 * L2, flash_attn_bwd_d128=n * 2 * L2)
        log(f"[wan_train_files] {tag}: {out[f'{tag}_s']:.1f} s, launches "
            f"{json.dumps({k: v for k, v in out[f'{tag}_launches'].items() if v})}; expected "
            f"flash_attn_fwd_d128 {want['flash_attn_fwd_d128']}, flash_attn_bwd_d128 "
            f"{want['flash_attn_bwd_d128']} (6 forwards and 2 backwards of {L2} attentions a "
            f"step, 4 forwards a validation pair), every other 0")
        if out[f"{tag}_launches"] != want:
            fail(f"train_wan_dpo ({tag}) did not run every attention through K6 and K7")
    kept = sorted(json.load(open(os.path.join(root, "out", "checkpoints", "scores.json"))))
    state = torch.load(os.path.join(root, "out", "checkpoints", kept[-1], "state.pt"),
                       weights_only=True)
    lora = import_peft(os.path.join(root, "out", "final_lora"), cfg.num_layers,
                       block_prefix="blocks", device="cpu")
    with open(os.path.join(root, "out", "final_lora", "adapter_config.json")) as f:
        mapping = json.load(f)["auto_mapping"]
    same = state["step"] == steps + 1 and lora.keys() == state["lora"].keys() and all(
        torch.equal(lora[n][k], state["lora"][n][k]) for n in state["lora"]
        for k in ("lora_A", "lora_B"))
    log(f"[wan_train_files] checkpoints kept {kept}; import_peft(final_lora, "
        f"block_prefix='blocks') equals the trained LoRA of step {state['step']}: {same}; "
        f"auto_mapping {mapping}")
    if not same or mapping["base_model_class"] != "WanModel":
        fail("the exported Wan LoRA is not the trained one")
    out.update(step_ms=1e3 * (train[1]["time"] - train[0]["time"]),
               samples_per_sec=[r["stats/samples_per_sec"] for r in train],
               max_memory_gb=[r["stats/max_memory_gb"] for r in train], steps=steps_seen)
    del state, lora
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out


def phase_timing_wan(wan_shape, text_len):
    """K6 (bf16) and K7 alone at the Wan self- and cross-attention shapes,
    operands as the DiT feeds them, beside their bounds and SDPA on the same
    operands; K6 without and with LSE in turns (without, with, with,
    without); both kernels' achieved TFLOP/s, registers and shared memory,
    K7's query splits."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import (
        bwd_d128_splits, flash_attn_bwd_d128, flash_attn_fwd_d128)

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(71)
    B, N, H, D = wan_shape
    q = _proj_views(gen, B, N, H, D)
    for tag, Nk, iters in (("self", N, 10), ("cross", text_len, 50)):
        k, v = _proj_views(gen, B, Nk, H, D), _proj_views(gen, B, Nk, H, D)
        # K6: without LSE (sampling) and with it (training), in turns
        turns = [cuda_ms(lambda: flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=w),
                         iters=iters) for w in (False, True, True, False)]
        out[f"k6_{tag}_ms_turns"] = turns
        out[f"k6_{tag}_ms"] = 0.5 * (turns[0] + turns[3])
        out[f"k6_{tag}_lse_ms"] = 0.5 * (turns[1] + turns[2])
        out[f"k6_{tag}_library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), iters=iters)
        out[f"k6_{tag}_bound_ms"], out[f"k6_{tag}_bound_by"] = _bound(
            4.0 * B * H * N * Nk * D, 2.0 * B * H * D * (2 * N + 2 * Nk), PEAK_BF16_FLOPS)
        out[f"k6_{tag}_tflops"] = 4.0 * B * H * N * Nk * D / out[f"k6_{tag}_ms"] / 1e9
        o, lse = flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
        do = _proj_views(gen, B, N, H, D).contiguous()
        out[f"k7_{tag}_ms"] = cuda_ms(
            lambda: flash_attn_bwd_d128(q, k, v, o, lse, do, layout="bhnd"), iters=iters)
        # yardstick only: SDPA's backward on the same operands
        qt, kt, vt = (x.detach().requires_grad_(True) for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        out[f"k7_{tag}_library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(ot, (qt, kt, vt), do, retain_graph=True), iters=iters)
        # five Nq x Nk x D products per head: S, dV, dP, dQ, dK; q o dO dQ over
        # Nq rows, k v dK dV over Nk rows, LSE and delta
        flops = 10.0 * B * H * N * Nk * D
        nbytes = 2.0 * B * H * D * (4 * N + 4 * Nk) + 4.0 * B * H * N * 2
        out[f"k7_{tag}_bound_ms"], out[f"k7_{tag}_bound_by"] = _bound(flops, nbytes,
                                                                      PEAK_BF16_FLOPS)
        out[f"k7_{tag}_tflops"] = flops / out[f"k7_{tag}_ms"] / 1e9
        out[f"k7_{tag}_query_splits"] = bwd_d128_splits(B * H, N, Nk)[0]
        del k, v, o, lse, do, qt, kt, vt, ot
    attrs = _kernels.kernel_attrs("flash_attn_bwd_d128")
    out["k7_registers_at_launch"], out["k7_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    attrs = _kernels.kernel_attrs("flash_attn_fwd_d128")
    out["k6_registers_at_launch"], out["k6_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    del q
    torch.cuda.empty_cache()
    return out


def _bound(flops, nbytes, peak_flops):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate of their type and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _device_ms_per_call(fn, calls: int, name_part: str) -> float:
    """Device time a call of ``fn`` spent in kernels whose name holds
    ``name_part`` ("" for all), by torch.profiler over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and name_part in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if t is None else t
    return us / 1e3 / calls


def phase_timing_scorer(vggt_shape, cam_shape, vggt_global_shape):
    """K4, K6 (f32) and K5 alone at their main-path shapes, beside their
    bounds and one PyTorch call computing the same function; K4's achieved
    TFLOP/s, registers and shared memory; K6 f32's device time a call beside
    its time a call, and its time at the f32 scorer's frame and global
    rows."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.geometry.zbuffer_kernel import SENTINEL, scatter_min_u32
    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import flash_attn_fwd_f32, flash_attn_short

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(51)
    # K4: q, k, v as strided views of one packed projection, as the blocks feed it
    B, N, H, D = vggt_shape
    q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    out["k4_ms"] = cuda_ms(lambda: flash_attn_short(q, k, v), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # yardstick only
    out["k4_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=20)
    out["k4_bound_ms"], out["k4_bound_by"] = _bound(4.0 * B * H * N * N * D,
                                                     2.0 * 4 * B * N * H * D, PEAK_BF16_FLOPS)
    out["k4_tflops"] = 4.0 * B * H * N * N * D / out["k4_ms"] / 1e9
    # the two-pass softmax K4 had before computed QK^T twice: 1.5x the operations
    out["k4_two_pass_bound_ms"] = 1.5 * out["k4_bound_ms"]
    attrs = _kernels.kernel_attrs("flash_attn_short", D)
    out["k4_registers"], out["k4_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    del q, k, v, qt, kt, vt

    # K6 f32 at the camera head's shape: the time a call (1,000 back-to-back
    # calls, the wrapper's host path included, in turns with SDPA f32) and
    # the kernel's own device time (torch.profiler over 200 more calls)
    B, N, H, D = cam_shape
    q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def k6_f32():
        return flash_attn_fwd_f32(q, k, v)

    def sdpa_f32():
        return F.scaled_dot_product_attention(qt, kt, vt)

    turns = [cuda_ms(f, iters=1000) for f in (k6_f32, sdpa_f32, sdpa_f32, k6_f32)]
    out["k6_f32_per_call_ms"], out["k6_f32_library_per_call_ms"] = turns[::3], turns[1:3]
    out["k6_f32_ms"] = sum(turns[::3]) / 2
    out["k6_f32_library_ms"] = sum(turns[1:3]) / 2
    out["k6_f32_device_ms"] = _device_ms_per_call(k6_f32, 200, "attn_f32_kernel")
    out["k6_f32_library_device_ms"] = _device_ms_per_call(sdpa_f32, 200, "")
    out["k6_f32_bound_ms"], out["k6_f32_bound_by"] = _bound(
        4.0 * B * H * N * N * D, 4.0 * 4 * B * N * H * D, PEAK_F32_FLOPS)
    attrs = _kernels.kernel_attrs("flash_attn_fwd_f32", D)
    out["k6_f32_registers"], out["k6_f32_smem_bytes"] = attrs["registers"], attrs["smem_bytes"]
    del q, k, v, qt, kt, vt

    # K6 f32 at the f32 scorer's frame and global rows
    for tag, (B, N, H, D), iters in (("frame", vggt_shape, 5), ("global", vggt_global_shape, 2)):
        q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out[f"k6_f32_{tag}_ms"] = cuda_ms(lambda: flash_attn_fwd_f32(q, k, v), iters=iters,
                                          warmup=1)
        out[f"k6_f32_{tag}_library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=iters, warmup=1)
        out[f"k6_f32_{tag}_bound_ms"], out[f"k6_f32_{tag}_bound_by"] = _bound(
            4.0 * B * H * N * N * D, 4.0 * 4 * B * N * H * D, PEAK_F32_FLOPS)
        out[f"k6_f32_{tag}_tflops"] = 4.0 * B * H * N * N * D / out[f"k6_f32_{tag}_ms"] / 1e9
        del q, k, v, qt, kt, vt
    attrs = _kernels.kernel_attrs("flash_attn_fwd_f32", D)
    out["k6_f32_d64_registers"], out["k6_f32_d64_smem_bytes"] = (attrs["registers"],
                                                               attrs["smem_bytes"])

    # K5 on one clip's packed-key stream: the kernel alone (fill + launch, on
    # int32 images of the keys), the wrapper, and scatter_reduce_ "amin"
    lin, key, n_slots, _ = zbuffer_stream()
    lin32 = lin.to(torch.int32)
    key32 = torch.where(key >= 2 ** 31, key - 2 ** 32, key).to(torch.int32)
    buf = torch.empty(n_slots, dtype=torch.int32, device="cuda")
    fn = _kernels.kernel("scatter_min_u32")
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        buf.fill_(-1)
        fn(lin32.data_ptr(), key32.data_ptr(), buf.data_ptr(), lin32.numel(), stream)

    out["k5_ms"] = cuda_ms(raw, iters=20)
    out["k5_wrapper_ms"] = cuda_ms(lambda: scatter_min_u32(lin, key, n_slots), iters=20)
    buf64 = torch.full((n_slots,), SENTINEL, dtype=torch.int64, device="cuda")
    out["k5_library_ms"] = cuda_ms(lambda: buf64.scatter_reduce_(0, lin, key, reduce="amin"),
                                   iters=20)
    live = int((key != SENTINEL).sum())
    out["k5_updates"], out["k5_live_updates"] = lin.numel(), live
    out["k5_bound_ms"], out["k5_bound_by"] = _bound(
        float(lin.numel()), 8.0 * lin.numel() + 4.0 * n_slots, PEAK_F32_FLOPS)
    out["k5_updates_per_s"] = lin.numel() / (out["k5_ms"] / 1e3)
    del lin, key, lin32, key32, buf, buf64
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The int8 inference mode: K8, K9, W8A8 linears
# ---------------------------------------------------------------------------

# quantise + kernel against exact f32 attention: the JAX tests' limits
# (tests/test_ops.py::test_int8_qk_close_to_reference)
INT8_E2E_COS, INT8_E2E_REL = 0.999, 0.02
# quantize_qk_int8 and the weight and activation quantisers on the card
# against the CPU: the same f32 arithmetic with true divisions on both, but a
# sum taken in another order (K's mean) or a product contracted into an fma
# can move a value by an ulp and flip an integer at a rounding tie
INT8_FLIP_SHARE = 1e-3


def _int8_case(gen, B, Nq, Nk, H, D, layout, q_scale=1.0, k_shift=0.5):
    """bf16 q, k, v with a non-zero mean in K (what the centring removes)."""
    import torch

    q, k, v = _attn_case(gen, B, Nq, Nk, H, D, layout, q_scale=q_scale)
    return q, (k.float() + k_shift).to(torch.bfloat16), v


def _int8_full(tag, label, fn, q, k, v, chunk: int = 4):
    """An int8-QK kernel against its plain version on a full-size bnhd
    problem, given the same quantised operands; the plain version needs an
    (N, N) f32 score matrix per head, so it runs over chunks of ``chunk``
    heads covering every head. Also returns the quantised path's distance to
    exact f32 attention on the first chunk. Returns (max |dO|, plain ms
    summed over the chunks)."""
    import torch

    from videogpa_torch.ops.attention import (
        flash_attn_fwd_reference, flash_attn_int8_reference, quantize_qk_int8)

    B, _, H, _ = q.shape
    q8, sq, k8, sk = quantize_qk_int8(q, k, "bnhd")
    o = fn(q8, sq, k8, sk, v, layout="bnhd")
    plain_ms, worst, atols = 0.0, 0.0, []
    for b in range(B):
        for h in range(0, H, chunk):
            sl = (slice(b, b + 1), slice(None), slice(h, h + chunk))
            ro, ms = _timed(lambda: flash_attn_int8_reference(
                q8[sl], sq[sl], k8[sl], sk[sl], v[sl], "bnhd"))
            plain_ms += ms
            err, atol, ok = _check_o(o[sl], ro)
            atols.append(atol)
            worst = max(worst, err)
            if not ok:
                fail(f"{fn.__name__} disagrees at the {label}, batch {b}, heads {h}..")
            del ro
    sl = (slice(0, 1), slice(None), slice(0, chunk))
    exact, _ = flash_attn_fwd_reference(q[sl].float(), k[sl].float(), v[sl].float(), "bnhd")
    cos, rel = _cos_rel(o[sl].float(), exact)
    log(f"[parity-int8] {tag} {label} bnhd, all {B * H} heads in chunks of {chunk}: max|dO| "
        f"{worst:.3e} (atol {min(atols):.2e}..{max(atols):.2e} + rtol {O_RTOL}) ok; plain "
        f"version {plain_ms:.1f} ms over the chunks; heads 0-{chunk - 1} against exact f32 "
        f"attention: cosine {cos:.6f}, rel-L2 {rel:.4f} (limits {INT8_E2E_COS}, {INT8_E2E_REL})")
    if not (cos > INT8_E2E_COS and rel < INT8_E2E_REL):
        fail(f"{fn.__name__} at the {label} is far from exact attention")
    del o, q8, sq, k8, sk
    torch.cuda.empty_cache()
    return worst, plain_ms


def _cos_rel(got, want):
    a, b = got.double().ravel(), want.double().ravel()
    return (a @ b / (a.norm() * b.norm())).item(), ((a - b).norm() / b.norm()).item()


def phase_parity_int8(dit_shape, vggt_global_shape, wan_shape):
    """K8 and K9 against their plain version on the same quantised operands,
    and quantise + kernel against exact f32 attention. Returns (K8 max |dO|,
    K9 max |dO|, K8 plain ms at the DiT shape, K9 plain ms at the Wan shape)."""
    import torch

    from videogpa_torch.ops.attention import (
        flash_attn_int8, flash_attn_int8_d128, flash_attn_int8_reference, mha_reference,
        quantize_qk_int8)

    gen = torch.Generator(device="cuda").manual_seed(81)
    packed = (torch.randn(1, 640, 3, 4, 64, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    k8_cases = [
        ("ragged N=300 bnhd D=64", "bnhd", _int8_case(gen, 2, 300, 300, 4, 64, "bnhd")),
        ("cross Nq=300 Nk=777 bhnd D=64", "bhnd", _int8_case(gen, 1, 300, 777, 3, 64, "bhnd")),
        ("cross Nq=1000 Nk=37 bnhd D=64", "bnhd", _int8_case(gen, 1, 1000, 37, 2, 64, "bnhd")),
        ("D=16 N=517 bnhd", "bnhd", _int8_case(gen, 2, 517, 517, 2, 16, "bnhd")),
        ("D=16 N=517 bhnd", "bhnd", _int8_case(gen, 2, 517, 517, 2, 16, "bhnd")),
        ("D=32 N=517 bhnd", "bhnd", _int8_case(gen, 2, 517, 517, 2, 32, "bhnd")),
        ("D=32 N=517 bnhd", "bnhd", _int8_case(gen, 2, 517, 517, 2, 32, "bnhd")),
        ("K with mean 3 N=300 D=64", "bnhd",
         _int8_case(gen, 1, 300, 300, 2, 64, "bnhd", k_shift=3.0)),
        ("extreme logits q*1e3 N=300 D=64", "bnhd",
         _int8_case(gen, 1, 300, 300, 2, 64, "bnhd", q_scale=1e3)),
        ("strided views of packed qkv N=640", "bnhd", packed.unbind(2)),
        ("strided (B, H, N, D) views of projections Nq=333 Nk=512 D=64", "bhnd",
         (_proj_views(gen, 2, 333, 3, 64), _proj_views(gen, 2, 512, 3, 64),
          _proj_views(gen, 2, 512, 3, 64))),
        # past CUDA's grid y limit of 65,535: K8's persistent grid takes any B*H
        ("B*H = 2 x 33,000 = 66,000 N=40 bnhd D=64", "bnhd",
         _int8_case(gen, 2, 40, 40, 33000, 64, "bnhd")),
    ]
    k9_cases = [
        ("ragged N=300 bnhd D=128", "bnhd", _int8_case(gen, 2, 300, 300, 3, 128, "bnhd")),
        ("cross Nq=100 Nk=777 bhnd D=128", "bhnd", _int8_case(gen, 1, 100, 777, 2, 128, "bhnd")),
        ("extreme logits q*1e3 N=300 D=128", "bnhd",
         _int8_case(gen, 1, 300, 300, 2, 128, "bnhd", q_scale=1e3)),
        ("strided (B, H, N, D) views of projections Nq=333 Nk=512 D=128", "bhnd",
         (_proj_views(gen, 2, 333, 3, 128), _proj_views(gen, 2, 512, 3, 128),
          _proj_views(gen, 2, 512, 3, 128))),
        ("B*H = 2 x 33,000 = 66,000 N=24 bnhd D=128", "bnhd",
         _int8_case(gen, 2, 24, 24, 33000, 128, "bnhd")),
    ]
    errs = {"K8": [], "K9": []}
    for tag, fn, cases in (("K8", flash_attn_int8, k8_cases), ("K9", flash_attn_int8_d128,
                                                               k9_cases)):
        for name, layout, (q, k, v) in cases:
            ops = quantize_qk_int8(q, k, layout)
            o = fn(*ops, v, layout=layout)
            err, atol, ok = _check_o(o, flash_attn_int8_reference(*ops, v, layout))
            line = (f"[parity-int8] {tag} {name}: max|dO| {err:.3e} (atol {atol:.2e} + rtol "
                    f"{O_RTOL}) {'ok' if ok else 'MISMATCH'}")
            if not name.startswith("extreme"):
                # against exact attention; with q x 1e3 the softmax is one-hot
                # and a quantised argmax may differ from the exact one
                qq, kk, vv = ((x.transpose(1, 2) if layout == "bnhd" else x).float()
                              for x in (q, k, v))
                oo = o.transpose(1, 2) if layout == "bnhd" else o
                cos, rel = _cos_rel(oo.float(), mha_reference(qq, kk, vv))
                line += f"; against exact f32 attention cosine {cos:.6f}, rel-L2 {rel:.4f}"
                ok = ok and cos > INT8_E2E_COS and rel < INT8_E2E_REL
            log(line)
            if not ok:
                fail(f"{fn.__name__} disagrees on {name}")
            errs[tag].append(err)
    # int8 operands as strided views (q8 and k8 interleaved in one tensor)
    q, k, v = _int8_case(gen, 2, 300, 300, 4, 64, "bnhd")
    q8, sq, k8, sk = quantize_qk_int8(q, k, "bnhd")
    q8v, k8v = torch.stack([q8, k8], dim=2).unbind(2)
    sqv, skv = torch.stack([sq, sk], dim=-1).unbind(-1)
    same = torch.equal(flash_attn_int8(q8v, sqv, k8v, skv, v, layout="bnhd"),
                       flash_attn_int8(q8, sq, k8, sk, v, layout="bnhd"))
    log(f"[parity-int8] K8 strided int8 operands and scales (views of interleaved tensors) "
        f"equal to the dense ones bit for bit: {same}")
    if not same:
        fail("flash_attn_int8 reads strided int8 operands differently")
    del k8_cases, k9_cases, packed, q, k, v, q8, sq, k8, sk, q8v, k8v, sqv, skv

    # the main paths' shapes at full size
    B, N, H, D = dit_shape
    q, k, v = _int8_case(gen, B, N, N, H, D, "bnhd")
    worst, k8_plain_ms = _int8_full("K8", f"DiT shape {dit_shape}", flash_attn_int8, q, k, v)
    errs["K8"].append(worst)
    del q, k, v
    B, N, H, D = vggt_global_shape
    q, k, v = (torch.randn(B, N, 3, H, D, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16).unbind(2)
    worst, _ = _int8_full("K8", f"VGGT global shape {vggt_global_shape} (v a strided view)",
                          flash_attn_int8, q.contiguous(), k.contiguous(), v)
    errs["K8"].append(worst)
    del q, k, v
    B, N, H, D = wan_shape
    q, k, v = _int8_case(gen, B, N, N, H, D, "bnhd")
    worst, k9_plain_ms = _int8_full("K9", f"Wan shape {wan_shape}", flash_attn_int8_d128,
                                    q, k, v)
    errs["K9"].append(worst)
    del q, k, v
    torch.cuda.empty_cache()
    return max(errs["K8"]), max(errs["K9"]), k8_plain_ms, k9_plain_ms


def phase_parity_quant(dit_shape):
    """The plain PyTorch passes of the int8 mode on the card against the CPU:
    ``quantize_qk_int8``, ``linear_w8a8`` and ``int8_matmul`` (bit for bit
    against int32 arithmetic), and the shapes the integer GEMM refuses."""
    import torch

    from videogpa_torch.ops.attention import quantize_qk_int8
    from videogpa_torch.ops.quant import (
        int8_matmul, linear_w8a8, quantize_activations, quantize_linear)

    gen = torch.Generator(device="cuda").manual_seed(82)

    def flips(a, b):
        d = (a.cpu().int() - b.int()).abs()
        return d.max().item(), (d != 0).float().mean().item()

    # quantize_qk_int8: 4 heads of the DiT shape, both layouts
    _, N, _, D = dit_shape
    for layout in ("bnhd", "bhnd"):
        q, k, _ = _int8_case(gen, 1, N, N, 4, D, layout)
        dev, cpu = quantize_qk_int8(q, k, layout), quantize_qk_int8(q.cpu(), k.cpu(), layout)
        (q_max, q_share), (k_max, k_share) = flips(dev[0], cpu[0]), flips(dev[2], cpu[2])
        s_rel = max(((dev[i].cpu() - cpu[i]).abs() / cpu[i]).max().item() for i in (1, 3))
        log(f"[parity-int8] quantize_qk_int8 (1, {N}, 4, {D}) {layout} card vs CPU: q8 differs "
            f"on {q_share:.2e} of entries (max {q_max}), k8 on {k_share:.2e} (max {k_max}), "
            f"limit {INT8_FLIP_SHARE} by at most 1; scales max rel {s_rel:.2e} (limit 1e-5)")
        if max(q_max, k_max) > 1 or max(q_share, k_share) > INT8_FLIP_SHARE or s_rel > 1e-5:
            fail("quantize_qk_int8 on the card disagrees with the CPU")

    # int8_matmul against int32 arithmetic on the CPU, bit for bit
    a = torch.randint(-127, 128, (300, 3072), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-127, 128, (1024, 3072), generator=gen, device="cuda").to(torch.int8)
    a[0], b[0] = 127, -127  # the extreme sum
    same = torch.equal(int8_matmul(a, b).cpu(), a.cpu().int() @ b.cpu().int().T)
    log(f"[parity-int8] int8_matmul (300 x 3072) @ (1024 x 3072)^T on the card equals int32 "
        f"arithmetic on the CPU bit for bit: {same}")
    if not same:
        fail("int8_matmul is not exact")
    # what torch._int_mm refuses on the card, and that int8_matmul raises there
    for what, (M, K, N_) in (("16 rows", (16, 64, 64)), ("inner width 60", (32, 60, 64)),
                             ("output width 60", (32, 64, 60))):
        x = torch.ones((M, K), dtype=torch.int8, device="cuda")
        w = torch.ones((N_, K), dtype=torch.int8, device="cuda")
        try:
            torch._int_mm(x, w.t())
            library = "accepts it"
        except RuntimeError as e:
            library = "refuses it (" + str(e).splitlines()[0][:90] + ")"
        try:
            int8_matmul(x, w)
            fail(f"int8_matmul took {what} on the card")
        except ValueError:
            pass
        log(f"[parity-int8] integer GEMM with {what}: torch._int_mm {library}; int8_matmul "
            f"raises ValueError")
    torch.cuda.synchronize()

    # linear_w8a8 at a DiT projection's width on the card against the CPU
    w = torch.randn(3072, 3072, generator=gen, device="cuda").to(torch.bfloat16) * 0.02
    bias = torch.randn(3072, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(2, 500, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    w8, ws = quantize_linear(w)
    w8c, wsc = quantize_linear(w.cpu())
    qx, sx = quantize_activations(x)
    qxc, sxc = quantize_activations(x.cpu())
    (w_max, w_share), (x_max, x_share) = flips(w8, w8c), flips(qx, qxc)
    y = linear_w8a8(x, w8, ws, bias)
    yc = linear_w8a8(x.cpu(), w8c, wsc, bias.cpu())
    err, atol, ok = _check_o(y.cpu(), yc)
    exact = torch.nn.functional.linear(x.float(), w.float(), bias.float())
    cos, rel = _cos_rel(y.float(), exact)
    log(f"[parity-int8] linear_w8a8 (2, 500, 3072) -> 3072 bf16 card vs CPU: weights differ on "
        f"{w_share:.2e} of entries (max {w_max}), activations on {x_share:.2e} (max {x_max}), "
        f"limit {INT8_FLIP_SHARE} by at most 1; max|dy| {err:.3e} (atol {atol:.2e} + rtol "
        f"{O_RTOL}); against the f32 layer cosine {cos:.6f}, rel-L2 {rel:.4f} (limits 0.9999, "
        f"0.02)")
    if not (ok and max(w_max, x_max) <= 1 and max(w_share, x_share) <= INT8_FLIP_SHARE
            and cos > 0.9999 and rel < 0.02 and torch.allclose(ws.cpu(), wsc, rtol=1e-6)
            and torch.allclose(sx.cpu(), sxc, rtol=1e-6)):
        fail("linear_w8a8 on the card disagrees with the CPU")


# [slice_int8]: the int8 mode on the card against the same mode on the CPU
# with the same int8 weights. The tiny DiT runs bf16 on the card against f32
# on the CPU, as phase_slice does (limit 5e-2 of the largest value): its
# activations quantise from bf16 there, so integers differ as bf16 rounding
# moves them, which stays inside bf16's own error. The tiny scorer runs f32 on
# both; what differs is summation order and the few integers that flip at a
# tie, each moving an output by ~1e-3 of its scale at these widths (32): pose
# and dense outputs are held to INT8_SLICE_TOL, scores to the z-buffer flips
# that follows from it.
INT8_SLICE_TOL, INT8_SLICE_FLIPS = 2e-3, 50


def _load_like(dev, ref) -> None:
    """Copy ``ref``'s state into ``dev`` tensor by tensor in ``dev``'s dtypes,
    so that both hold the same int8 weights and scales."""
    dtypes = {k: v.dtype for k, v in dev.state_dict().items()}
    dev.load_state_dict({k: v.to(dtypes[k]) for k, v in ref.state_dict().items()})


def phase_slice_int8() -> None:
    import dataclasses

    import numpy as np
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_forward, dit_init
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init
    from videogpa_torch.ops.quant import quantize_dit_int8, quantize_scorer_params
    from videogpa_torch.reward import VideoProcessor

    # tiny DiT at head_dim 16: bhnd reaches K8, bnhd (80-key rows) K4
    cfg = CogVideoXConfig.tiny()
    ref = dit_init(cfg, torch.Generator().manual_seed(2), device="cpu").requires_grad_(False)
    dev = dit_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
    ref.load_state_dict({k: v.float().cpu() for k, v in dev.state_dict().items()})
    quantize_dit_int8(ref), quantize_dit_int8(dev)
    _load_like(dev, ref)
    same_w = all(torch.equal(a.cpu(), b) for (_, a), (_, b) in
                 zip(sorted(dev.named_buffers()), sorted(ref.named_buffers())))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                    cfg.sample_width, generator=gen)
    txt = torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)
    t = torch.tensor([100, 900])
    for layout, kernel in (("bhnd", "flash_attn_int8"), ("bnhd", "flash_attn_short")):
        want = dit_forward(ref, x, txt, t, compute_dtype=torch.float32, attn_layout=layout,
                           attn_impl="flash_int8")
        zero_launches()
        got = dit_forward(dev, x.cuda(), txt.cuda(), t.cuda(), attn_layout=layout,
                          attn_impl="flash_int8").cpu()
        launches = read_launches()
        expect = dict.fromkeys(launches, 0)
        expect[kernel] = cfg.num_layers
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"[slice-int8] tiny DiT (head_dim {cfg.head_dim}) int8 mode, {layout}: bf16 on the "
            f"card vs f32 on the CPU, int8 weights equal: {same_w}; max|d|/max|ref| {rel:.3e} "
            f"(limit 5e-2); launches " + json.dumps({k: v for k, v in launches.items() if v}))
        if launches != expect:
            fail(f"the tiny int8 DiT ({layout}) did not launch {kernel} x {cfg.num_layers} alone")
        if not (same_w and torch.isfinite(got).all() and rel < 5e-2):
            fail("the tiny int8 DiT on the card disagrees with the CPU")

    # tiny VGGT scorer, f32 on both, through process_frames_batch
    vcfg = VGGTConfig.tiny()
    vref = vggt_init(vcfg, torch.Generator().manual_seed(8), device="cpu").eval()
    regular_camera_(vref)
    vdev = vggt_init(vcfg, device="cuda").eval()
    vdev.load_state_dict(vref.state_dict())
    (vref, impl), (vdev, _) = (quantize_scorer_params("vggt", vref),
                               quantize_scorer_params("vggt", vdev))
    _load_like(vdev, vref)
    lp_ref = lpips_init(torch.Generator().manual_seed(9), device="cpu")
    lp_dev = lpips_init(device="cuda")
    lp_dev.load_state_dict(lp_ref.state_dict())
    clips = synthetic_frames(2, 4, vcfg.img_size, seed=10)
    S, H, W = clips[0].shape[:3]
    imgs = torch.from_numpy(np.stack(clips)).float().permute(0, 1, 4, 2, 3) / 255.0
    with torch.no_grad():
        want = vggt_forward(vref, imgs, compute_dtype=torch.float32, attn_impl=impl)
        got = vggt_forward(vdev, imgs.cuda(), compute_dtype=torch.float32, attn_impl=impl)
    pose_err = (got["pose_enc"].cpu() - want["pose_enc"]).abs().max().item()
    dense = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max()).item()
             for k in ("depth", "depth_conf")}
    log(f"[slice-int8] tiny VGGT int8 mode f32 card vs CPU: max|d pose_enc| {pose_err:.2e}, "
        f"depth {dense['depth']:.2e}, conf {dense['depth_conf']:.2e} relative to the largest "
        f"value (limit {INT8_SLICE_TOL})")
    if pose_err > INT8_SLICE_TOL or max(dense.values()) > INT8_SLICE_TOL:
        fail("the tiny int8 VGGT forward on the card disagrees with the CPU")

    def score(model, lp, device):
        vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model, compute_dtype=torch.float32,
                            zbuffer_impl="packed", device=device, attn_impl=impl)
        return vp.process_frames_batch(clips, [0])

    got_s, want_s = score(vdev, lp_dev, "cuda"), score(vref, lp_ref, "cpu")
    flip = INT8_SLICE_FLIPS / (S * H * W)
    worst = {}
    for g, w in zip(got_s, want_s):
        for name, b in w[0].items():
            a = g[0][name]
            if name in ("MSE", "Consistency_Score"):
                lim = flip + 1e-5
            elif name == "PSNR":
                lim = 10 * np.log10(1 + flip / max(w[0]["MSE"], 1e-12)) + 1e-4
            else:
                lim = {"SSIM": 2e-2, "LPIPS": 5e-3}.get(name, INT8_SLICE_TOL)
            d = abs(a - b)
            worst[name] = max(worst.get(name, 0.0), d)
            if not (np.isfinite(a) and d <= lim):
                fail(f"tiny int8 scorer {name}: card {a} vs CPU {b} (limit {lim:.2e})")
    log(f"[slice-int8] tiny scorer int8 mode (2 clips x {S} frames at {H}^2) f32 card vs CPU, "
        f"max |d| per score: " + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})
        + f"; MSE limit {INT8_SLICE_FLIPS} flipped pixels = {flip + 1e-5:.2e}")

    # the small bf16 VGGT of phase_slice_vggt_bf16 in int8 mode: its 2,430-key
    # global rows reach K8 at head_dim 64 inside the model
    scfg = dataclasses.replace(VGGTConfig.tiny(), img_size=280, backbone_dim=128,
                               backbone_heads=2, embed_dim=128, num_heads=2)
    sdev = vggt_init(scfg, torch.Generator(device="cuda").manual_seed(12), device="cuda",
                     dtype=torch.bfloat16).eval()
    regular_camera_(sdev)
    sdev.camera_head.float()
    sref = vggt_init(scfg, device="cpu").eval()
    sref.load_state_dict({k: v.float().cpu() for k, v in sdev.state_dict().items()})
    quantize_scorer_params("vggt", sdev), quantize_scorer_params("vggt", sref)
    _load_like(sdev, sref)
    imgs = torch.from_numpy(np.stack(synthetic_frames(1, 6, scfg.img_size, seed=12))
                            ).float().permute(0, 1, 4, 2, 3) / 255.0
    with torch.no_grad():
        want = vggt_forward(sref, imgs, compute_dtype=torch.float32, attn_impl=impl)
        zero_launches()
        got = vggt_forward(sdev, imgs.cuda(), compute_dtype=torch.bfloat16,
                           dpt_dtype=torch.bfloat16, attn_impl=impl)
        torch.cuda.synchronize()
    launches = read_launches()
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_attn_int8=scfg.depth, flash_attn_short=scfg.backbone_depth + scfg.depth,
                  flash_attn_fwd_f32=scfg.camera_trunk_depth * scfg.camera_iterations)
    pose_err = (got["pose_enc"].float().cpu() - want["pose_enc"]).abs().max().item()
    rel = {k: ((got[k].float().cpu() - want[k]).abs().max() / want[k].abs().max()).item()
           for k in ("depth", "depth_conf", "world_points", "world_points_conf")}
    log(f"[slice-int8] small VGGT ({scfg.img_size}^2, 6 frames, blocks 2 x 64) int8 mode, bf16 "
        f"trunk and DPT on the card vs f32 on the CPU: max|d pose_enc| {pose_err:.3e} (limit "
        f"{BF16_POSE_ATOL}), max|d| / max|ref| "
        + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
        + f" (limits {BF16_DENSE_RTOL}, world_points {BF16_POINTS_RTOL}); launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    if launches != expect:
        fail(f"the small int8 VGGT did not reach K8, K4 and K6 as expected {expect}")
    if not (pose_err <= BF16_POSE_ATOL and rel["world_points"] <= BF16_POINTS_RTOL
            and max(v for k, v in rel.items() if k != "world_points") <= BF16_DENSE_RTOL):
        fail("the small int8 VGGT on the card disagrees with the CPU")


# [main-int8]: the int8 run's final latents against the exact run's, same
# seeds, random weights. After 2 DPM steps most of a latent is the injected
# noise, which both runs share, so the floor is loose on purpose: it catches a
# broken int8 path (a wrong scale or a transposed weight gives cosine near 0
# in the model's output), not a drift.
MAIN_INT8_COS_FLOOR, MAIN_INT8_REL_CEIL = 0.99, 0.15


def phase_main_int8(exact_latents, num_requests: int = 2, steps: int = 2):
    """The CogVideoX-5B denoise path in int8 mode at full width and depth,
    with phase_main's seeds."""
    import torch

    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, SamplerSettings, denoise_loop, dit_init)
    from videogpa_torch.ops.quant import QuantLinear, quantize_dit_int8

    cfg = CogVideoXConfig.cogvideox_5b()
    dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                   dtype=torch.bfloat16).requires_grad_(False)
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_dit_int8(dit)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    after_gb = torch.cuda.memory_allocated() / 1e9
    n_q = sum(isinstance(m, QuantLinear) for m in dit.modules())
    log(f"[main-int8] quantize_dit_int8 in place: {n_q} linears (6 x {cfg.num_layers} layers) "
        f"in {quant_s:.2f} s; allocated {before_gb:.2f} GB in bf16 -> {after_gb:.2f} GB, peak "
        f"while quantising {quant_peak_gb:.2f} GB")
    if n_q != 6 * cfg.num_layers:
        fail("quantize_dit_int8 did not swap 6 linears a layer")

    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm")
    latent_shape = (1, cfg.sample_frames, cfg.vae_latent_channels,
                    cfg.sample_height, cfg.sample_width)
    torch.cuda.reset_peak_memory_stats()
    request_s, drift = [], []
    zero_launches()
    for r in range(num_requests):
        gen = torch.Generator(device="cuda").manual_seed(100 + r)
        text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim,
                           generator=gen, device="cuda")
        negative = torch.randn(text.shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = denoise_loop(dit, text, negative, settings, latent_shape, generator=gen,
                           attn_impl="flash_int8")
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t0)
        if tuple(lat.shape) != latent_shape or not bool(torch.isfinite(lat).all()):
            fail(f"int8 request {r}: latents {tuple(lat.shape)} not finite or wrong shape")
        drift.append(_cos_rel(lat.float().cpu(), exact_latents[r]))
        log(f"[main-int8] request {r}: {steps} DPM steps in {request_s[-1]:.3f} s, latents "
            f"finite, std {lat.float().std().item():.4f}; against the exact run's latents: "
            f"cosine {drift[-1][0]:.6f}, rel-L2 {drift[-1][1]:.4f} (floor "
            f"{MAIN_INT8_COS_FLOOR}, ceiling {MAIN_INT8_REL_CEIL})")
        if not (drift[-1][0] > MAIN_INT8_COS_FLOOR and drift[-1][1] < MAIN_INT8_REL_CEIL):
            fail(f"int8 request {r} is far from the exact run")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = num_requests * steps * cfg.num_layers
    want = dict.fromkeys(launches, 0)
    want["flash_attn_int8"] = expected
    log(f"[main-int8] launches {json.dumps(launches)}; expected flash_attn_int8 {num_requests} "
        f"requests x {steps} steps x {cfg.num_layers} layers = {expected}, every other 0 "
        f"(flash_attn_fwd 0); peak allocated in the loop {peak_gb:.2f} GB")
    if launches != want:
        fail("the int8 denoise path did not run every attention through K8 alone")
    settings1 = SamplerSettings(num_inference_steps=1, sampler="dpm")
    profile = profile_device_time("one int8 denoise step (profiled)", lambda: denoise_loop(
        dit, text, negative, settings1, latent_shape, attn_impl="flash_int8",
        generator=torch.Generator(device="cuda").manual_seed(5)))
    del dit
    torch.cuda.empty_cache()
    return {"launches": launches, "request_s": request_s,
            "step_ms": [1e3 * s / steps for s in request_s], "peak_gb": peak_gb,
            "quantise_peak_gb": quant_peak_gb, "quantise_s": quant_s,
            "weights_gb": [before_gb, after_gb], "drift_cos_rel": drift, "profile": profile}


def phase_scorer_int8(exact_results, num_batches: int = 3, K: int = 4, S: int = 10):
    """The VGGT-1B scorer in int8 mode at full width, on phase_scorer's
    weights and frames; prints each score's drift against the exact scorer."""
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.models.vggt import VGGTConfig, vggt_init
    from videogpa_torch.ops.quant import QuantLinear, quantize_scorer_params
    from videogpa_torch.reward import VideoProcessor

    cfg = VGGTConfig()
    model = vggt_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                      dtype=torch.bfloat16).eval()
    regular_camera_(model)
    model.camera_head.float()
    model, impl = quantize_scorer_params("vggt", model)
    lp = lpips_init(torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n_q = sum(isinstance(m, QuantLinear) for m in model.modules())
    log(f"[scorer-int8] quantize_scorer_params: {n_q} linears (4 x {2 * cfg.depth} frame and "
        f"global blocks) int8, attn_impl {impl!r}; DINOv2, camera head, DPT and LPIPS as before")
    if n_q != 4 * 2 * cfg.depth:
        fail("quantize_vggt_int8 did not swap 4 linears a block")
    vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model, compute_dtype=torch.bfloat16,
                        dpt_chunk=8, zbuffer_impl="packed", device="cuda", attn_impl=impl)
    batches = [synthetic_frames(K, S, cfg.img_size, seed=100 + b) for b in range(num_batches)]

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    batch_ms, all_results = [], []
    for b, clips in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_results.append(vp.process_frames_batch(clips, [0]))
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        log(f"[scorer-int8] batch {b} ({'cold' if b == 0 else 'warm'}): {batch_ms[-1]:.1f} ms, "
            f"{K / (batch_ms[-1] / 6e4):.1f} clips/min; clip 0: "
            + json.dumps({k: round(v, 6) for k, v in all_results[-1][0][0].items()}))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_batch = {k: v / num_batches for k, v in launches.items()}
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attn_int8": cfg.depth,
                 "flash_attn_short": cfg.backbone_depth + cfg.depth,
                 "flash_attn_fwd_f32": cfg.camera_trunk_depth * cfg.camera_iterations,
                 "scatter_min_u32": K})
    log(f"[scorer-int8] launches per batch {json.dumps(per_batch)}; expected "
        f"{json.dumps(want)} (K8: the {cfg.depth} global blocks; K4: DINOv2 + frame blocks, "
        f"short rows stay exact; K6 f32: the camera head at head_dim 128 stays exact; "
        f"flash_attn_fwd 0); peak allocated {peak_gb:.2f} GB")
    if per_batch != want:
        fail("the int8 scorer did not run each attention and z-buffer through its kernel")
    drift = {}
    for got_b, want_b in zip(all_results, exact_results):
        for g, w in zip(got_b, want_b):
            for name, v in g[0].items():
                if not math.isfinite(v):
                    fail(f"non-finite int8 score {name} = {v}")
                d = abs(v - w[0][name])
                worst = drift.setdefault(name, {"max_abs": 0.0, "max_rel": 0.0})
                worst["max_abs"] = max(worst["max_abs"], d)
                worst["max_rel"] = max(worst["max_rel"], d / max(abs(w[0][name]), 1e-12))
    log("[scorer-int8] drift of each score against the exact scorer on the same frames "
        f"({num_batches * K} clips, random weights): "
        + json.dumps({k: {a: float(f"{b:.3e}") for a, b in v.items()} for k, v in drift.items()}))
    profile = profile_device_time("one int8 scorer batch (profiled)",
                                  lambda: vp.process_frames_batch(batches[-1], [0]))
    del vp, model, lp
    torch.cuda.empty_cache()
    return {"batch_ms": batch_ms, "clips_per_min": [K / (ms / 6e4) for ms in batch_ms],
            "peak_gb": peak_gb, "launches": launches, "per_batch": per_batch, "drift": drift,
            "profile": profile}


def phase_wan_int8(steps: int = 3):
    """The Wan2.2-TI2V-5B denoise path in int8 mode: W8A8 linears; at
    head_dim 128 ``flash_int8`` takes the exact kernel K6, as in the JAX
    package, so K9 is launched no time."""
    import torch

    from videogpa_torch.models.wan import wan_denoise_loop
    from videogpa_torch.ops.quant import QuantLinear, quantize_wan_int8

    cfg, model, _ = _wan_5b()
    quantize_wan_int8(model)
    torch.cuda.empty_cache()
    n_q = sum(isinstance(m, QuantLinear) for m in model.modules())
    if n_q != 10 * cfg.num_layers:
        fail("quantize_wan_int8 did not swap 10 linears a layer")
    latent_shape = (1,) + WAN_LATENT
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(200)
    text = torch.randn(1, cfg.text_len, cfg.text_dim, generator=gen, device="cuda")
    negative = torch.randn(text.shape, generator=gen, device="cuda")
    image = torch.randn(1, WAN_LATENT[0], 1, *WAN_LATENT[2:], generator=gen, device="cuda")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = wan_denoise_loop(model, text, negative, latent_shape, num_steps=steps,
                           image_latent=image, ti2v=True, generator=gen,
                           attn_impl="flash_int8")
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(lat.shape) != latent_shape or not bool(torch.isfinite(lat).all()):
        fail("int8 wan request: latents not finite or of the wrong shape")
    if not torch.equal(lat[:, :, :1], image):
        fail("int8 wan request: the first latent frame is not the image latent")
    expected = steps * 2 * cfg.num_layers
    want = dict.fromkeys(launches, 0)
    want["flash_attn_fwd_d128"] = expected
    log(f"[wan-int8] {n_q} linears int8 (10 x {cfg.num_layers} layers); {steps} UniPC steps "
        f"(CFG pair, ti2v) in {request_s:.3f} s, latents finite, first frame kept; launches "
        f"{json.dumps(launches)}; expected flash_attn_fwd_d128 {steps} x ({cfg.num_layers} "
        f"self + {cfg.num_layers} cross) = {expected}, flash_attn_int8_d128 0; peak allocated "
        f"{peak_gb:.2f} GB")
    if launches != want:
        fail("the int8 Wan path did not run every attention through K6 alone")
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "request_s": request_s, "step_ms": 1e3 * request_s / steps,
            "peak_gb": peak_gb}


def _int8_bound(B, N, Nk, H, D):
    """(bound ms, what bounds it) of the int8-QK forward: QK^T over the int8
    peak plus PV over the bf16 peak, against q8 + k8 (1 byte), their f32
    scales, V and O (2 bytes) once over the HBM rate."""
    t_ops = 2.0 * B * H * N * Nk * D * (1 / PEAK_INT8_OPS + 1 / PEAK_BF16_FLOPS)
    t_bytes = B * H * (N * (D + 4 + 2 * D) + Nk * (D + 4 + 2 * D)) / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_timing_int8(dit_shape, vggt_global_shape, wan_shape):
    """K8 and K9 alone at their shapes beside their bounds, and beside the
    exact kernel at the same shape in the same phase (K1 for K8, K6 bf16 for
    K9), in turns exact / int8 / int8 / exact; TFLOP/s counting QK^T and PV,
    registers and shared memory; the quantiser of q and k; the W8A8 linear
    against the bf16 one at the DiT's fc1."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import (
        flash_attn_fwd, flash_attn_fwd_d128, flash_attn_int8, flash_attn_int8_d128,
        quantize_qk_int8)
    from videogpa_torch.ops.quant import (
        int8_matmul, linear_w8a8, quantize_activations, quantize_linear)

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(91)
    for tag, fn, exact, shape, iters in (
            ("k8", flash_attn_int8, flash_attn_fwd, dit_shape, 10),
            ("k8_vggt", flash_attn_int8, flash_attn_fwd, vggt_global_shape, 10),
            ("k9", flash_attn_int8_d128, flash_attn_fwd_d128, wan_shape, 5)):
        B, N, H, D = shape
        q, k, v = _int8_case(gen, B, N, N, H, D, "bnhd")
        ops = quantize_qk_int8(q, k, "bnhd")
        t = [cuda_ms(f, iters=iters) for f in (
            lambda: exact(q, k, v, layout="bnhd"), lambda: fn(*ops, v, layout="bnhd"),
            lambda: fn(*ops, v, layout="bnhd"), lambda: exact(q, k, v, layout="bnhd"))]
        out[f"{tag}_ms"] = 0.5 * (t[1] + t[2])
        out[f"{tag}_turns_ms"] = t[1:3]
        out[f"{tag}_exact_kernel_turns_ms"] = [t[0], t[3]]
        out[f"{tag}_quantize_ms"] = cuda_ms(lambda: quantize_qk_int8(q, k, "bnhd"), iters=iters)
        out[f"{tag}_bound_ms"], out[f"{tag}_bound_by"] = _int8_bound(B, N, N, H, D)
        out[f"{tag}_tflops"] = 4.0 * B * H * N * N * D / out[f"{tag}_ms"] / 1e9
        attrs = _kernels.kernel_attrs("flash_attn_int8", D)
        out[f"{tag}_registers_at_launch"] = attrs["registers"]
        out[f"{tag}_smem_bytes"] = attrs["smem_bytes"]
        log(f"[timing] {'K9' if D == 128 else 'K8'} at {shape}: "
            f"{t[1]:.3f}, {t[2]:.3f} ms (bound {out[f'{tag}_bound_ms']:.3f}, "
            f"{out[f'{tag}_bound_by']}; {out[f'{tag}_tflops']:.0f} TFLOP/s) against the exact "
            f"{exact.__name__} {t[0]:.3f}, {t[3]:.3f} ms in turns; quantize_qk_int8 "
            f"{out[f'{tag}_quantize_ms']:.3f} ms; {attrs['registers']} registers at launch, "
            f"{attrs['smem_bytes']} B smem")
        del q, k, v, ops
    torch.cuda.empty_cache()

    # the DiT's fc1 on the CFG pair's tokens: (2 x 17,776, 3,072) -> 12,288
    B, N, H, D = dit_shape
    x = torch.randn(B, N, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(4 * H * D, H * D, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    bias = torch.randn(4 * H * D, generator=gen, device="cuda").to(torch.bfloat16)
    w8, ws = quantize_linear(w)
    qx, _ = quantize_activations(x)
    qx2 = qx.reshape(-1, qx.shape[-1])
    out["fc1_shape"] = [B * N, H * D, 4 * H * D]
    out["fc1_bf16_ms"] = cuda_ms(lambda: F.linear(x, w, bias), iters=10)
    out["fc1_w8a8_ms"] = cuda_ms(lambda: linear_w8a8(x, w8, ws, bias), iters=10)
    out["fc1_int8_matmul_ms"] = cuda_ms(lambda: int8_matmul(qx2, w8), iters=10)
    out["fc1_quantize_activations_ms"] = cuda_ms(lambda: quantize_activations(x), iters=10)
    del x, w, bias, w8, ws, qx, qx2
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Sampling: the 3D-causal VAE, T5 and sample_t2v / sample_i2v
# ---------------------------------------------------------------------------

# VAE on the card against the CPU, both in the path's dtypes (bf16 weights as
# the generator loads them, f32 activations from the f32 latents and image):
# the same arithmetic up to summation order through ~60 convolutions
VAE_REL = 1e-3
# T5 in f32 on both (the generator keeps it as loaded): summation order only
T5_REL = 1e-4


def small_vae_config():
    """The VAE at a quarter of CogVideoX-5B's widths and 2 resnets a block,
    with its latent channels, groups and compression."""
    import dataclasses

    from videogpa_torch.models.cogvideox import CogVideoXConfig

    return dataclasses.replace(CogVideoXConfig.cogvideox_5b(),
                               vae_block_out_channels=(32, 64, 64, 128),
                               vae_layers_per_block=2)


def _rel(got, want) -> float:
    return ((got.float().cpu() - want.float()).norm() / want.float().norm()).item()


def phase_slice_sampling() -> None:
    """The tiny and a small VAE (encode with injected posterior noise,
    decode, tiled decode and tiled encode) and a small T5 (shared and
    per-layer bias, padded) on the card against the CPU on the same weights."""
    import dataclasses

    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.cogvideox import vae as V
    from videogpa_torch.models.t5 import T5Config, t5_encode, t5_encoder_init

    zero_launches()
    for name, cfg, T, H, W, tile in (("tiny", CogVideoXConfig.tiny(), 9, 64, 96, 4),
                                     ("small", small_vae_config(), 9, 128, 192, 8)):
        gen = torch.Generator().manual_seed(40)
        ref = V.vae_init(cfg, gen, device="cpu")
        # the generator's bf16 weights, held in f32 on the CPU
        ref.load_state_dict({k: v.to(torch.bfloat16).float() for k, v in ref.state_dict().items()})
        dev = V.vae_init(cfg, device="cuda", dtype=torch.bfloat16)
        dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
        video = torch.rand(1, 3, T, H, W, generator=gen) * 2 - 1
        t_lat = (T - 1) // cfg.temporal_compression_ratio + 1
        h, w = H // 8, W // 8
        noise = torch.randn(1, cfg.vae_latent_channels, t_lat, h, w, generator=gen)
        lat = torch.randn(1, cfg.vae_latent_channels, t_lat, h, w, generator=gen)
        px = H // 2  # the tiled encode's pixel tile, overlap px // 2
        n_tiles = len({p // 8 for p in V._tile_positions(H, px, px // 2)}) * len(
            {p // 8 for p in V._tile_positions(W, px, px // 2)})
        tile_noise = [torch.randn(1, cfg.vae_latent_channels, t_lat, px // 8, px // 8,
                                  generator=gen) for _ in range(n_tiles)]
        cases = {
            "encode": lambda m, d: V.vae_encode(m, video.to(d), cfg, noise=noise.to(d)),
            "decode": lambda m, d: V.vae_decode(m, lat.to(d), cfg),
            f"tiled decode (tile {tile})": lambda m, d: V.vae_decode_tiled(
                m, lat.to(d), cfg, tile_latent=tile, overlap_latent=tile // 2),
            f"tiled encode (tile {px} px)": lambda m, d: V.vae_encode_tiled(
                m, video.to(d), cfg, noise=[n.to(d) for n in tile_noise],
                tile_pixels=px, overlap_pixels=px // 2),
        }
        errs = {}
        for case, fn in cases.items():
            want = fn(ref, "cpu")
            got = fn(dev, "cuda")
            torch.cuda.synchronize()
            errs[case] = _rel(got, want)
            if not (bool(torch.isfinite(got).all()) and got.shape == want.shape
                    and errs[case] <= VAE_REL):
                fail(f"the {name} VAE's {case} on the card disagrees with the CPU: "
                     f"rel-norm error {errs[case]:.3e}")
        log(f"[slice-sampling] {name} VAE (channels {cfg.vae_block_out_channels}, "
            f"{cfg.vae_layers_per_block} resnets a block, {T}f@{H}x{W}), bf16 weights and f32 "
            f"activations on the card vs the CPU: rel-norm errors "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {VAE_REL})")
    for per_layer in (False, True):
        cfg = dataclasses.replace(T5Config.tiny(per_layer), d_model=256, d_kv=32, d_ff=640,
                                  num_layers=4, num_heads=8, vocab_size=1000)
        ref = t5_encoder_init(cfg, torch.Generator().manual_seed(41), device="cpu")
        dev = t5_encoder_init(cfg, device="cuda")
        dev.load_state_dict(ref.state_dict())
        gen = torch.Generator().manual_seed(42)
        ids = torch.randint(0, cfg.vocab_size, (2, 226), generator=gen)
        mask = torch.ones(2, 226, dtype=torch.long)
        mask[1, 150:] = 0
        want = t5_encode(ref, ids, mask)
        got = t5_encode(dev, ids.cuda(), mask.cuda())
        err = _rel(got, want)
        log(f"[slice-sampling] small T5 ({cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{'per-layer' if per_layer else 'shared'} bias, 2 x 226 ids, one padded) f32 on the "
            f"card vs the CPU: rel-norm error {err:.2e} (limit {T5_REL})")
        if not (bool(torch.isfinite(got).all()) and err <= T5_REL):
            fail("T5 on the card disagrees with the CPU")
    launches = read_launches()
    if any(launches.values()):
        fail(f"the VAE and T5 launched an attention kernel: {launches}")


def decode_conv_tflop(cfg, latents_shape, tile: int) -> dict:
    """Convolution TFLOP of ``decode_latents`` on (B, F, C, h, w) latents at
    ``tile``, counted by ``torch.utils.flop_counter`` over the decode on
    ``meta`` tensors (shapes only): one tile, the tile grid, and untiled."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from videogpa_torch.models.cogvideox import vae as V

    B, F_, C, h, w = latents_shape
    model = V.CogVideoXVAE(cfg, device="meta", dtype=torch.float32)

    def tflop(hh, ww):
        with FlopCounterMode(display=False) as counter:
            V.vae_decode(model, torch.empty(B, C, F_, hh, ww, device="meta"), cfg)
        return counter.get_total_flops() / 1e12

    n_tiles = len(V._tile_grid(h, w, min(tile, h), min(tile, w), 8)[2])
    per_tile = tflop(min(tile, h), min(tile, w))
    return {"per_tile": per_tile, "tiles": n_tiles, "tiled": n_tiles * per_tile,
            "untiled": tflop(h, w)}


def probe_int32_limits() -> dict:
    """Does each operation of an untiled 49f@480x720 decode take a tensor of
    more than 2^31 elements on the card, and compute it right? Each runs
    once near (1, 256, 49, 480, 720) f32 (4.34 G elements) and is checked on
    its last frames against the same operation on a slice of them."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.layers import _full_f32_conv

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(43)
    shape = (1, 256, 49, 480, 720)

    def attempt(name, fn):
        try:
            out[name] = "ok" if fn() else "WRONG VALUES"
        except RuntimeError as e:  # a refusal is this probe's finding
            out[name] = f"raises: {str(e).splitlines()[0][:160]}"
        torch.cuda.empty_cache()

    def conv(cin, cout):
        x = torch.randn((1, cin) + shape[2:], generator=gen, device="cuda")
        w = torch.randn(cout, cin, 3, 3, 3, generator=gen, device="cuda") * 0.05
        with _full_f32_conv(x):
            y = F.conv3d(x, w, padding=(0, 1, 1))
            tail = F.conv3d(x[:, :, -5:], w, padding=(0, 1, 1))
        return bool(torch.allclose(y[:, :, -3:], tail, rtol=1e-4, atol=1e-4))

    def group_norm():
        x = torch.randn(shape, generator=gen, device="cuda")
        y = F.group_norm(x, 32)
        last = x[:, -8:]
        want = (last - last.mean()) / torch.sqrt(last.var(unbiased=False) + 1e-5)
        return bool(torch.allclose(y[:, -8:, -1], want[:, :, -1], rtol=1e-3, atol=1e-3))

    def nearest():
        x = torch.randn(49, 256, 240, 360, generator=gen, device="cuda")
        y = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return bool(torch.equal(y[-1, -1, -2:, -2:], x[-1, -1, -1:, -1:].expand(2, 2)))

    attempt("conv3d input 4.34 G (256 -> 8 channels)", lambda: conv(256, 8))
    attempt("conv3d output 4.16 G (8 -> 256 channels)", lambda: conv(8, 256))
    attempt("group_norm 4.34 G", group_norm)
    attempt("nearest 2x (repeat_interleave) output 4.34 G", nearest)
    log("[sample] tensors above 2^31 elements on the card: " + json.dumps(out))
    return out


def phase_sample(dit, steps: int = 2, i2v_layers: int = 42):
    """The sampling path at full width: T5-XXL (f32, as the generator keeps
    it) encodes a prompt and the empty negative, 2 x 226 ids; ``sample_t2v``
    runs ``steps`` DPM steps of the [main] phase's CogVideoX-5B DiT at
    49f@480x720 and ``decode_latents`` decodes the (1, 13, 16, 60, 90)
    latents through the bf16 VAE with the DiT, T5 and VAE resident; then
    ``video_to_uint8``. Then, with the T2V DiT and T5 freed, ``sample_i2v``
    with the I2V DiT (``i2v_layers`` of 42 layers): the VAE encodes one
    480x720 frame, ``steps`` DPM steps, decode."""
    import dataclasses

    import torch

    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, SamplerSettings, dit_init, pipeline, sample_i2v, sample_t2v,
        vae_decode, vae_init, video_to_uint8)
    from videogpa_torch.models.t5 import T5Config, t5_encode, t5_encoder_init

    cfg = CogVideoXConfig.cogvideox_5b()
    t5_cfg = T5Config.t5_v1_1_xxl()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t5 = t5_encoder_init(t5_cfg, torch.Generator(device="cuda").manual_seed(44), device="cuda")
    vae = vae_init(cfg, torch.Generator(device="cuda").manual_seed(45), device="cuda",
                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_t5 = sum(p.numel() for p in t5.parameters())
    n_vae = sum(p.numel() for p in vae.parameters())
    log(f"[sample] T5-v1.1-XXL ({t5_cfg.num_layers} layers, d_model {t5_cfg.d_model}, "
        f"{n_t5 / 1e9:.3f} B params, f32) and the VAE ({n_vae / 1e6:.1f} M params, bf16) "
        f"on the card in {time.perf_counter() - t0:.1f} s, beside the DiT")
    gen = torch.Generator().manual_seed(46)
    ids = torch.randint(0, t5_cfg.vocab_size, (2, cfg.max_text_seq_length), generator=gen)
    ids[1, 1:] = 0  # the empty negative prompt: EOS then padding, as the tokenizer gives it
    zero_launches()
    with torch.no_grad():
        t5_encode(t5, ids.cuda())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = t5_encode(t5, ids.cuda())
        torch.cuda.synchronize()
    t5_ms = 1e3 * (time.perf_counter() - t0)
    if emb.shape != (2, cfg.max_text_seq_length, t5_cfg.d_model) or not bool(
            torch.isfinite(emb).all()):
        fail(f"T5 embeddings {tuple(emb.shape)} not finite or wrong shape")
    log(f"[sample] t5_encode 2 x {cfg.max_text_seq_length} ids: {t5_ms:.1f} ms, "
        f"embeddings {tuple(emb.shape)} finite")

    timing = {}
    real_decode = pipeline.decode_latents

    def timed_decode(vae_, latents, cfg_):
        """sample_t2v's decode, timed apart from its denoise loop."""
        torch.cuda.synchronize()
        timing["denoise_s"] = time.perf_counter() - timing["t0"]
        timing["latents"] = tuple(latents.shape)
        t1 = time.perf_counter()
        out = real_decode(vae_, latents, cfg_, log=timing.setdefault("tile_log", []).append)
        torch.cuda.synchronize()
        timing["decode_s"] = time.perf_counter() - t1
        return out

    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm")
    pipeline.decode_latents = timed_decode
    try:
        torch.cuda.synchronize()
        timing["t0"] = time.perf_counter()
        video = sample_t2v(dit, vae, emb[:1], emb[1:], cfg, num_frames=49, height=480,
                           width=720, settings=settings,
                           generator=torch.Generator(device="cuda").manual_seed(47))
        torch.cuda.synchronize()
    finally:
        pipeline.decode_latents = real_decode
    total_s = time.perf_counter() - timing["t0"]
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = video_to_uint8(video)
    want = dict.fromkeys(launches, 0)
    want["flash_attn_fwd"] = steps * cfg.num_layers
    step_ms = 1e3 * timing["denoise_s"] / steps
    log(f"[sample] sample_t2v 49f@480x720: {steps} DPM steps in {timing['denoise_s']:.3f} s "
        f"({step_ms:.1f} ms a step), latents {timing['latents']}, decode_latents "
        f"{1e3 * timing['decode_s']:.1f} ms ({'; '.join(timing['tile_log'])}), total "
        f"{total_s:.3f} s; "
        f"video {tuple(video.shape)} {video.dtype}, uint8 frames {frames.shape}; peak "
        f"{peak_gb:.2f} GB with the DiT, T5 and VAE resident; launches {json.dumps(launches)}")
    if (tuple(video.shape) != (1, 3, 49, 480, 720) or not bool(torch.isfinite(video).all())
            or float(video.abs().max()) > 1.0 or frames.shape != (1, 49, 480, 720, 3)):
        fail("sample_t2v's video is not finite in [-1, 1] at 49f@480x720")
    if launches != want:
        fail(f"the sampling path's launches {launches} are not K1's {want['flash_attn_fwd']} "
             "alone (T5 and the VAE launch none)")
    tile = int(timing["tile_log"][-1].split()[2].rstrip(":"))  # "decode tile N: ..."
    conv_tflop = decode_conv_tflop(cfg, timing["latents"], tile)
    log(f"[sample] decode convolutions: {conv_tflop['tiled']:.1f} TFLOP tiled "
        f"({conv_tflop['tiles']} tiles of {conv_tflop['per_tile']:.2f}), "
        f"{conv_tflop['untiled']:.1f} untiled; {conv_tflop['tiled'] / timing['decode_s']:.1f} "
        f"TFLOP/s achieved over the whole decode, bound {1e12 * conv_tflop['tiled'] / PEAK_F32_FLOPS:.2f} s at "
        f"the f32 peak of {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s")
    profile = profile_device_time(
        f"one decode tile ({tile}^2 latents, f32 activations)",
        lambda: vae_decode(vae, torch.randn(1, 16, 13, tile, tile, device="cuda"), cfg))
    del dit, t5, emb, video
    torch.cuda.empty_cache()
    probe = probe_int32_limits()

    # I2V at full width; the T2V DiT and T5 are freed
    icfg = dataclasses.replace(CogVideoXConfig.cogvideox_5b_i2v(), num_layers=i2v_layers)
    t0 = time.perf_counter()
    idit = dit_init(icfg, torch.Generator(device="cuda").manual_seed(48), device="cuda",
                    dtype=torch.bfloat16).requires_grad_(False)
    torch.cuda.synchronize()
    log(f"[sample] CogVideoX-5B-I2V DiT: {icfg.num_layers} of 42 layers, in_channels "
        f"{icfg.in_channels}, learned positions, bf16, in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(49)
    image = torch.rand(1, 3, 480, 720, generator=gen, device="cuda") * 2 - 1
    text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen,
                       device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivideo = sample_i2v(idit, vae, text, torch.zeros_like(text), image, icfg, num_frames=49,
                        settings=settings, generator=gen)
    torch.cuda.synchronize()
    i2v_s = time.perf_counter() - t0
    i2v_launches = read_launches()
    i2v_peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(i2v_launches, 0)
    want["flash_attn_fwd"] = steps * icfg.num_layers
    log(f"[sample] sample_i2v 49f@480x720 (VAE encode of one 480x720 frame, {steps} DPM "
        f"steps, decode): {i2v_s:.3f} s, video {tuple(ivideo.shape)}, peak {i2v_peak:.2f} GB; "
        f"launches {json.dumps(i2v_launches)}")
    if (tuple(ivideo.shape) != (1, 3, 49, 480, 720) or not bool(torch.isfinite(ivideo).all())
            or float(ivideo.abs().max()) > 1.0):
        fail("sample_i2v's video is not finite in [-1, 1] at 49f@480x720")
    if i2v_launches != want:
        fail(f"the I2V path's launches {i2v_launches} are not K1's alone")
    del idit, vae, ivideo
    torch.cuda.empty_cache()
    return {"launches": launches, "i2v_launches": i2v_launches, "t5_ms": t5_ms,
            "decode_conv_tflop": conv_tflop,
            "step_ms": step_ms, "denoise_s": timing["denoise_s"],
            "decode_ms": 1e3 * timing["decode_s"], "tile": tile, "total_s": total_s,
            "peak_gb": peak_gb, "i2v_s": i2v_s, "i2v_peak_gb": i2v_peak,
            "i2v_layers": icfg.num_layers, "decode_profile": profile, "int32_probe": probe}


# float32 gradients of the f32 backward against the plain version (same O,
# LSE and dO, both f32 with no TF32): the two sum the same products in other
# orders, so an element differs by the rounding of its sums, which near
# cancellation in dS is judged against the gradient's RMS; a fault in the
# kernel moves gradients by their own size
F32_GRAD_ATOL_RMS_FRAC, F32_GRAD_RTOL = 1e-3, 1e-4


def _f32_grad_check(got, want):
    """(max |d|, atol, ok) of one f32 gradient against the plain version."""
    import torch

    atol = F32_GRAD_ATOL_RMS_FRAC * want.square().mean().sqrt().item()
    d = (got - want).abs()
    ok = bool((d <= atol + F32_GRAD_RTOL * want.abs()).all() and torch.isfinite(got).all())
    return d.max().item(), atol, ok


def _peak_flops(dtype):
    """The card's peak rate for products of ``dtype`` operands: the tensor
    cores' for bf16, the CUDA cores' for float32 (no TF32). A kernel that
    widens bf16 to f32 on the CUDA cores is still held to the bf16 peak."""
    import torch

    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS


def _bwd_f32_bound(B, Nq, Nk, H, D, dtype):
    """The CUDA-core backward's least time: five Nq x Nk x D products a head
    over the peak of the operands' dtype (``_peak_flops``), or q, o, dO, k, v
    read and dQ, dK, dV written once in that dtype with the f32 LSE."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 10.0 * B * H * Nq * Nk * D
    nbytes = B * H * (itemsize * (Nq * D * 4 + Nk * D * 4) + 4.0 * Nq)
    return _bound(flops, nbytes, _peak_flops(dtype))


def _bwd_f32_run(label, fwd, bwd, q, k, v, do, layout, iters=0):
    """One case of the CUDA-core backward (``flash_attn_bwd_f32`` or
    ``flash_attn_bwd_wide``): the forward ``fwd`` with LSE, the backward
    twice (bit-equal), each gradient against the plain version over chunks
    of heads (f32 tolerances for f32 operands, bf16 ones for bf16). With
    ``iters``, also times the kernel, and SDPA's backward in the same dtype.
    Returns a dict of the case."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import flash_attn_bwd_reference

    o, lse = fwd(q, k, v, layout=layout, with_lse=True)
    grads = bwd(q, k, v, o, lse, do, layout=layout)
    again = bwd(q, k, v, o, lse, do, layout=layout)
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    if not bit_equal:
        fail(f"{bwd.__name__}: two runs differ at the {label}")
    hd = 2 if layout == "bnhd" else 1
    B, H = q.shape[0], q.shape[hd]
    Nq, Nk = q.shape[3 - hd], k.shape[3 - hd]
    D = q.shape[-1]
    check = _f32_grad_check if q.dtype == torch.float32 else _grad_check
    chunk = max(1, 2 ** 29 // (4 * B * Nq * Nk))  # heads a 0.5 GB score matrix holds
    plain_ms, worst, atols = 0.0, [0.0, 0.0, 0.0], []
    for h in range(0, H, chunk):
        hs = slice(h, h + chunk)
        sl = (slice(None), slice(None), hs) if layout == "bnhd" else (slice(None), hs)
        want, ms = _timed(lambda: flash_attn_bwd_reference(
            q[sl], k[sl], v[sl], o[sl], lse[:, hs].contiguous(), do[sl], layout=layout))
        plain_ms += ms
        for i, (g, w) in enumerate(zip(grads, want)):
            err, atol, ok = check(g[sl], w)
            worst[i] = max(worst[i], err)
            atols.append(atol)
            if not ok:
                fail(f"{bwd.__name__} disagrees with its plain version at the {label}, "
                     f"heads {h}.., gradient {'QKV'[i]}")
        del want
    out = {"shape": [B, Nq, Nk, H, D], "layout": layout, "dtype": str(q.dtype).split(".")[-1],
           "plain_ms": plain_ms, "max_abs_err": max(worst), "bit_equal": bit_equal}
    msg = (f"[parity_f32_bwd] {bwd.__name__} {label} {str(q.dtype)[6:]} {layout}, heads in "
           f"chunks of {min(chunk, H)}: max|dQ| {worst[0]:.3e}, max|dK| {worst[1]:.3e}, "
           f"max|dV| {worst[2]:.3e} (atol {min(atols):.2e}..{max(atols):.2e}) ok; two runs "
           f"bit-equal")
    if iters:
        ms = cuda_ms(lambda: bwd(q, k, v, o, lse, do, layout=layout), iters=iters)
        tr = (lambda x: x.transpose(1, 2)) if layout == "bnhd" else (lambda x: x)
        qt, kt, vt = (tr(x).detach().requires_grad_(True) for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dot = tr(do)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                         iters=iters)
        bound_ms, bound_by = _bwd_f32_bound(B, Nq, Nk, H, D, q.dtype)
        out.update({"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                    "tflops": 10.0 * B * H * Nq * Nk * D / ms / 1e9})
        msg += (f"; kernel {ms:.4f} ms ({out['tflops']:.1f} TFLOP/s counting five products), "
                f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.1f} ms, SDPA "
                f"{str(q.dtype)[6:]} backward {lib_ms:.4f} ms")
        del qt, kt, vt, ot, dot
    log(msg)
    del o, lse, grads
    torch.cuda.empty_cache()
    return out


def phase_parity_f32_bwd(cam_shape, vggt_shape):
    """The CUDA-core backward against its plain version: ``flash_attn_bwd_f32``
    at the camera head, the frame rows, one long row and B*H = 66,000, and
    ``flash_attn_bwd_wide`` at (1, 4,096, 16, 256) in f32 and bf16, each two
    runs bit-equal and timed beside its bound and SDPA's backward in the same
    dtype; edge cases (cross and ragged lengths, head dims 16 and 32, the
    bhnd layout, strided views, operands off 16-byte alignment, more key
    tiles than the grid holds CTAs: the in-order dQ walk); ``attention()``
    autograd in f32 through K6's f32 entry and this one. Returns a dict."""
    import torch

    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import (
        attention, flash_attn_bwd_f32, flash_attn_bwd_wide, flash_attn_fwd_f32,
        flash_attn_fwd_wide)

    gen = torch.Generator(device="cuda").manual_seed(41)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {"shapes": {}, "edge_cases": {}}
    f32 = (flash_attn_fwd_f32, flash_attn_bwd_f32)
    wide = (flash_attn_fwd_wide, flash_attn_bwd_wide)
    shapes = [("camera head", f32, cam_shape, torch.float32, 200),
              ("frame rows", f32, vggt_shape, torch.float32, 3),
              ("long row", f32, (1, 4096, 16, 64), torch.float32, 5),
              ("B*H = 2 x 33,000 = 66,000", f32, (2, 24, 33000, 64), torch.float32, 5),
              ("long row D=256 f32", wide, (1, 4096, 16, 256), torch.float32, 2),
              ("long row D=256 bf16", wide, (1, 4096, 16, 256), torch.bfloat16, 2)]
    for label, (fwd, bwd), shape, dtype, iters in shapes:
        q, k, v, do = (rnd(shape, dtype) for _ in range(4))
        out["shapes"][label] = _bwd_f32_run(label, fwd, bwd, q, k, v, do, "bnhd", iters=iters)
        del q, k, v, do

    def bhnd(B, N, H, D, dtype=torch.float32):
        return rnd((B, H, N, D), dtype)

    unaligned = tuple(rnd(70 * 2 * 64 + 1)[1:].view(1, 70, 2, 64) for _ in range(4))
    edges = [
        ("cross Nq=37 Nk=53 D=16", f32, "bhnd",
         (bhnd(2, 37, 3, 16), bhnd(2, 53, 3, 16), bhnd(2, 53, 3, 16), bhnd(2, 37, 3, 16))),
        ("ragged N=130 D=32", f32, "bnhd", tuple(rnd((1, 130, 2, 32)) for _ in range(4))),
        ("cross Nq=100 Nk=777 D=128", f32, "bnhd",
         (rnd((2, 100, 3, 128)), rnd((2, 777, 3, 128)), rnd((2, 777, 3, 128)),
          rnd((2, 100, 3, 128)))),
        ("operands 4 bytes off 16-byte alignment N=70 D=64", f32, "bnhd", unaligned),
        ("141 key tiles on one head, more than the grid's CTAs (in-order dQ)", f32, "bnhd",
         tuple(rnd((1, 9000, 1, 64)) for _ in range(4))),
        ("cross Nq=333 Nk=200 D=192 strided (B, H, N, D) views", wide, "bhnd",
         tuple(rnd((2, n, 3 * 192)).view(2, n, 3, 192).transpose(1, 2)
               for n in (333, 200, 200, 333))),
        ("cross Nq=300 Nk=130 D=512 bf16", wide, "bnhd",
         tuple(rnd((1, n, 2, 512), torch.bfloat16) for n in (300, 130, 130, 300))),
        ("ragged N=200 D=320 bf16 bhnd", wide, "bhnd",
         tuple(bhnd(2, 200, 2, 320, torch.bfloat16) for _ in range(4))),
    ]
    for label, (fwd, bwd), layout, (q, k, v, do) in edges:
        r = _bwd_f32_run(label, fwd, bwd, q, k, v, do.contiguous(), layout)
        out["edge_cases"][label] = r["max_abs_err"]
        del q, k, v, do
    del edges, unaligned
    # the largest error of each entry (bf16 gradients are held by bf16 tolerances)
    for key, entry in (("max_abs_err", "flash_attn_bwd_f32"),
                       ("wide_max_abs_err", "flash_attn_bwd_wide")):
        out[key] = max(r["max_abs_err"] for r in out["shapes"].values()
                       if (entry == "flash_attn_bwd_wide") == (r["shape"][-1] > 128))
    for key, args in (("registers_smem_d64", ("flash_attn_bwd_f32", 64)),
                      ("registers_smem_d128", ("flash_attn_bwd_f32", 128)),
                      ("registers_smem_d16", ("flash_attn_bwd_f32", 16)),
                      ("registers_smem_wide_bf16", ("flash_attn_bwd_wide_bf16",))):
        attrs = _kernels.kernel_attrs(*args)
        out[key] = [attrs["registers"], attrs["smem_bytes"]]
    log(f"[parity_f32_bwd] registers a thread and shared memory a CTA: " + json.dumps(
        {k: v for k, v in out.items() if k.startswith("registers")}))

    # attention() under grad in f32: K6's f32 entry with LSE, then this entry
    q, k, v, do = (torch.randn(cam_shape, generator=gen, device="cuda") for _ in range(4))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    f0, b0 = flash_attn_fwd_f32.launches, flash_attn_bwd_f32.launches
    o = attention(q, k, v, layout="bnhd")
    if type(o.grad_fn).__name__ != "_FlashAttentionBackward":
        fail(f"attention() on f32 CUDA tensors that require grad has grad_fn {o.grad_fn}")
    o.backward(do)
    with torch.no_grad():
        o2, lse = flash_attn_fwd_f32(q, k, v, layout="bnhd", with_lse=True)
        direct = flash_attn_bwd_f32(q, k, v, o2, lse, do, layout="bnhd")
    same = torch.equal(o.detach(), o2) and all(
        torch.equal(x.grad, d) for x, d in zip((q, k, v), direct))
    counted = (flash_attn_fwd_f32.launches - f0, flash_attn_bwd_f32.launches - b0) == (2, 2)
    log(f"[parity_f32_bwd] attention() autograd in f32 at {tuple(cam_shape)}: grad_fn "
        f"_FlashAttentionBackward, O and q/k/v grads bit-equal to the direct K6 f32 + "
        f"flash_attn_bwd_f32 calls: {same}, launches counted: {counted}")
    if not (same and counted):
        fail("attention() autograd in f32 did not go through K6 f32 and flash_attn_bwd_f32")
    return out


HEADDIM_F32_ATOL, HEADDIM_F32_RTOL = 2e-5, 1e-5  # f32 O: as K6 f32's parity (F32_O_*)


def phase_parity_headdim():
    """``attention()`` on CUDA at head dims no kernel takes (8, 40, 80, 96):
    zero-padded to the next kernel width with the original D's scale. bf16
    forward (long rows: K1 / K6; short bnhd rows: K4) and autograd (K1 + K3 /
    K6 + K7), f32 forward (K6 f32) and autograd (K6 f32 + the f32 backward),
    ``impl="flash_int8"`` at D = 40 (K8 at width 64) and 80 (K9's entry at
    128), each against the plain version at the original D. Checks from the
    launch counters that each of those kernels ran."""
    import torch

    from videogpa_torch.ops.attention import (
        attention, flash_attn_bwd_reference, flash_attn_fwd_reference,
        flash_attn_int8_reference, flash_attn_short_reference, quantize_qk_int8)

    gen = torch.Generator(device="cuda").manual_seed(43)
    zero_launches()
    for D in (8, 40, 80, 96):
        # bf16 forward, long bhnd rows and short bnhd rows
        q, k, v = _attn_case(gen, 2, 1000, 1100, 4, D, "bhnd")
        err, atol, ok = _check_o(attention(q, k, v), flash_attn_fwd_reference(q, k, v, "bhnd")[0])
        if not ok:
            fail(f"attention() bf16 at head_dim {D} disagrees with the plain version")
        qs, ks, vs = _attn_case(gen, 40, 300, 300, 2, D, "bnhd")
        err_s, atol_s, ok = _check_o(attention(qs, ks, vs, layout="bnhd"),
                                     flash_attn_short_reference(qs, ks, vs))
        if not ok:
            fail(f"attention() bf16 short rows at head_dim {D} disagree with the plain version")
        # bf16 autograd against the plain forward + backward at D
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        attention(qg, kg, vg).backward(do)
        ro, rl = flash_attn_fwd_reference(q, k, v, "bhnd", with_lse=True)
        want = flash_attn_bwd_reference(q, k, v, ro, rl, do, layout="bhnd")
        g_errs = []
        for name, x, w in zip("QKV", (qg, kg, vg), want):
            g_err, _, ok = _grad_check(x.grad, w)
            g_errs.append(g_err)
            if not ok:
                fail(f"attention() bf16 autograd at head_dim {D}: d{name} disagrees")
        # f32 forward and autograd
        qf, kf, vf, dof = (torch.randn((2, 4, 700, D), generator=gen, device="cuda")
                           for _ in range(4))
        of = attention(qf, kf, vf)
        rof, rlf = flash_attn_fwd_reference(qf, kf, vf, "bhnd", with_lse=True)
        d_f = (of - rof).abs()
        if not bool((d_f <= HEADDIM_F32_ATOL + HEADDIM_F32_RTOL * rof.abs()).all()):
            fail(f"attention() f32 at head_dim {D} disagrees with the plain version")
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (qf, kf, vf))
        attention(qg, kg, vg).backward(dof)
        want = flash_attn_bwd_reference(qf, kf, vf, rof, rlf, dof, layout="bhnd")
        f_errs = []
        for name, x, w in zip("QKV", (qg, kg, vg), want):
            g_err, _, ok = _f32_grad_check(x.grad, w)
            f_errs.append(g_err)
            if not ok:
                fail(f"attention() f32 autograd at head_dim {D}: d{name} disagrees")
        log(f"[parity_headdim] D = {D}: bf16 O max|d| {err:.3e} (atol {atol:.2e}), short rows "
            f"{err_s:.3e} (atol {atol_s:.2e}), bf16 grads max|d| "
            f"{', '.join(f'{e:.3e}' for e in g_errs)} (atol {GRAD_ATOL_RMS_FRAC} RMS + rtol "
            f"{GRAD_RTOL}); f32 O max|d| {d_f.max().item():.3e} (atol {HEADDIM_F32_ATOL} + rtol "
            f"{HEADDIM_F32_RTOL}), f32 grads max|d| {', '.join(f'{e:.3e}' for e in f_errs)} "
            f"(atol {F32_GRAD_ATOL_RMS_FRAC} RMS + rtol {F32_GRAD_RTOL}) ok")
        del q, k, v, qs, ks, vs, do, qg, kg, vg, ro, rl, want, qf, kf, vf, dof, of, rof, rlf
    for D in (40, 80):
        # the int8 route, against the plain int8 function on unpadded operands
        q, k, v = _attn_case(gen, 2, 3000, 3000, 4, D, "bnhd")
        o = attention(q, k, v, impl="flash_int8", layout="bnhd")
        ro = flash_attn_int8_reference(*quantize_qk_int8(q, k, "bnhd"), v, "bnhd")
        err, atol, ok = _check_o(o, ro)
        log(f"[parity_headdim] int8 D = {D} (2, 3000, 4, {D}) bnhd: max|dO| {err:.3e} "
            f"(atol {atol:.2e} + rtol {O_RTOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"attention(impl='flash_int8') at head_dim {D} disagrees with the plain version")
        del q, k, v, o, ro
    wide_errs = _parity_wide_head_dims(gen)
    int8_f32_err = _parity_int8_f32(gen)
    launches = read_launches()
    log(f"[parity_headdim] launches: {json.dumps(launches)}")
    missing = [n for n in ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_short",
                           "flash_attn_fwd_d128", "flash_attn_bwd_d128", "flash_attn_fwd_f32",
                           "flash_attn_bwd_f32", "flash_attn_int8", "flash_attn_int8_d128",
                           "flash_attn_fwd_wide", "flash_attn_bwd_wide", "flash_attn_int8_f32")
               if launches[n] == 0]
    if missing:
        fail(f"attention() at padded head dims launched no {missing}")
    torch.cuda.empty_cache()
    return {"launches": launches, "wide_max_abs_err": wide_errs, "int8_f32_max_abs_err": int8_f32_err}


def _parity_wide_head_dims(gen):
    """``attention()`` at head dims above 128 (160 padded to 192, 256, 512)
    in bf16 (bhnd) and f32 (bnhd): inference through ``flash_attn_fwd_wide``,
    ``impl="flash_int8"`` taking the same exact route (the JAX package's rule
    at D >= 128: no int8 launch, the same O bit for bit), and autograd through
    ``flash_attn_fwd_wide`` + ``flash_attn_bwd_wide``, each against the plain
    version at D. Returns the largest |dO| by dtype."""
    import torch

    from videogpa_torch.ops.attention import (
        attention, flash_attn_bwd_reference, flash_attn_bwd_wide, flash_attn_fwd_reference,
        flash_attn_fwd_wide, flash_attn_int8, flash_attn_int8_d128, flash_attn_int8_f32)

    worst = {"bfloat16": 0.0, "float32": 0.0}
    for D in (160, 256, 512):
        for dtype, layout in ((torch.bfloat16, "bhnd"), (torch.float32, "bnhd")):
            def rnd(n):
                shape = (2, 4, n, D) if layout == "bhnd" else (2, n, 4, D)
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, v, do = rnd(700), rnd(900), rnd(900), rnd(700)
            f0, b0 = flash_attn_fwd_wide.launches, flash_attn_bwd_wide.launches
            i0 = (flash_attn_int8.launches, flash_attn_int8_d128.launches,
                  flash_attn_int8_f32.launches)
            o = attention(q, k, v, layout=layout)
            o8 = attention(q, k, v, impl="flash_int8", layout=layout)
            ro, rl = flash_attn_fwd_reference(q, k, v, layout, with_lse=True)
            if dtype == torch.bfloat16:
                err, atol, ok = _check_o(o, ro)
            else:
                d = (o - ro).abs()
                err, atol = d.max().item(), HEADDIM_F32_ATOL
                ok = bool((d <= HEADDIM_F32_ATOL + HEADDIM_F32_RTOL * ro.abs()).all())
            exact_int8 = torch.equal(o8, o) and i0 == (
                flash_attn_int8.launches, flash_attn_int8_d128.launches,
                flash_attn_int8_f32.launches)
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            attention(qg, kg, vg, layout=layout).backward(do)
            want = flash_attn_bwd_reference(q, k, v, ro, rl, do, layout=layout)
            check = _f32_grad_check if dtype == torch.float32 else _grad_check
            g_errs = []
            for name, x, w in zip("QKV", (qg, kg, vg), want):
                g_err, _, g_ok = check(x.grad, w)
                g_errs.append(g_err)
                ok = ok and g_ok
            counted = (flash_attn_fwd_wide.launches - f0, flash_attn_bwd_wide.launches - b0) == (
                3, 1)
            name = str(dtype).split(".")[-1]
            log(f"[parity_headdim] D = {D} {name} (2, 700 x 900, 4 heads) {layout}: O max|d| "
                f"{err:.3e} (atol {atol:.2e}), flash_int8 = the exact route bit for bit with no "
                f"int8 launch: {exact_int8}, grads max|d| "
                f"{', '.join(f'{e:.3e}' for e in g_errs)}; wide forward 3 and backward 1 "
                f"launches: {counted} {'ok' if ok and exact_int8 and counted else 'MISMATCH'}")
            if not (ok and exact_int8 and counted):
                fail(f"attention() at head_dim {D} in {name} disagrees with the plain version "
                     "or missed the wide entries")
            worst[name] = max(worst[name], err, *g_errs)
            del q, k, v, do, o, o8, ro, rl, qg, kg, vg, want
    torch.cuda.empty_cache()
    return worst


def _parity_int8_f32(gen):
    """``attention(impl="flash_int8")`` on f32 operands (long bnhd rows) at D
    40, 64 and 96 (40 padded to 64, 96 to 128): ``flash_attn_int8_f32``
    against the plain int8 function on the unpadded operands, with f32
    tolerances, and against exact f32 attention. Returns the largest |dO|."""
    import torch

    from videogpa_torch.ops.attention import (
        attention, flash_attn_fwd_reference, flash_attn_int8_f32, flash_attn_int8_reference,
        quantize_qk_int8)

    worst = 0.0
    for D in (40, 64, 96):
        q, k, v = (torch.randn((2, 3000, 4, D), generator=gen, device="cuda") for _ in range(3))
        k = k + 0.5
        before = flash_attn_int8_f32.launches
        o = attention(q, k, v, impl="flash_int8", layout="bnhd")
        ro = flash_attn_int8_reference(*quantize_qk_int8(q, k, "bnhd"), v, "bnhd")
        d = (o - ro).abs()
        ok = bool((d <= HEADDIM_F32_ATOL + HEADDIM_F32_RTOL * ro.abs()).all()
                  and torch.isfinite(o).all()) and o.dtype == torch.float32
        cos, rel = _cos_rel(o, flash_attn_fwd_reference(q, k, v, "bnhd")[0])
        ok = ok and cos > INT8_E2E_COS and rel < INT8_E2E_REL
        launched = flash_attn_int8_f32.launches - before == 1
        log(f"[parity_headdim] int8 with f32 operands D = {D} (2, 3000, 4, {D}) bnhd: max|dO| "
            f"{d.max().item():.3e} (atol {HEADDIM_F32_ATOL} + rtol {HEADDIM_F32_RTOL}) against "
            f"the plain int8 function; against exact f32 attention cosine {cos:.6f}, rel-L2 "
            f"{rel:.4f}; flash_attn_int8_f32 launched: {launched} "
            f"{'ok' if ok and launched else 'MISMATCH'}")
        if not (ok and launched):
            fail(f"attention(impl='flash_int8') on f32 operands at head_dim {D} disagrees")
        worst = max(worst, d.max().item())
        del q, k, v, o, ro, d
    return worst


def phase_timing_wide():
    """The new CUDA-core forwards alone: ``flash_attn_fwd_wide`` at (1, 4,096,
    16, 256) in f32 and bf16 and ``flash_attn_int8_f32`` at the f32 scorer's
    global rows (4, 13,740, 16, 64), each held against its plain version
    (over chunks of heads) and timed beside its bound and one PyTorch call
    computing the same function (SDPA; none computes int8-QK attention).
    Returns a dict."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops import _kernels
    from videogpa_torch.ops.attention import (
        flash_attn_fwd_reference, flash_attn_fwd_wide, flash_attn_int8_f32,
        flash_attn_int8_reference, quantize_qk_int8)

    gen = torch.Generator(device="cuda").manual_seed(47)
    out = {}
    B, N, H, D = 1, 4096, 16, 256
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = (torch.randn((B, N, H, D), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        o = flash_attn_fwd_wide(q, k, v, layout="bnhd")[0]
        plain_ms, worst = 0.0, 0.0
        for h in range(0, H, 4):
            sl = (slice(None), slice(None), slice(h, h + 4))
            (ro, _), ms = _timed(lambda: flash_attn_fwd_reference(q[sl], k[sl], v[sl], "bnhd"))
            plain_ms += ms
            if dtype == torch.bfloat16:
                err, _, ok = _check_o(o[sl], ro)
            else:
                d = (o[sl] - ro).abs()
                err = d.max().item()
                ok = bool((d <= F32_O_ATOL + F32_O_RTOL * ro.abs()).all())
            worst = max(worst, err)
            if not ok:
                fail(f"flash_attn_fwd_wide disagrees at {(B, N, H, D)} {name}, heads {h}..")
            del ro
        ms = cuda_ms(lambda: flash_attn_fwd_wide(q, k, v, layout="bnhd"), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=3)
        bound_ms, bound_by = _bound(4.0 * B * H * N * N * D,
                                    q.element_size() * 4.0 * B * N * H * D, _peak_flops(dtype))
        out[name] = {"shape_bnhd": [B, N, H, D], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                     "max_abs_err": worst, "tflops": 4.0 * B * H * N * N * D / ms / 1e9}
        log(f"[timing] flash_attn_fwd_wide {(B, N, H, D)} {name}: max|dO| {worst:.3e} against "
            f"the plain version ({plain_ms:.1f} ms over chunks of 4 heads); kernel {ms:.3f} ms "
            f"({out[name]['tflops']:.1f} TFLOP/s), bound {bound_ms:.3f} ms ({bound_by}), SDPA "
            f"{lib_ms:.3f} ms")
        del q, k, v, o, qt, kt, vt
    B, N, H, D = 4, 13740, 16, 64
    q, k, v = (torch.randn((B, N, H, D), generator=gen, device="cuda") for _ in range(3))
    k = k + 0.5
    ops = quantize_qk_int8(q, k, "bnhd")
    o = flash_attn_int8_f32(*ops, v, layout="bnhd")
    q8, sq, k8, sk = ops
    plain_ms, worst = 0.0, 0.0
    for b in range(B):
        for h in range(0, H, 4):
            sl = (slice(b, b + 1), slice(None), slice(h, h + 4))
            ro, ms = _timed(lambda: flash_attn_int8_reference(q8[sl], sq[sl], k8[sl], sk[sl],
                                                              v[sl], "bnhd"))
            plain_ms += ms
            d = (o[sl] - ro).abs()
            worst = max(worst, d.max().item())
            if not bool((d <= F32_O_ATOL + F32_O_RTOL * ro.abs()).all()):
                fail(f"flash_attn_int8_f32 disagrees at {(B, N, H, D)}, batch {b}, heads {h}..")
            del ro, d
    ms = cuda_ms(lambda: flash_attn_int8_f32(*ops, v, layout="bnhd"), iters=2)
    quant_ms = cuda_ms(lambda: quantize_qk_int8(q, k, "bnhd"), iters=3)
    t_ops = 2.0 * B * H * N * N * D * (1 / PEAK_INT8_OPS + 1 / PEAK_F32_FLOPS)
    t_bytes = B * H * N * (2 * (D + 4) + 8 * D) / PEAK_HBM_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    attrs = {name: _kernels.kernel_attrs(*args) for name, args in (
        ("fwd_wide_f32", ("flash_attn_fwd_wide", 0)), ("fwd_wide_bf16", ("flash_attn_fwd_wide", 1)),
        ("int8_f32_d64", ("flash_attn_int8_f32", 64)),
        ("int8_f32_d128", ("flash_attn_int8_f32", 128)))}
    out["int8_f32"] = {"shape_bnhd": [B, N, H, D], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "library_ms": None, "quantize_qk_ms": quant_ms, "max_abs_err": worst}
    out["registers_smem"] = {k: [a["registers"], a["smem_bytes"]] for k, a in attrs.items()}
    log(f"[timing] flash_attn_int8_f32 {(B, N, H, D)} (the f32 scorer's global rows): max|dO| "
        f"{worst:.3e} against the plain version ({plain_ms:.1f} ms over chunks of 4 heads); "
        f"kernel {ms:.3f} ms + quantise {quant_ms:.3f} ms, bound {bound_ms:.3f} ms; registers "
        f"and smem {json.dumps(out['registers_smem'])}")
    del q, k, v, ops, q8, sq, k8, sk, o
    torch.cuda.empty_cache()
    return out


SCORE_FILES_GROUPS, SCORE_FILES_CLIPS, SCORE_FILES_FRAMES = 3, 4, 10


def phase_score_files():
    """The score leg from files at VGGT-1B's full width: random VGGT-1B
    weights written as a facebook/VGGT-1B-layout safetensors checkpoint
    (``export_vggt`` + ``save_file``) and read back by ``load_vggt``; then
    ``cli.score.main`` on a prompt-group JSON of 3 groups x 4 clips of 10
    frames at 518^2 at batch 4, at batch 1 (the async path) and with
    ``--int8``. The card's machine has no video decoder, so
    ``data.video_io.sample_uniform_frames`` is replaced by an in-memory frame
    source for the phase. Checks failed == 0, the scores against
    ``process_frames_batch`` on the same frames, a resumed run, and the
    per-metric path (``VIDEOGPA_NO_FUSED_METRICS=1``) against the fused one
    on 2 clips. Returns a dict (with the batch-4 output JSON's path)."""
    import shutil

    import torch

    import videogpa_torch.cli.score as score_cli
    from videogpa_torch.data import video_io
    from videogpa_torch.metrics import ConsistencyScore
    from videogpa_torch.models.loader import load_vggt
    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init
    from videogpa_torch.models.vggt.convert import export_vggt
    from videogpa_torch.reward import VideoProcessor
    from videogpa_torch.utils.safetensors_np import save_file

    cfg = VGGTConfig()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "score_files")
    shutil.rmtree(root, ignore_errors=True)
    ckpt_dir = os.path.join(root, "vggt1b")
    os.makedirs(ckpt_dir)
    model = vggt_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda").eval()
    regular_camera_(model)
    t0 = time.perf_counter()
    sd = export_vggt(model)
    save_file(sd, os.path.join(ckpt_dir, "model.safetensors"))
    write_s = time.perf_counter() - t0
    size_gb = os.path.getsize(os.path.join(ckpt_dir, "model.safetensors")) / 1e9
    n_keys = len(sd)
    del sd
    # the loader's own host peak: a fresh process that loads and exits
    child = subprocess.run(
        [sys.executable, "-c", "import resource, sys, time, torch\n"
         "from videogpa_torch.models.loader import load_vggt\n"
         "t0 = time.perf_counter(); load_vggt(sys.argv[1]); torch.cuda.synchronize()\n"
         "print(time.perf_counter() - t0, "
         "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)", ckpt_dir],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        fail(f"load_vggt in a fresh process failed:\n{child.stderr[-2000:]}")
    child_load_s, child_peak_gb = map(float, child.stdout.split()[-2:])
    t0 = time.perf_counter()
    loaded, _ = load_vggt(ckpt_dir, cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[score_files] VGGT-1B in the upstream key layout: {n_keys} tensors, "
        f"{size_gb:.2f} GB f32 safetensors written in {write_s:.1f} s; load_vggt "
        f"{load_s:.1f} s here, {child_load_s:.1f} s in a fresh process whose peak host RSS "
        f"was {child_peak_gb:.2f} GB (imports and the CUDA context included)")

    # the loaded module computes what the module it was written from computes
    clip = synthetic_frames(1, SCORE_FILES_FRAMES, cfg.img_size, seed=7)[0]
    images = torch.from_numpy(clip).cuda().float().permute(0, 3, 1, 2)[None] / 255.0
    with torch.no_grad():
        a = vggt_forward(model, images, compute_dtype=torch.bfloat16, dpt_dtype=torch.bfloat16)
        b = vggt_forward(loaded, images, compute_dtype=torch.bfloat16,
                         dpt_dtype=torch.bfloat16)
    same = all(torch.equal(a[k], b[k]) for k in ("pose_enc", "depth", "depth_conf",
                                                 "world_points"))
    log(f"[score_files] loaded module against the module written, one clip of "
        f"{SCORE_FILES_FRAMES} x 518^2 (bf16 trunk and DPT): pose_enc, depth, depth_conf, "
        f"world_points bit-equal: {same}")
    if not same:
        fail("load_vggt does not give back the module that was written")
    del model, a, b, images

    # the prompt-group JSON and the in-memory frame source
    frames = {}
    groups = []
    for g in range(SCORE_FILES_GROUPS):
        clips = synthetic_frames(SCORE_FILES_CLIPS, SCORE_FILES_FRAMES, cfg.img_size,
                                 seed=200 + g)
        videos = []
        for c, clip in enumerate(clips):
            path = f"videos/g{g}_c{c}.mp4"
            frames[os.path.join(root, path)] = clip
            videos.append({"video_path": path, "generation_id": c})
        groups.append({"group_id": f"g{g}", "prompt": f"scene {g}", "videos": videos})
    with open(os.path.join(root, "groups.json"), "w") as f:
        json.dump({"groups": groups}, f)
    n_clips = SCORE_FILES_GROUPS * SCORE_FILES_CLIPS

    def memory_frames(path, n_frames=48, size=518):
        return frames[path][:n_frames]

    real_decode, real_score_groups = video_io.sample_uniform_frames, score_cli.score_groups
    walls = []

    def timed_score_groups(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = real_score_groups(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return stats

    log(f"[score_files] the card's machine has no video decoder: "
        f"data.video_io.sample_uniform_frames reads {n_clips} in-memory clips of "
        f"{SCORE_FILES_FRAMES} x 518^2 synthetic frames in this phase")
    out = {"load_s": load_s, "write_s": write_s, "checkpoint_gb": size_gb,
           "fresh_process_load_s": child_load_s, "fresh_process_peak_rss_gb": child_peak_gb,
           "runs": {}}
    video_io.sample_uniform_frames = memory_frames
    score_cli.score_groups = timed_score_groups
    try:
        for tag, extra in (("batch4", ["--batch_size", "4"]), ("batch1_async", []),
                           ("int8_batch4", ["--batch_size", "4", "--int8"])):
            out_json = os.path.join(root, f"scored_{tag}.json")
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = score_cli.main(["--input_json", os.path.join(root, "groups.json"),
                                    "--output_json", out_json, "--base_dir", root,
                                    "--model_name", ckpt_dir,
                                    "--num_frames", str(SCORE_FILES_FRAMES)] + extra)
            wall = time.perf_counter() - t0
            launches = read_launches()
            batches = n_clips / 4 if "batch4" in tag else n_clips
            per_batch = {k: v / batches for k, v in launches.items() if v}
            with open(out_json) as f:
                scored = json.load(f)
            cps = [v["consistency_score"] for g in scored["groups"] for v in g["videos"]]
            run = {"stats": stats, "main_s": wall, "score_groups_s": walls[-1],
                   "clips_per_min": n_clips / (walls[-1] / 60.0), "launches": launches,
                   "per_program": per_batch, "scores": cps, "json": out_json}
            out["runs"][tag] = run
            log(f"[score_files] cli.score.main {' '.join(extra) or '--batch_size 1'}: {stats}, "
                f"main {wall:.1f} s (load included), score_groups {walls[-1]:.2f} s = "
                f"{run['clips_per_min']:.1f} clips/min; launches per "
                f"{'batch of 4' if 'batch4' in tag else 'clip'} {json.dumps(per_batch)}")
            if stats["failed"] != 0 or stats["scored"] != n_clips:
                fail(f"cli.score.main ({tag}) failed on {stats['failed']} clip(s)")
            if not all(math.isfinite(x) for x in cps):
                fail(f"non-finite consistency scores from cli.score.main ({tag})")

        # the CLI's scores against process_frames_batch on the same frames
        vp = VideoProcessor({"Consistency_Score": ConsistencyScore(device="cuda")},
                            params=loaded, config=cfg, device="cuda")
        direct = []
        for g in groups:
            clips = [frames[os.path.join(root, v["video_path"])] for v in g["videos"]]
            direct += [r[0]["Consistency_Score"] for r in vp.process_frames_batch(clips, [0])]
        worst = {tag: max(abs(x - y) / max(abs(y), 1e-12)
                          for x, y in zip(out["runs"][tag]["scores"], direct))
                 for tag in ("batch4", "batch1_async")}
        drift = max(abs(x - y) / max(abs(y), 1e-12)
                    for x, y in zip(out["runs"]["int8_batch4"]["scores"], direct))
        out["rel_err_vs_process_frames_batch"], out["int8_rel_drift"] = worst, drift
        log(f"[score_files] scores against process_frames_batch on the same frames: largest "
            f"relative difference {json.dumps(worst)} (limit {SCORE_FILES_REL}: batch 4 runs "
            f"the same programs; batch 1 runs one-clip programs, whose bf16 sums differ); "
            f"int8 drift against exact {drift:.3e} (not a gate)")
        if max(worst.values()) > SCORE_FILES_REL:
            fail("cli.score.main's scores disagree with process_frames_batch")

        # a resumed run scores nothing new
        with open(out["runs"]["batch4"]["json"]) as f:
            again = json.load(f)
        stats = real_score_groups(vp, again, out["runs"]["batch4"]["json"], base_dir=root,
                                  num_frames=SCORE_FILES_FRAMES, batch_size=4)
        log(f"[score_files] resumed run: {stats}")
        if stats != {"scored": 0, "failed": 0, "resumed": n_clips}:
            fail("a resumed score_groups run scored again")

        # the per-metric path against the fused path on 2 clips
        two = [frames[os.path.join(root, v["video_path"])] for v in groups[0]["videos"][:2]]
        fused = vp.process_frames_batch(two, [0])
        os.environ["VIDEOGPA_NO_FUSED_METRICS"] = "1"
        try:
            per_metric = VideoProcessor({"Consistency_Score": ConsistencyScore(device="cuda")},
                                        params=loaded, config=cfg, device="cuda")
            ref = per_metric.process_frames_batch(two, [0])
        finally:
            del os.environ["VIDEOGPA_NO_FUSED_METRICS"]
        d = max(abs(f[0][k] - r[0][k]) for f, r in zip(fused, ref)
                for k in ("Consistency_Score", "motion_norm"))
        ok = all(abs(f[0][k] - r[0][k]) <= 1e-5 + 1e-4 * abs(r[0][k])
                 for f, r in zip(fused, ref) for k in ("Consistency_Score", "motion_norm"))
        out["per_metric_max_abs_diff"] = d
        log(f"[score_files] VIDEOGPA_NO_FUSED_METRICS=1 (the per-metric path) against the fused "
            f"path on 2 clips: max |d| {d:.3e} (atol 1e-5 + rtol 1e-4) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("the per-metric path disagrees with the fused path")
    finally:
        video_io.sample_uniform_frames, score_cli.score_groups = real_decode, real_score_groups
    del vp, per_metric, loaded
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    return out


# The CLI at batch 4 runs the scorer's own programs on the same frames; at
# batch 1 each clip is its own program, whose bf16 GEMMs and attention sum
# in other orders than at K = 4, and a consistency score then moves with
# the z-buffer winners those sums flip: 1e-2 relative holds both
SCORE_FILES_REL = 1e-2


def phase_train_files(scored_json: str, steps: int = 2):
    """The train leg from files at CogVideoX-5B's full width: pair metadata
    built from [score_files]'s scored JSON (the least consistency score of
    a group wins, ``train.dataset``'s rule) with 49f@480x720 latents and T5
    embeddings written as .npz; ``run_recipe("CogVideoX-5B", config)`` runs
    ``train_dpo`` for ``steps`` steps with validation on 1 pair and a
    checkpoint at the last step, then resumes to ``steps + 1``; the exported
    PEFT LoRA is read back and held against the last checkpoint's.
    ``load_cogvideox`` is handed a random full-width DiT in memory."""
    import shutil

    import numpy as np
    import torch

    import videogpa_torch.cli.train_dpo as train_cli
    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
    from videogpa_torch.train.lora import import_peft
    from videogpa_torch.train.recipes import build_config, run_recipe

    cfg = CogVideoXConfig.cogvideox_5b()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_files")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    os.makedirs(os.path.join(data_dir, "latents"))
    with open(scored_json) as f:
        scored = json.load(f)
    rng = np.random.default_rng(0)
    lat_shape = (cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height, cfg.sample_width)
    for g in scored["groups"]:
        cond = f"latents/cond_{g['group_id']}.npz"
        np.savez(os.path.join(data_dir, cond), encoder_hidden_states=rng.standard_normal(
            (cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32))
        for v in g["videos"]:
            lat = f"latents/{os.path.basename(v['video_path'])}.npz"
            np.savez(os.path.join(data_dir, lat),
                     data=rng.standard_normal(lat_shape, dtype=np.float32))
            v.update(latent_path=lat, condition_path=cond)
    with open(os.path.join(data_dir, "meta_data.json"), "w") as f:
        json.dump(scored, f)
    config = build_config("CogVideoX-5B", base_path=data_dir)
    # random weights: every group's winner and loser by its score, whatever the
    # gap; a warmup shorter than the run (the schedule needs max_steps > warmup)
    config.update(output_dir=os.path.join(root, "out"), max_steps=steps,
                  checkpoint_every_n_steps=steps, log_every_n_steps=1, seed=0,
                  metric_threshold=None, min_gap=0.0, motion_threshold=0.0, warmup_steps=1)
    dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                   dtype=torch.bfloat16).requires_grad_(False)
    log(f"[train_files] {len(scored['groups'])} groups from [score_files]'s JSON, latents "
        f"{lat_shape} and T5 embeddings ({cfg.max_text_seq_length}, {cfg.text_embed_dim}) as "
        f".npz; recipe CogVideoX-5B (batch {config['batch_size']}, accumulate "
        f"{config['accumulate_grad_batches']}, LoRA r {config['lora_rank']}), max_steps "
        f"{steps}, checkpoint every {steps}; load_cogvideox is handed a random full-width "
        f"DiT in memory (a 10 GB checkpoint written and read back would cost more of the run "
        f"than the loader is worth here; tests/test_torch_loaders.py holds the loader)")
    real_load = train_cli.load_cogvideox
    train_cli.load_cogvideox = lambda *a, **k: (dit, None)
    out = {}
    try:
        for tag, max_steps in (("run", steps), ("resume", steps + 1)):
            config["max_steps"] = max_steps
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_recipe("CogVideoX-5B", config)
            torch.cuda.synchronize()
            out[f"{tag}_s"] = time.perf_counter() - t0
            out[f"{tag}_launches"] = read_launches()
    finally:
        train_cli.load_cogvideox = real_load
    with open(os.path.join(root, "out", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    steps_seen = [r["step"] for r in train]
    log(f"[train_files] metrics.jsonl train records: " + json.dumps(
        [{k: r[k] for k in ("step", "time", "train/loss", "stats/samples_per_sec",
                            "stats/max_memory_gb")} for r in train]))
    if steps_seen != list(range(1, steps + 2)):
        fail(f"train_dpo took steps {steps_seen}, expected 1..{steps} then {steps + 1} resumed")
    if not all(math.isfinite(r["train/loss"]) for r in train):
        fail("non-finite train loss")
    L = cfg.num_layers
    want_run = {"flash_attn_fwd": steps * 6 * L + 4 * L, "flash_attn_bwd": steps * 2 * L}
    want_resume = {"flash_attn_fwd": 6 * L + 4 * L, "flash_attn_bwd": 2 * L}
    for tag, want in (("run", want_run), ("resume", want_resume)):
        got = {k: v for k, v in out[f"{tag}_launches"].items() if v}
        log(f"[train_files] {tag}: {out[f'{tag}_s']:.1f} s, launches {json.dumps(got)}; "
            f"expected {json.dumps(want)} (6 forwards and 2 backwards of {L} layers a step, 4 "
            f"forwards a validation pair)")
        if got != want:
            fail(f"train_dpo ({tag}) did not run every attention through K1 and K3")
    kept = sorted(json.load(open(os.path.join(root, "out", "checkpoints", "scores.json"))))
    state = torch.load(os.path.join(root, "out", "checkpoints", kept[-1], "state.pt"),
                       weights_only=True)
    lora = import_peft(os.path.join(root, "out", "final_lora"), L, device="cpu")
    same = state["step"] == steps + 1 and all(
        torch.equal(lora[n][k], state["lora"][n][k]) for n in state["lora"]
        for k in ("lora_A", "lora_B"))
    log(f"[train_files] checkpoints kept {kept}; import_peft(final_lora) equals the trained "
        f"LoRA of step {state['step']}: {same}")
    if not same:
        fail("the exported LoRA is not the trained one")
    step_s = train[1]["time"] - train[0]["time"]
    out.update(step_ms=1e3 * step_s, samples_per_sec=[r["stats/samples_per_sec"] for r in train],
               max_memory_gb=[r["stats/max_memory_gb"] for r in train], steps=steps_seen,
               per_step={"flash_attn_fwd": 6 * L, "flash_attn_bwd": 2 * L})
    del dit, state, lora
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.vggt import VGGTConfig

    t_start = time.perf_counter()
    if os.path.exists(_LOG_PATH):
        os.remove(_LOG_PATH)
    card = gpu_name_and_power()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    cfg = CogVideoXConfig.cogvideox_5b()
    n_tokens = cfg.max_text_seq_length + cfg.sample_frames * (
        cfg.sample_height // cfg.patch_size) * (cfg.sample_width // cfg.patch_size)
    dit_shape = (2, n_tokens, cfg.num_heads, cfg.head_dim)  # denoise: CFG pair
    train_shape = (1, n_tokens, cfg.num_heads, cfg.head_dim)  # train: batch 1 per forward

    vcfg = VGGTConfig()
    n_frame = 1 + vcfg.backbone_register_tokens + (vcfg.img_size // vcfg.patch_size) ** 2
    vggt_shape = (4 * 10, n_frame, vcfg.num_heads, vcfg.embed_dim // vcfg.num_heads)
    vggt_global_shape = (4, 10 * n_frame, vcfg.num_heads, vcfg.embed_dim // vcfg.num_heads)
    cam_shape = (4, 10, vcfg.num_heads, vcfg.tokens_dim // vcfg.num_heads)
    from videogpa_torch.models.wan import WanConfig

    wcfg = WanConfig.ti2v_5b()
    wan_tokens = math.prod(n // p for n, p in zip(WAN_LATENT[1:], wcfg.patch_size))
    # Wan2.2 DiT self-attention, batch 1 per train forward: (1, 18480, 24, 128)
    wan_shape = (1, wan_tokens, wcfg.num_heads, wcfg.head_dim)

    phase_build()
    fwd_err, fwd_plain_ms = phase_parity(dit_shape, vggt_global_shape)
    bwd_err, bwd_plain_ms = phase_parity_bwd(train_shape)
    short_err, short_plain_ms = phase_parity_short(vggt_shape)
    d128_f32_err, d128_bf16_err, cam_plain_ms, wan_plain_ms = phase_parity_d128(
        cam_shape, wan_shape, (vggt_shape, vggt_global_shape))
    k7_err, k7_plain_ms, k7_cross_plain_ms, k6_wan_err, k6_cross_plain_ms = (
        phase_parity_bwd_d128(wan_shape, wcfg.text_len))
    zbuf_plain_ms = phase_parity_zbuffer()
    k8_err, k9_err, k8_plain_ms, k9_plain_ms = phase_parity_int8(dit_shape, vggt_global_shape,
                                                                 wan_shape)
    headdim = phase_parity_headdim()
    headdim_launches = headdim["launches"]
    f32_bwd = phase_parity_f32_bwd(cam_shape, vggt_shape)
    wide = phase_timing_wide()
    phase_parity_quant(dit_shape)
    phase_slice()
    phase_slice_dpo()
    phase_slice_scorer()
    phase_slice_vggt_bf16()
    phase_slice_wan()
    phase_slice_int8()
    phase_slice_sampling()
    phase_slice_wan_vae()
    main_run = phase_main()
    sample_run = phase_sample(main_run.pop("dit"))
    train_run = phase_train()
    scorer_run = phase_scorer()
    score_files_run = phase_score_files()
    log("[score_files] clips/min through score_groups: " + json.dumps(
        {tag: round(r["clips_per_min"], 1) for tag, r in score_files_run["runs"].items()})
        + f"; [scorer]'s process_frames_batch (six metrics with LPIPS VGG16, warm batches): "
        + json.dumps([round(x, 1) for x in scorer_run["clips_per_min"][1:]])
        + " (the CLI scores the consistency score alone, MSE-only with no LPIPS network)")
    train_files_run = phase_train_files(score_files_run["runs"]["batch4"]["json"])
    wan_run = phase_wan()
    wan_dit = wan_run.pop("dit")
    wan_sample_run = phase_wan_sample(wan_dit)
    encode_wan_run = phase_encode_files_wan(wan_sample_run.pop("vae"), wan_sample_run.pop("t5"))
    wan_train_files_run = phase_wan_train_files(wan_dit)
    del wan_dit
    torch.cuda.empty_cache()
    wan_train_run = phase_wan_train()
    encode_cog_run = phase_encode_files_cogvideox()
    main_int8_run = phase_main_int8(main_run["latents"])
    scorer_int8_run = phase_scorer_int8(scorer_run["results"])
    wan_int8_run = phase_wan_int8()
    timing = phase_timing(dit_shape, train_shape, vggt_global_shape)
    timing.update(phase_timing_scorer(vggt_shape, cam_shape, vggt_global_shape))
    timing.update(phase_timing_wan(wan_shape, wcfg.text_len))
    timing.update(phase_timing_int8(dit_shape, vggt_global_shape, wan_shape))

    attn_share = main_run["launches_per_step"] * timing["fwd_ms"] / main_run["step_ms"][-1]
    per_mini = (train_run["launches"]["flash_attn_fwd"] // 4,
                train_run["launches"]["flash_attn_bwd"] // 4)
    train_attn_ms = per_mini[0] * timing["fwd_ms_train_shape"] + per_mini[1] * timing["bwd_ms"]
    log("[timing] " + json.dumps({
        "denoise_step_ms": main_run["step_ms"],
        "request_s": main_run["request_s"],
        "denoise_peak_allocated_gb": main_run["peak_gb"],
        "train_mini_step_ms": train_run["step_ms"],
        "train_update_ms": train_run["update_ms"],
        "train_peak_allocated_gb": train_run["peak_gb"],
        "train_checkpoint_save_restore_s": train_run["checkpoint_s"],
        "scorer_batch_ms": scorer_run["batch_ms"],
        "scorer_clips_per_min": scorer_run["clips_per_min"],
        "scorer_peak_allocated_gb": scorer_run["peak_gb"],
        "flash_attn_fwd_ms_at_dit_shape": timing["fwd_ms"],
        "flash_attn_fwd_tflops": timing["fwd_tflops"],
        "flash_attn_fwd_bound_ms": timing["fwd_bound_ms"],
        "flash_attn_fwd_sdpa_ms": timing["fwd_library_ms"],
        "flash_attn_fwd_plain_ms_over_head_chunks": fwd_plain_ms,
        "flash_attn_fwd_ms_at_train_shape_with_lse": timing["fwd_ms_train_shape"],
        "flash_attn_fwd_train_shape_sdpa_ms_tflops": [timing["fwd_train_library_ms"],
                                                      timing["fwd_train_tflops"]],
        "flash_attn_fwd_vggt_global": {k: v for k, v in timing.items()
                                       if k.startswith("fwd_vggt_")},
        "flash_attn_fwd_registers_smem": [timing["fwd_registers_at_launch"],
                                          timing["fwd_smem_bytes"]],
        "flash_attn_bwd_ms_at_train_shape": timing["bwd_ms"],
        "flash_attn_bwd_tflops": timing["bwd_tflops"],
        "flash_attn_bwd_bound_ms": timing["bwd_bound_ms"],
        "flash_attn_bwd_sdpa_backward_ms": timing["bwd_library_ms"],
        "flash_attn_bwd_plain_ms_over_head_chunks": bwd_plain_ms,
        "flash_attn_bwd_registers_smem_splits": [timing["bwd_registers_at_launch"],
                                                 timing["bwd_smem_bytes"],
                                                 timing["bwd_query_splits"]],
        "scorer_k4_k6_k5": {k: v for k, v in timing.items()
                            if k[:3] in ("k4_", "k5_") or k.startswith("k6_f32")},
        "wan_denoise_step_ms": wan_run["step_ms"],
        "wan_request_s": wan_run["request_s"],
        "wan_denoise_peak_allocated_gb": wan_run["peak_gb"],
        "wan_train_mini_step_ms": wan_train_run["step_ms"],
        "wan_train_update_ms": wan_train_run["update_ms"],
        "wan_train_peak_allocated_gb": wan_train_run["peak_gb"],
        "wan_k6_bf16": {k: v for k, v in timing.items()
                        if k.startswith("k6_") and not k.startswith("k6_f32")},
        "wan_k7": {k: v for k, v in timing.items() if k.startswith("k7_")},
        "wan_k7_plain_ms_over_head_chunks": {"self": k7_plain_ms, "cross": k7_cross_plain_ms},
        "wan_k6_plain_ms_at_cross_shape": k6_cross_plain_ms,
        "int8_denoise_step_ms": main_int8_run["step_ms"],
        "int8_denoise_request_s": main_int8_run["request_s"],
        "int8_denoise_peak_allocated_gb": main_int8_run["peak_gb"],
        "int8_denoise_quantise_peak_gb": main_int8_run["quantise_peak_gb"],
        "int8_denoise_quantise_s": main_int8_run["quantise_s"],
        "int8_denoise_weights_gb_before_after": main_int8_run["weights_gb"],
        "int8_denoise_cos_rel_vs_exact": main_int8_run["drift_cos_rel"],
        "int8_scorer_batch_ms": scorer_int8_run["batch_ms"],
        "int8_scorer_clips_per_min": scorer_int8_run["clips_per_min"],
        "int8_scorer_peak_allocated_gb": scorer_int8_run["peak_gb"],
        "int8_scorer_drift_vs_exact": scorer_int8_run["drift"],
        "int8_wan_step_ms": wan_int8_run["step_ms"],
        "int8_wan_peak_allocated_gb": wan_int8_run["peak_gb"],
        "int8_k8_k9_w8a8": {k: v for k, v in timing.items()
                            if k[:3] in ("k8_", "k9_", "fc1")},
        "int8_plain_ms_over_head_chunks": {"k8": k8_plain_ms, "k9": k9_plain_ms},
        "sample_t5_encode_ms": sample_run["t5_ms"],
        "sample_denoise_step_ms": sample_run["step_ms"],
        "sample_decode_ms": sample_run["decode_ms"],
        "sample_decode_tile": sample_run["tile"],
        "sample_decode_conv_tflop": sample_run["decode_conv_tflop"],
        "sample_t2v_s": sample_run["total_s"],
        "sample_peak_allocated_gb": sample_run["peak_gb"],
        "sample_i2v_s": sample_run["i2v_s"],
        "sample_i2v_layers": sample_run["i2v_layers"],
        "sample_i2v_peak_allocated_gb": sample_run["i2v_peak_gb"],
        "sample_int32_probe": sample_run["int32_probe"],
        "score_files": {k: v for k, v in score_files_run.items() if k != "runs"},
        "score_files_runs": {tag: {k: v for k, v in r.items() if k not in ("scores", "json")}
                             for tag, r in score_files_run["runs"].items()},
        "train_files": train_files_run,
        "wan_sample": {k: v for k, v in wan_sample_run.items() if k != "launches"},
        "encode_files": {"wan": encode_wan_run, "cogvideox": encode_cog_run},
        "wan_train_files": wan_train_files_run,
        "flash_attn_bwd_f32": f32_bwd,
        "parity_headdim_launches": headdim_launches,
        "wide_and_int8_f32_entries": wide,
        "attention_share_of_warm_denoise_step": attn_share,
        "attention_share_of_last_train_mini_step": train_attn_ms / train_run["step_ms"][-1],
        "dit_attention_shape_bnhd": list(dit_shape),
        "train_attention_shape_bnhd": list(train_shape),
        "vggt_frame_attention_shape_bnhd": list(vggt_shape),
        "vggt_global_attention_shape_bnhd": list(vggt_global_shape),
        "camera_head_attention_shape_bnhd": list(cam_shape),
        "wan_attention_shape_bnhd": list(wan_shape),
        "wan_cross_attention_keys": wcfg.text_len,
        "card": card,
        "wall_s": time.perf_counter() - t_start,
    }))
    log(card)
    runs = {"denoise": main_run["launches"], "train": train_run["launches"],
            "scorer": scorer_run["launches"], "wan": wan_run["launches"],
            "wan_train": wan_train_run["launches"],
            "denoise_int8": main_int8_run["launches"],
            "scorer_int8": scorer_int8_run["launches"], "wan_int8": wan_int8_run["launches"],
            "sample": sample_run["launches"], "sample_i2v": sample_run["i2v_launches"],
            "score_files": {k: sum(r["launches"][k] for r in score_files_run["runs"].values())
                            for k in scorer_run["launches"]},
            "train_files": {k: train_files_run["run_launches"][k]
                            + train_files_run["resume_launches"][k]
                            for k in train_run["launches"]},
            "wan_sample": wan_sample_run["launches"],
            "encode_files": {k: encode_wan_run["launches"][k] + encode_cog_run["launches"][k]
                             for k in train_run["launches"]},
            "wan_train_files": {k: wan_train_files_run["run_launches"][k]
                                + wan_train_files_run["resume_launches"][k]
                                for k in train_run["launches"]}}

    def by_path(name):
        """A wrapper's launches on each main path, as counted in that path's run."""
        per_path = {path: launches[name] for path, launches in runs.items()}
        return {"launches": sum(per_path.values()), "launches_by_path": per_path}

    log(json.dumps({"kernels": [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd.cu",
         "replaces": "videogpa_tpu/ops/attention.py:221",
         **by_path("flash_attn_fwd"),
         "max_abs_err": fwd_err, "ms": timing["fwd_ms"], "plain_ms": fwd_plain_ms,
         "bound_ms": timing["fwd_bound_ms"], "bound_by": timing["fwd_bound_by"],
         "library_ms": timing["fwd_library_ms"],
         "train_shape_with_lse": {"ms": timing["fwd_ms_train_shape"],
                                  "bound_ms": timing["fwd_train_bound_ms"],
                                  "library_ms": timing["fwd_train_library_ms"]},
         "vggt_global_shape": {"ms": timing["fwd_vggt_ms"],
                               "bound_ms": timing["fwd_vggt_bound_ms"],
                               "bound_by": timing["fwd_vggt_bound_by"],
                               "library_ms": timing["fwd_vggt_library_ms"]}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd.cu",
         "replaces": "videogpa_tpu/ops/attention.py:951,983",
         **by_path("flash_attn_bwd"),
         "max_abs_err": bwd_err, "ms": timing["bwd_ms"], "plain_ms": bwd_plain_ms,
         "bound_ms": timing["bwd_bound_ms"], "bound_by": timing["bwd_bound_by"],
         "library_ms": timing["bwd_library_ms"]},
        {"name": "flash_attn_short", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_short.cu",
         "replaces": "videogpa_tpu/ops/attention.py:544",
         **by_path("flash_attn_short"),
         "max_abs_err": short_err, "ms": timing["k4_ms"], "plain_ms": short_plain_ms,
         "bound_ms": timing["k4_bound_ms"], "bound_by": timing["k4_bound_by"],
         "library_ms": timing["k4_library_ms"]},
        {"name": "scatter_min_u32", "route": "cuda",
         "source": "videogpa_torch/csrc/zbuffer_scatter_min.cu",
         "replaces": "videogpa_tpu/geometry/zbuffer_kernel.py:110",
         **by_path("scatter_min_u32"),
         "max_abs_err": 0.0, "ms": timing["k5_ms"], "plain_ms": zbuf_plain_ms,
         "bound_ms": timing["k5_bound_ms"], "bound_by": timing["k5_bound_by"],
         "library_ms": timing["k5_library_ms"]},
        {"name": "flash_attn_fwd_f32", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_d128.cu",
         "replaces": "videogpa_tpu/ops/attention.py:65",
         **by_path("flash_attn_fwd_f32"),
         "max_abs_err": d128_f32_err, "ms": timing["k6_f32_ms"], "plain_ms": cam_plain_ms,
         "bound_ms": timing["k6_f32_bound_ms"], "bound_by": timing["k6_f32_bound_by"],
         "library_ms": timing["k6_f32_library_ms"],
         "device_ms": timing["k6_f32_device_ms"],
         "library_device_ms": timing["k6_f32_library_device_ms"],
         **{f"{tag}_rows": {"ms": timing[f"k6_f32_{tag}_ms"],
                            "bound_ms": timing[f"k6_f32_{tag}_bound_ms"],
                            "bound_by": timing[f"k6_f32_{tag}_bound_by"],
                            "library_ms": timing[f"k6_f32_{tag}_library_ms"]}
            for tag in ("frame", "global")}},
        {"name": "flash_attn_fwd_d128", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_d128.cu",
         "replaces": "videogpa_tpu/ops/attention.py:65",
         **by_path("flash_attn_fwd_d128"),
         "max_abs_err": max(d128_bf16_err, k6_wan_err), "ms": timing["k6_self_ms"],
         "plain_ms": wan_plain_ms,
         "bound_ms": timing["k6_self_bound_ms"], "bound_by": timing["k6_self_bound_by"],
         "library_ms": timing["k6_self_library_ms"], "with_lse_ms": timing["k6_self_lse_ms"],
         "cross_shape": {"ms": timing["k6_cross_ms"], "plain_ms": k6_cross_plain_ms,
                         "bound_ms": timing["k6_cross_bound_ms"],
                         "bound_by": timing["k6_cross_bound_by"],
                         "library_ms": timing["k6_cross_library_ms"],
                         "with_lse_ms": timing["k6_cross_lse_ms"]}},
        {"name": "flash_attn_bwd_d128", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd_d128.cu",
         "replaces": "videogpa_tpu/ops/attention.py:883,908",
         **by_path("flash_attn_bwd_d128"),
         "max_abs_err": k7_err, "ms": timing["k7_self_ms"], "plain_ms": k7_plain_ms,
         "bound_ms": timing["k7_self_bound_ms"], "bound_by": timing["k7_self_bound_by"],
         "library_ms": timing["k7_self_library_ms"],
         "cross_shape": {"ms": timing["k7_cross_ms"], "plain_ms": k7_cross_plain_ms,
                         "bound_ms": timing["k7_cross_bound_ms"],
                         "bound_by": timing["k7_cross_bound_by"],
                         "library_ms": timing["k7_cross_library_ms"]}},
        # no PyTorch call computes int8-QK attention, so library_ms is null;
        # the exact kernel's and SDPA's times at the same shape stand beside
        {"name": "flash_attn_int8", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_int8.cu",
         "replaces": "videogpa_tpu/ops/attention.py:640",
         **by_path("flash_attn_int8"),
         "max_abs_err": k8_err, "ms": timing["k8_ms"], "plain_ms": k8_plain_ms,
         "bound_ms": timing["k8_bound_ms"], "bound_by": timing["k8_bound_by"],
         "library_ms": None, "quantize_qk_ms": timing["k8_quantize_ms"],
         "turns_ms": timing["k8_turns_ms"], "tflops": timing["k8_tflops"],
         "registers_smem": [timing["k8_registers_at_launch"], timing["k8_smem_bytes"]],
         "exact_function": {"flash_attn_fwd_ms": timing["fwd_ms"],
                            "flash_attn_fwd_same_phase_turns_ms":
                                timing["k8_exact_kernel_turns_ms"],
                            "sdpa_ms": timing["fwd_library_ms"]},
         "vggt_global_shape": {"ms": timing["k8_vggt_ms"],
                               "bound_ms": timing["k8_vggt_bound_ms"],
                               "bound_by": timing["k8_vggt_bound_by"],
                               "quantize_qk_ms": timing["k8_vggt_quantize_ms"],
                               "flash_attn_fwd_same_phase_turns_ms":
                                   timing["k8_vggt_exact_kernel_turns_ms"]}},
        {"name": "flash_attn_int8_d128", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_int8.cu",
         "replaces": "videogpa_tpu/ops/attention.py:766",
         **by_path("flash_attn_int8_d128"),
         "max_abs_err": k9_err, "ms": timing["k9_ms"], "plain_ms": k9_plain_ms,
         "bound_ms": timing["k9_bound_ms"], "bound_by": timing["k9_bound_by"],
         "library_ms": None, "quantize_qk_ms": timing["k9_quantize_ms"],
         "turns_ms": timing["k9_turns_ms"], "tflops": timing["k9_tflops"],
         "registers_smem": [timing["k9_registers_at_launch"], timing["k9_smem_bytes"]],
         "exact_function": {"flash_attn_fwd_d128_ms": timing["k6_self_ms"],
                            "flash_attn_fwd_d128_same_phase_turns_ms":
                                timing["k9_exact_kernel_turns_ms"],
                            "sdpa_ms": timing["k6_self_library_ms"]}},
        # the f32 entry of K3/K7: no main path differentiates f32 attention
        # (0 launches on each); it ran in [parity_f32_bwd] and [parity_headdim]
        {"name": "flash_attn_bwd_f32", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd_f32.cu",
         "replaces": "videogpa_tpu/ops/attention.py:951,983,883,908",
         **by_path("flash_attn_bwd_f32"),
         "launches_in_parity_phases": headdim_launches["flash_attn_bwd_f32"],
         "max_abs_err": f32_bwd["max_abs_err"],
         "ms": f32_bwd["shapes"]["camera head"]["ms"],
         "plain_ms": f32_bwd["shapes"]["camera head"]["plain_ms"],
         "bound_ms": f32_bwd["shapes"]["camera head"]["bound_ms"],
         "bound_by": f32_bwd["shapes"]["camera head"]["bound_by"],
         "library_ms": f32_bwd["shapes"]["camera head"]["library_ms"],
         "shapes": {k: v for k, v in f32_bwd["shapes"].items() if v["shape"][-1] <= 128},
         "edge_cases_max_abs_err": f32_bwd["edge_cases"],
         "registers_smem": {"d16": f32_bwd["registers_smem_d16"],
                            "d64": f32_bwd["registers_smem_d64"],
                            "d128": f32_bwd["registers_smem_d128"]}},
        # the entries above head_dim 128 and the int8 route with f32 operands:
        # no model of the repo has such a head or runs int8 in f32, so every
        # main path launches them 0 times; they ran in [parity_headdim],
        # [parity_f32_bwd] and [timing]
        {"name": "flash_attn_fwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_wide.cu",
         "replaces": "videogpa_tpu/ops/attention.py:65",
         **by_path("flash_attn_fwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_fwd_wide"],
         "max_abs_err": max(headdim["wide_max_abs_err"]["float32"], wide["float32"]["max_abs_err"]),
         **{k: wide["float32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "shape_bnhd")},
         "bf16": {**wide["bfloat16"],
                  "max_abs_err_headdim": headdim["wide_max_abs_err"]["bfloat16"]},
         "registers_smem": {k: v for k, v in wide["registers_smem"].items()
                            if k.startswith("fwd_wide")}},
        {"name": "flash_attn_bwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd_f32.cu",
         "replaces": "videogpa_tpu/ops/attention.py:883,908",
         **by_path("flash_attn_bwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_bwd_wide"],
         "max_abs_err": f32_bwd["wide_max_abs_err"],
         **{k: f32_bwd["shapes"]["long row D=256 f32"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
         "bf16": f32_bwd["shapes"]["long row D=256 bf16"],
         "registers_smem": {"f32": f32_bwd["registers_smem_d128"],
                            "bf16": f32_bwd["registers_smem_wide_bf16"]}},
        {"name": "flash_attn_int8_f32", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_wide.cu",
         "replaces": "videogpa_tpu/ops/attention.py:640",
         **by_path("flash_attn_int8_f32"),
         "launches_in_parity_phases": headdim_launches["flash_attn_int8_f32"],
         "max_abs_err": max(headdim["int8_f32_max_abs_err"], wide["int8_f32"]["max_abs_err"]),
         **{k: wide["int8_f32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "quantize_qk_ms", "shape_bnhd")},
         "registers_smem": {k: v for k, v in wide["registers_smem"].items()
                            if k.startswith("int8")}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
