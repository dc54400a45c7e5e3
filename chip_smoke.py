#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``videogpa_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             into build/kernels/, one nvcc process per source, all at once.
2. parity  — each kernel against its plain PyTorch version in bf16, at the
             shapes the main paths give it and at edge cases (ragged and
             cross lengths, every supported head dim, extreme logits,
             strided views): the forward K1 and the backward K3, and
             ``attention()`` on CUDA tensors that require grad yielding
             K3's gradients.
3. slice   — the tiny CogVideoX DiT, and one tiny DPO train step, on the
             card in bf16 against the same weights on the CPU in f32.
4. main    — the CogVideoX-5B denoise path at full width and depth (42
             layers, hidden 3072, 48 heads x 64) on random bf16 weights:
             2 requests, each a CFG pair at 49f@480x720 (latents
             13x16x60x90, 17,550 video + 226 text tokens) with seeded
             stand-in T5 embeddings, 2 DPM steps each. Checks finite output
             and that every attention of the path launched the kernel.
   profile — device time by kernel group over one more (profiled) step.
5. train   — the CogVideoX-5B Diffusion-DPO LoRA train step at full width
             and depth with the CogVideoX-5B recipe (batch 1, accumulate 2,
             LoRA r 64 / alpha 128, remat) on a synthetic preference dataset
             of full-size latents written to a temporary directory: 4
             mini-steps, so 2 optimiser updates. Checks finite metrics, LoRA
             B off zero after the second update, the kernels' launch counts,
             and a checkpoint save/restore round trip.
   profile — device time by kernel group over one more (profiled) mini-step.
6. timing  — ms per denoise step and per train mini-step, each kernel's ms
             at the main-path shape beside its bound, its plain version and
             the library call.

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
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_build() -> None:
    from videogpa_torch.ops import _kernels

    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"[build] {len(_kernels.SOURCES)} source(s), {len(logs)} compiled in "
        f"{time.perf_counter() - t0:.1f} s -> {_kernels.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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


def phase_parity(dit_shape):
    """Kernel vs plain version; returns (max O error, plain ms at the DiT shape)."""
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

    # the DiT shape at full size; the plain version needs a (N, N) f32 score
    # matrix per head, so it runs over chunks of 4 heads covering every head
    B, N, H, D = dit_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    o, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    chunk = 4
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
                fail(f"flash_attn_fwd disagrees at the DiT shape, batch {b}, heads {h}..")
            del ro, rl
    log(f"[parity] DiT shape {dit_shape} bnhd, all {B * H} heads in chunks of {chunk}: "
        f"max|dO| {worst_o:.3e} (atol {min(atols):.2e}..{max(atols):.2e} + rtol {O_RTOL}), "
        f"max|dLSE| {worst_lse:.3e} ok; plain version "
        f"{plain_ms:.1f} ms over the chunks")
    errs.append(worst_o)
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return max(errs), plain_ms


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
    from videogpa_torch.ops.attention import flash_attn_bwd, flash_attn_fwd

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
    request_s = []
    flash_attn_fwd.launches = flash_attn_bwd.launches = 0
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
    launches, bwd_launches = flash_attn_fwd.launches, flash_attn_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = num_requests * steps * cfg.num_layers
    log(f"[main] flash_attn_fwd launches {launches} (expected {num_requests} requests x "
        f"{steps} steps x {cfg.num_layers} layers = {expected}), flash_attn_bwd "
        f"{bwd_launches} (expected 0)")
    if launches != expected or bwd_launches != 0:
        fail("the denoise path did not run every attention through the forward kernel alone")
    settings1 = SamplerSettings(num_inference_steps=1, sampler="dpm")
    profile = profile_device_time("one denoise step (profiled)", lambda: denoise_loop(
        dit, text, negative, settings1, latent_shape,
        generator=torch.Generator(device="cuda").manual_seed(5)))
    del dit
    torch.cuda.empty_cache()
    return {
        "launches": launches, "request_s": request_s,
        "step_ms": [1e3 * s / steps for s in request_s], "peak_gb": peak_gb,
        "launches_per_step": launches // (num_requests * steps), "profile": profile,
    }


def _kernel_group(name: str) -> str:
    if "flash_attn_fwd" in name:
        return "flash_attn_fwd"
    if "flash_attn_bwd" in name:
        return "flash_attn_bwd"
    if any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
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


def phase_parity_bwd(train_shape):
    """K3 against its plain version, and attention() autograd through it;
    returns (max gradient error over the element-wise cases, plain ms at
    the training shape)."""
    import torch

    from videogpa_torch.ops.attention import (
        attention, flash_attn_bwd, flash_attn_bwd_reference, flash_attn_fwd)

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
    ]
    errs = []
    for name, layout, (q, k, v) in cases:
        extreme = name.startswith("extreme")
        o, lse = flash_attn_fwd(q, k, v, layout=layout, with_lse=True)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attn_bwd(q, k, v, o, lse, do, layout=layout)
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
                log(f"[parity] K3 {name}: " + ", ".join(parts) + " MISMATCH")
                fail(f"flash_attn_bwd {gname} disagrees with its plain version on {name}")
        limit = (f"vs the f32 plain version, RMS ratio limit {EXTREME_REL_RMS}" if extreme
                 else f"+ rtol {GRAD_RTOL}")
        log(f"[parity] K3 {name}: " + ", ".join(parts) + f" {limit} ok")
    del cases, packed, o, lse, do, got, want, ops

    # attention() on CUDA tensors that require grad: the autograd Function
    # runs K1 with LSE forward and K3 backward, bit for bit the direct calls
    q, k, v = (x.requires_grad_(True) for x in _attn_case(gen, 1, 300, 300, 4, 64, "bnhd"))
    fwd0, bwd0 = flash_attn_fwd.launches, flash_attn_bwd.launches
    o = attention(q, k, v, layout="bnhd")
    if type(o.grad_fn).__name__ != "_FlashAttentionBackward":
        fail(f"attention() on CUDA tensors that require grad has grad_fn {o.grad_fn}")
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o.backward(do)
    with torch.no_grad():
        o2, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
        direct = flash_attn_bwd(q, k, v, o2, lse, do, layout="bnhd")
    same = all(torch.equal(x.grad, d) for x, d in zip((q, k, v), direct))
    counted = (flash_attn_fwd.launches - fwd0, flash_attn_bwd.launches - bwd0) == (2, 2)
    log(f"[parity] attention() autograd on CUDA: grad_fn _FlashAttentionBackward, "
        f"q/k/v grads equal to direct flash_attn_bwd: {same}, launches counted: {counted}")
    if not (same and counted and torch.equal(o.detach(), o2)):
        fail("attention() autograd on CUDA did not yield K3's gradients")
    del q, k, v, o, o2, do, direct

    # the training shape at full size; the plain version needs (N, N) f32
    # score matrices per head, so it runs over chunks of 4 heads
    B, N, H, D = train_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    o, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    grads = flash_attn_bwd(q, k, v, o, lse, do, layout="bnhd")
    chunk = 4
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain_ms, worst, atols = 0.0, [0.0, 0.0, 0.0], []
    for b in range(B):
        for h in range(0, H, chunk):
            sl = (slice(b, b + 1), slice(None), slice(h, h + chunk))
            start.record()
            want = flash_attn_bwd_reference(q[sl], k[sl], v[sl], o[sl],
                                            lse[b:b + 1, h:h + chunk].contiguous(), do[sl],
                                            layout="bnhd")
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            for i, (g, w) in enumerate(zip(grads, want)):
                err, atol, ok = _grad_check(g[sl], w)
                worst[i] = max(worst[i], err)
                atols.append(atol)
                if not ok:
                    fail(f"flash_attn_bwd disagrees at the training shape, batch {b}, "
                         f"heads {h}.., gradient {'QKV'[i]}")
            del want
    log(f"[parity] K3 training shape {train_shape} bnhd, all {B * H} heads in chunks of "
        f"{chunk}: max|dQ| {worst[0]:.3e}, max|dK| {worst[1]:.3e}, max|dV| {worst[2]:.3e} "
        f"(atol {min(atols):.2e}..{max(atols):.2e} + rtol {GRAD_RTOL}) ok; plain version "
        f"{plain_ms:.1f} ms over the chunks")
    errs.extend(worst)
    del q, k, v, o, lse, do, grads
    torch.cuda.empty_cache()
    return max(errs), plain_ms


def _tiny_dpo_step(model, cfg, lora, batch, draws, compute_dtype):
    """Two train-step calls (accumulate 2, warmup 0) on one batch: the first
    leaves the LoRA gradients in the accumulator, the second updates."""
    import torch

    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)

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


def _write_preference_dataset(root: str, cfg, seed: int = 0):
    """Two groups of two scored videos with full-size latents (C, F, H, W)
    and a T5-shaped condition, in the metadata schema of train.dataset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "latents"), exist_ok=True)
    lat_shape = (cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height,
                 cfg.sample_width)
    groups = []
    for g, scores in enumerate(((0.3, 0.7), (0.2, 0.6))):
        cond = f"latents/cond_{g}.npz"
        np.savez(os.path.join(root, cond), encoder_hidden_states=rng.standard_normal(
            (cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32))
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
    from videogpa_torch.ops.attention import flash_attn_bwd, flash_attn_fwd
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
        _write_preference_dataset(os.path.join(root, "data"), cfg)
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
        flash_attn_fwd.launches = flash_attn_bwd.launches = 0
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
        fwd, bwd = flash_attn_fwd.launches, flash_attn_bwd.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        L = cfg.num_layers
        want_fwd, want_bwd = mini_steps * 6 * L, mini_steps * 2 * L
        log(f"[train] flash_attn_fwd launches {fwd} (expected {mini_steps} mini-steps x 6 "
            f"forwards (2 policy, 2 remat recomputes, 2 reference) x {L} layers = {want_fwd}); "
            f"flash_attn_bwd launches {bwd} (expected {mini_steps} x 2 policy backwards x {L} "
            f"= {want_bwd}); peak allocated {peak_gb:.2f} GB")
        if not all(math.isfinite(v) for m in metrics_log for v in m.values()):
            fail("non-finite train metrics")
        if not (b_norms[1] == 0.0 and b_norms[-1] > 0.0):
            fail(f"LoRA B: expected zero after update 1 (lr schedule(0) = 0) and off zero "
                 f"after update 2, got {b_norms}")
        if (fwd, bwd) != (want_fwd, want_bwd):
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
    return {"fwd_launches": fwd, "bwd_launches": bwd, "step_ms": step_ms,
            "update_ms": [step_ms[i] + step_ms[i + 1] for i in range(0, mini_steps - 1, 2)],
            "peak_gb": peak_gb, "profile": profile, "metrics": metrics_log,
            "checkpoint_s": [save_s, restore_s]}


def phase_timing(dit_shape, train_shape):
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import flash_attn_bwd, flash_attn_fwd

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, N, H, D = dit_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    out["fwd_ms"] = cuda_ms(lambda: flash_attn_fwd(q, k, v, layout="bnhd"), iters=10)
    # yardstick only: the port never calls SDPA
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["fwd_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
    flops = 4.0 * B * H * N * N * D
    nbytes = 2.0 * B * H * D * 4 * N
    out["fwd_bound_ms"] = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    out["fwd_bound_by"] = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    out["fwd_tflops"] = flops / out["fwd_ms"] / 1e9
    del q, k, v, qt, kt, vt

    B, N, H, D = train_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    out["fwd_ms_train_shape"] = cuda_ms(
        lambda: flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True), iters=10)
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
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from videogpa_torch.models.cogvideox import CogVideoXConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_name_and_power()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    cfg = CogVideoXConfig.cogvideox_5b()
    n_tokens = cfg.max_text_seq_length + cfg.sample_frames * (
        cfg.sample_height // cfg.patch_size) * (cfg.sample_width // cfg.patch_size)
    dit_shape = (2, n_tokens, cfg.num_heads, cfg.head_dim)  # denoise: CFG pair
    train_shape = (1, n_tokens, cfg.num_heads, cfg.head_dim)  # train: batch 1 per forward

    phase_build()
    fwd_err, fwd_plain_ms = phase_parity(dit_shape)
    bwd_err, bwd_plain_ms = phase_parity_bwd(train_shape)
    phase_slice()
    phase_slice_dpo()
    main_run = phase_main()
    train_run = phase_train()
    timing = phase_timing(dit_shape, train_shape)

    attn_share = main_run["launches_per_step"] * timing["fwd_ms"] / main_run["step_ms"][-1]
    per_mini = train_run["fwd_launches"] // 4, train_run["bwd_launches"] // 4
    train_attn_ms = per_mini[0] * timing["fwd_ms_train_shape"] + per_mini[1] * timing["bwd_ms"]
    log("[timing] " + json.dumps({
        "denoise_step_ms": main_run["step_ms"],
        "request_s": main_run["request_s"],
        "denoise_peak_allocated_gb": main_run["peak_gb"],
        "train_mini_step_ms": train_run["step_ms"],
        "train_update_ms": train_run["update_ms"],
        "train_peak_allocated_gb": train_run["peak_gb"],
        "train_checkpoint_save_restore_s": train_run["checkpoint_s"],
        "flash_attn_fwd_ms_at_dit_shape": timing["fwd_ms"],
        "flash_attn_fwd_tflops": timing["fwd_tflops"],
        "flash_attn_fwd_bound_ms": timing["fwd_bound_ms"],
        "flash_attn_fwd_sdpa_ms": timing["fwd_library_ms"],
        "flash_attn_fwd_plain_ms_over_head_chunks": fwd_plain_ms,
        "flash_attn_fwd_ms_at_train_shape_with_lse": timing["fwd_ms_train_shape"],
        "flash_attn_bwd_ms_at_train_shape": timing["bwd_ms"],
        "flash_attn_bwd_tflops": timing["bwd_tflops"],
        "flash_attn_bwd_bound_ms": timing["bwd_bound_ms"],
        "flash_attn_bwd_sdpa_backward_ms": timing["bwd_library_ms"],
        "flash_attn_bwd_plain_ms_over_head_chunks": bwd_plain_ms,
        "attention_share_of_warm_denoise_step": attn_share,
        "attention_share_of_last_train_mini_step": train_attn_ms / train_run["step_ms"][-1],
        "dit_attention_shape_bnhd": list(dit_shape),
        "train_attention_shape_bnhd": list(train_shape),
        "card": card,
        "wall_s": time.perf_counter() - t_start,
    }))
    log(card)
    log(json.dumps({"kernels": [
        {
            "name": "flash_attn_fwd",
            "route": "cuda",
            "source": "videogpa_torch/csrc/flash_attn_fwd.cu",
            "replaces": "videogpa_tpu/ops/attention.py:221",
            "launches": main_run["launches"] + train_run["fwd_launches"],
            "launches_by_path": {"denoise": main_run["launches"],
                                 "train": train_run["fwd_launches"]},
            "max_abs_err": fwd_err,
            "ms": timing["fwd_ms"],
            "plain_ms": fwd_plain_ms,
            "bound_ms": timing["fwd_bound_ms"],
            "bound_by": timing["fwd_bound_by"],
            "library_ms": timing["fwd_library_ms"],
        },
        {
            "name": "flash_attn_bwd",
            "route": "cuda",
            "source": "videogpa_torch/csrc/flash_attn_bwd.cu",
            "replaces": "videogpa_tpu/ops/attention.py:951,983",
            "launches": train_run["bwd_launches"],
            "launches_by_path": {"denoise": 0, "train": train_run["bwd_launches"]},
            "max_abs_err": bwd_err,
            "ms": timing["bwd_ms"],
            "plain_ms": bwd_plain_ms,
            "bound_ms": timing["bwd_bound_ms"],
            "bound_by": timing["bwd_bound_by"],
            "library_ms": timing["bwd_library_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
