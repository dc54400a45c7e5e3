#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``videogpa_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             into build/kernels/.
2. parity  — each kernel against its plain PyTorch version in bf16, at the
             shapes the main path gives it and at edge cases (ragged and
             cross lengths, every supported head dim, extreme logits).
3. slice   — the tiny CogVideoX DiT on the card in bf16 against the same
             weights on the CPU in f32.
4. main    — the CogVideoX-5B denoise path at full width and depth (42
             layers, hidden 3072, 48 heads x 64) on random bf16 weights:
             2 requests, each a CFG pair at 49f@480x720 (latents
             13x16x60x90, 17,550 video + 226 text tokens) with seeded
             stand-in T5 embeddings, 2 DPM steps each. Checks finite output
             and that every attention of the path launched the kernel.
   profile — device time by kernel group over one more (profiled) step.
5. timing  — ms per denoise step, each kernel's ms at the main-path shape
             beside its bound, its plain version and the library call.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is present.
"""

from __future__ import annotations

import json
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
    from videogpa_torch.ops.attention import flash_attn_fwd

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
    flash_attn_fwd.launches = 0
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
    launches = flash_attn_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = num_requests * steps * cfg.num_layers
    log(f"[main] flash_attn_fwd launches {launches} (expected {num_requests} requests x "
        f"{steps} steps x {cfg.num_layers} layers = {expected})")
    if launches != expected:
        fail("the main path did not run every attention through the kernel")
    profile = phase_profile(dit, text, negative, latent_shape)
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
    if any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "gemm"
    return "other"


def phase_profile(dit, text, negative, latent_shape):
    """Device time by kernel over one warm denoise step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from videogpa_torch.models.cogvideox import SamplerSettings, denoise_loop

    settings = SamplerSettings(num_inference_steps=1, sampler="dpm")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        denoise_loop(dit, text, negative, settings, latent_shape,
                     generator=torch.Generator(device="cuda").manual_seed(5))
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
        log("[profile] the profiler recorded no device time: breakdown not measured")
        return None
    groups = {}
    for name, ms in by_kernel.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "groups_ms": groups, "top_kernels_ms": [[n[:90], ms] for n, ms in top]}
    log("[profile] one denoise step (profiled): " + json.dumps(out))
    return out


def phase_timing(dit_shape):
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import flash_attn_fwd

    B, N, H, D = dit_shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    ms = cuda_ms(lambda: flash_attn_fwd(q, k, v, layout="bnhd"), iters=10)
    # yardstick only: the port never calls SDPA
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
    flops = 4.0 * B * H * N * N * D
    nbytes = 2.0 * B * H * D * 4 * N
    bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    return {"ms": ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / ms / 1e9}


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
    dit_shape = (2, n_tokens, cfg.num_heads, cfg.head_dim)

    phase_build()
    max_err, plain_ms = phase_parity(dit_shape)
    phase_slice()
    main_run = phase_main()
    timing = phase_timing(dit_shape)

    attn_share = main_run["launches_per_step"] * timing["ms"] / main_run["step_ms"][-1]
    log("[timing] " + json.dumps({
        "denoise_step_ms": main_run["step_ms"],
        "request_s": main_run["request_s"],
        "flash_attn_fwd_ms_at_dit_shape": timing["ms"],
        "flash_attn_fwd_tflops": timing["tflops"],
        "bound_ms": timing["bound_ms"],
        "sdpa_library_ms": timing["library_ms"],
        "plain_ms_over_head_chunks": plain_ms,
        "attention_share_of_warm_step": attn_share,
        "peak_allocated_gb": main_run["peak_gb"],
        "dit_attention_shape_bnhd": list(dit_shape),
        "card": card,
        "wall_s": time.perf_counter() - t_start,
    }))
    log(card)
    log(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "videogpa_torch/csrc/flash_attn_fwd.cu",
        "replaces": "videogpa_tpu/ops/attention.py:221",
        "launches": main_run["launches"],
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": plain_ms,
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
