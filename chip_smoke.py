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
             of full-size latents written to a temporary directory: 2
             mini-steps, so 1 optimiser update. Checks finite metrics, the
             update (first moments off zero, LoRA B still zero at lr
             schedule(0) = 0), the kernels' launch counts, a checkpoint
             save/restore round trip, and the peak allocated against the
             step's reckoning (``train.memory``, within 15 %).
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
             clean first frame, 2 UniPC steps each. Checks finite output, the
             kept first frame, and that every attention launched K6 (30 self
             + 30 cross per forward) and no other kernel.
   wan-train — the Wan2.2-TI2V-5B DPO LoRA train step with its recipe
             (batch 1, accumulate 2, LoRA r 64 / alpha 128, remat) on a
             synthetic preference set with image latents: 2 mini-steps, 1
             update. Checks finite metrics, the update (as [train]), the
             launches of K6 (forward, with LSE under grad) and K7 (backward),
             and the peak allocated against the step's reckoning.
   train_memory — segments 5-7 of the JAX package's multichip dry run: rank
             0's DPO step of CogVideoX-5B-I2V and of Wan2.2-TI2V-5B at dp 2 x
             tp 4 (global batch 2) and of CogVideoX1.5-5B at dp 1 x tp 8
             (batch 1, 41,026 tokens), at full width and depth, each in a
             process of its own under PyTorch's fake process group (the three
             at once): ``train.memory``'s reckoning (FakeTensorMode, made by
             a process started after [build] beside the other phases) against
             the measured max_memory_allocated (within 15 %), the peak under
             the card's memory, the launches (K1 252 and K3 84, or K6 360 and
             K7 120), and the remat residual a rank keeps, 1/tp of the
             sequence, beside [train]'s and [wan-train]'s one-card figures.
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
             CogVideoX-5B (1 request x 2 DPM steps, K8 84 launches, against
             the exact run's latents), the VGGT-1B scorer (2 batches; a batch
             launches K8 24, K4 48, K6 f32 16, K5 4; drift of each score
             against the exact scorer) and Wan2.2-TI2V-5B (1 request x 2
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
             192), 256, 320 and 512 in bf16 and f32: forward, autograd and
             ``impl="flash_int8"`` (the exact route, bit for bit, no int8
             launch) through ``flash_attn_fwd_wide`` / ``flash_attn_bwd_wide``;
             the int8 route with f32 operands at 40, 64 and 96 through
             ``flash_attn_int8_f32``, also against exact attention; each
             against the plain version; the launch counters show K1, K3, K4,
             K6 (bf16 and f32), K7, K8, K9, the f32 backward and the three new
             entries ran.
   parity_f32_bwd — the bit-stable backwards against their plain
             versions: ``flash_attn_bwd_f32`` at the camera head, the frame
             rows, one long row and B*H = 66,000, ``flash_attn_bwd_wide`` at
             (1, 4,096, 16, 256) in f32 (the CUDA-core cluster kernel; its
             walk and grid) and bf16 (two wgmma kernels), and edge cases
             (cross and ragged lengths, head dims 16-1,088, both layouts,
             strided views, operands off 16-byte alignment, B*H = 66,000 at
             D = 128 in f32 and 192 in f32 and bf16, more key tiles than the
             grid's CTAs, a spare slot, two groups of chunks); the forward's
             O too; two runs bit-equal at every shape; ``attention()``
             autograd in f32; its ms beside its bound and SDPA's backward in
             the same dtype, and for the bf16 wide entry the bound of its
             seven products; registers and shared memory of the wide
             kernels.
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
             704 x 1,280 image, 2 UniPC steps, the streamed decode of 81
             frames; prints umT5, image-encode, step and decode ms, the
             decode's TFLOP/s, peak GB and the launches (K6 bf16 120, every
             other kernel 0).
   encode_files — ``cli.encode_wan.run`` (umT5 + Wan VAE, one group: image
             and an 81-frame 704 x 1,280 clip) and ``cli.encode.run`` (T5-XXL
             + CogVideoX VAE in f32, one group: image and a 49-frame 480 x 720
             clip), frames from memory; artifacts, ms and peak GB.
   wan_train_files — .npz latents (48, 21, 44, 80) with umT5 conditions and
             image latents; ``run_recipe("Wan2.2-TI2V-5B")`` with [wan]'s DiT
             for 2 steps with validation, a resume to step 3, the exported
             PEFT LoRA read back.
   slice_da3 — the tiny DA3 (4 views) and a small one (6 views at 280^2,
             heads of 64) in f32 on the card against the CPU: depth, conf,
             extrinsics, intrinsics and ray by rel-norm, the selected
             reference views equal; the tiny DA3 scorer, card against CPU.
   scorer_da3 — the DA3-Large scorer at full width and depth (24 blocks at
             1,024, 16 heads x 64, DualDPT 256 / (256, 512, 1,024, 1,024))
             on random weights: 2 batches of K = 4 clips x 10 frames x 518^2
             through ``process_frames_batch``, bf16 trunk, f32 heads, LPIPS
             VGG16; batch ms, clips/min, peak GB, the geometry's ranges and
             the launches a batch (K4 16, K1 8, K5 4); then in int8 mode on
             the same model and frames (K8 8, K4 16, K5 4) with each score's
             drift against exact; one profiled batch.
   replicate_files — ``replicate_torch.sh``'s two legs: ``cli.replicate``
             on [sample]'s resident CogVideoX-5B-I2V DiT, T5-XXL and VAE for
             1 prompt x 1 seed (2 DPM steps; the first frame and the writer
             in memory), a second run that skips it; DA3-Large written in the
             checkpoint key layout and read back by ``load_da3``;
             ``cli.replicate_scorer`` on 2 prompts x 4 clips (the generated
             video among them, decoded from memory) at score_batch 4, and a
             resumed run.
   parity_cog15 — K1 and K8 at CogVideoX1.5-5B's CFG pair (2, 45,106, 48,
             64) against their plain versions over one head at a time, their
             ms beside their bounds (K1's beside SDPA's, K8's in turns with
             K1's); a small CogVideoX1.5 DiT (patch_size_t 2, 2,568 tokens
             through K1) bf16 on the card against f32 on the CPU.
   cog15   — the CogVideoX1.5-5B denoise path at full width and depth (42
             layers, 48 x 64, patch 2 x 2 x 2) on random bf16 weights: one
             warm (profiled) DPM step, then 1 request x 2 DPM steps of the CFG
             pair with dynamic CFG on (1, 22, 16, 96, 170) latents (81f@768x1360
             rounded up to 22 latent frames: 45,106 tokens); K1 42 launches a
             step, every other kernel 0; step ms and peak GB.
   cog15-int8 — the same DiT after ``quantize_dit_int8`` in place under
             ``flash_int8``: 1 warm and 1 timed step, K8 42 launches, the drift
             from [cog15]'s warm step on the same draws, peak GB.
   cog15_sample — T5-XXL on a prompt and the empty negative; ``sample_t2v``
             for 2 DPM steps at 81f@768x1360 with the DiT, T5 and VAE
             resident, ``decode_latents`` of its first 2 latent frames (a
             temporal cut) and ``video_to_uint8``; then ``cli.generate.main
             --recipe CogVideoX1.5-5B`` around the resident models (1 DPM
             step, a random PEFT LoRA merged at the absolute 0.2, every one of
             the 22 latent frames decoded at 768 x 1360: 85 frames); text-
             encode, step and decode ms, frame counts, peaks, K1's launches.
   slice_da3_nested — the tiny and the small DA3, each with a mono net of
             its widths, a GSDPT head and a gaussian scene, f32 on the card
             against the CPU: mono depth and sky, ``nested_inference``
             (depth, conf, extrinsics, scale factor, reference view), GSDPT,
             ``render_3dgs`` at random and at tied depths.
   da3_nested — ``nested_inference`` on ``da3nested-giant-large`` at full
             width and depth (DA3-Giant: 40 blocks at 1,536, 24 heads x 64,
             SwiGLU; the metric DA3-Large: 24 plain blocks, the sky DPT) on
             random weights, one scene of 10 x 518^2, bf16 trunks, f32
             heads: 1 cold + 1 warm call, each with the anyview, metric and
             host-alignment ms, peak GB and launches (K1 14, K4 50); one
             profiled call; each branch's layers alone.
   da3_service — DA3-Large written as a checkpoint and served by the port's
             ``ModelBackend`` over loopback HTTP (127.0.0.1, port 0): /reload,
             4 /infer requests of 10 x 518^2 (glb, gs_ply, a COLMAP project
             whose poses drive the Umeyama alignment, gs_video rendering 10
             views from 2.68 M gaussians), /tasks, /status, /memory; per
             request latency, inference and export ms, launches (K1 8, K4
             16), peak GB and artefact size. Images decode from memory and
             the video writer keeps its frames (no OpenCV, PIL or mp4 encoder
             on the card's machine).
   slice_matching — SuperPoint (2,048 keypoints, 256-d) and LightGlue (9
             layers, d 256, 4 heads) at the published widths on random
             JAX-layout trees through the bridge (SuperPoint He-scaled: at
             the published init its scores tie across cells), one pair of
             518^2 frames,
             f32 card against CPU: scores and descriptors by rel-norm, how
             many keypoints differ (a blocky and a textured pair), LightGlue's
             log-assignment by rel-norm, matches0's agreement; the matching
             trees (``matcher_trees``) on a pair panned 8 pixels: matches and
             Epipolar card against CPU; card ms of each stage.
   replicate_files, lightglue — the same scorer run again with
             ``SCORE_DESCRIPTOR_TYPE=lightglue`` (the matcher's trees from
             ``VIDEOGPA_SUPERPOINT_PATH`` / ``VIDEOGPA_LIGHTGLUE_PATH``):
             clips/min, the matcher's ms a pair by stage, matches a pair, the
             Epipolar values, K1/K4/K5 launches.
   da3_eval — ``Evaluator`` in its three modes (pose, recon_posed,
             recon_unposed) on one ``npz_dir`` scene of 10 x 518^2 with
             DA3-Large at full width: inference, fusion and chamfer ms,
             voxels and voxel size, surface points, metrics, peak GB, K1 8 /
             K4 16 a call; ``fuse_depths_tsdf`` card against CPU on a bumpy
             scene of 10 x 518^2 at about 8 M voxels.
   ring_shards — the ring attention's own per-shard functions
             (``ops.ring_attention``: ``_pair_forward``, ``_merge``,
             ``_pair_backward``) rotated over P query shards in one process
             at full width: the CogVideoX-5B train shape (1, 17,776, 48, 64)
             at P = 4 and P = 3 (17,778 padded, the last shard 5,924 valid)
             through K1/K3, Wan2.2's self-attention (1, 18,480, 24, 128) at
             P = 4 through K6/K7; O and LSE against one whole-sequence
             forward, dQ/dK/dV against one whole backward, at the parity
             tolerances; exactly P^2 launches of each (fewer the empty
             pairs); the summed per-pair kernel ms against the whole call's.
   ring_nccl — a world-size-1 ``nccl`` process group over a FileStore:
             ``attention(impl="ring")`` under a mesh with seq = 1 at the
             train shape against ``impl="flash"`` (O and dK/dV bit for bit),
             and one CogVideoX-5B DPO mini-step at full width and 4 layers
             under a mesh with data = 1 (the data-parallel path) against the
             plain step; the profiler shows the NCCL all-reduces. NCCL
             between ranks needs more than one card and is not run here.
   slice_track — f32 on the card against the CPU on damped trackers (flow
             heads and feature updaters x 0.02: random weights make the
             refinement chaotic): the tiny VGGT with a reduced track head
             through ``vggt_forward(query_points=)``, and the VGGSfM tracker
             at its published widths with fine tracking on 2 frames of
             192^2; tracks, vis and conf by max |d|, every track at its
             query at frame 0.
   vggt_track — ``predict_tracks`` at full width on one clip of 10 x 518^2
             with random weights: VGGT-1B with its published track head (256
             queries x 2 query frames, 4 iterations), then the published
             VGGSfM tracker (6 coarse iterations, fine tracking at pradius
             15); a cold and a warm run of each, wall ms split into trunk,
             other heads, track head or tracker, and host, peak GB; shapes,
             finiteness, vis/conf in [0, 1], each track at its query at its
             query frame, and K1 24, K4 48, K6 f32 16 launches a forward.
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
             ``flash_attn_fwd_wide`` at (1, 4,096, 16, 256) in f32 (CUDA
             cores) and bf16 (wgmma + TMA) and ``flash_attn_int8_f32`` at
             the f32 scorer's global rows,
             each against its plain version, beside its bound and SDPA; K4
             at DA3-Large's frame rows (40, 1,370, 16, 64), K1 and K8 at its
             global rows (4, 13,700, 16, 64); K1 at DA3-Giant's global rows
             (1, 13,700, 24, 64) and K4 at its frame rows (10, 1,370, 24,
             64), each also against its plain version.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is present.

    python3 chip_smoke.py --ranks 4 [--phases ranks_nccl,ranks_ring,...]

runs the multi-card path on four cards over NCCL instead (``ranks_main``):
the kernels built once, then four ranks started with ``torch.multiprocessing``
(spawn), each on its own card in one ``nccl`` group over a FileStore with a
timeout, every rank making every mesh of ``ranks_plan`` (data 4, seq 4, model
4, dp 2 x tp 2, the sub-meshes of ranks 0-1 and 2-3). Phases, each against
the one-card computation of the same thing on the same card, with per-rank
launch counts (``ranks_launches``):

   ranks_nccl — all_reduce, all_gather_into_tensor and a batch_isend_irecv
             ring on every axis of every mesh against closed forms; the NCCL
             version and transports; one 256 MiB all-reduce's bus bandwidth.
   ranks_ring — ``attention(impl="ring")`` over seq 4 at (1, 17,776, 48, 64)
             and the ragged (1, 41,026, 48, 64), forward and autograd, the
             ring's shard O and LSE, and the rotations' NCCL time beside the
             pairs' kernels.
   ranks_train — the CogVideoX-5B DPO step at dp 2 x tp 2, global batch 2,
             full width and depth; each rank's peak against ``train.memory``'s
             reckoning of rank_mesh(2, 2) (a process beside, as [train]'s).
   ranks_seq_train — the same step with ``attn_impl="ring"`` over seq 4.
   ranks_wan_train — the Wan2.2-TI2V-5B DPO step at tp 4 (K6/K7).
   ranks_overlap — the CogVideoX-5B sampler (one CFG-pair DPM step) at tp 2 on
             ranks 0-1 beside the VGGT-1B forward (4 clips x 10 x 518^2) at
             dp 2 on ranks 2-3; each half alone and both at once.
   ranks_cog15_train — the CogVideoX1.5-5B DPO step at tp 4, 41,026 tokens,
             its peak against the reckoning of rank_mesh(1, 4).

It needs four visible cards and never falls back to fewer, to ``gloo`` or to
the CPU; a rank that raises fails the run, and the parent kills the ranks past
``RANKS_WALL_S``. Its last line has the form above with the count of cards it
used; ``build/chip_smoke_ranks.log`` keeps every line.
"""

from __future__ import annotations

import atexit
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


_T0 = time.perf_counter()


def mark(phase: str) -> None:
    """Log the seconds since the script started, after a phase."""
    log(f"[phase] {phase} done at {time.perf_counter() - _T0:.1f} s")


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    raise SystemExit(1)


# every line also goes to build/chip_smoke.log beside this script (the
# directory the kernels are built into, which .gitignore lists): a caller that
# keeps only the end of the output still finds the whole run there
_LOG_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke.log")


def log(msg: str) -> None:
    """``msg`` on stdout as it is, and in the log file after the seconds
    since the script started (which phase costs what)."""
    print(msg, flush=True)
    os.makedirs(os.path.dirname(_LOG_PATH), exist_ok=True)
    with open(_LOG_PATH, "a") as f:
        f.write(f"{time.perf_counter() - _T0:7.1f} {msg}\n")


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


def phase_parity(dit_shape, vggt_global_shape, da3_global_shape, track_global_shape=None):
    """K1 vs its plain version; returns (max O error, plain ms at the DiT
    shape, {"max_abs_err", "plain_ms"} at the DA3 global shape).
    ``track_global_shape``: VGGT's global rows as [vggt_track] gives them
    (one clip, batch 1), checked too."""
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

    # the main paths' shapes at full size: the DiT's, and the VGGT and DA3
    # global blocks' (13,740 and 13,700 keys: other ragged last tiles and B*H
    # grids), there with v a strided view of one packed qkv tensor
    B, N, H, D = dit_shape
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    worst, plain_ms = _parity_full(f"DiT shape {dit_shape}", q, k, v)
    errs.append(worst)
    del q, k, v
    for label, shape in (("VGGT global", vggt_global_shape),
                         ("VGGT tracking global", track_global_shape)):
        if shape is None:
            continue
        B, N, H, D = shape
        q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
            torch.bfloat16).unbind(2)
        worst, _ = _parity_full(f"{label} shape {shape} (v a strided view)",
                                q.contiguous(), k.contiguous(), v)
        errs.append(worst)
        del q, k, v
    B, N, H, D = da3_global_shape
    q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    da3_err, da3_plain_ms = _parity_full(
        f"DA3 global shape {da3_global_shape} (v a strided view)", q.contiguous(),
        k.contiguous(), v)
    errs.append(da3_err)
    del q, k, v
    torch.cuda.empty_cache()
    return max(errs), plain_ms, {"max_abs_err": da3_err, "plain_ms": da3_plain_ms}


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


def _ring_case(label, q, k, v, P, gen):
    """One [ring_shards] case: the ring's own per-shard functions rotated over
    P query shards in one process, against one whole-sequence call of the
    forward and backward kernels ``attention()`` picks. Returns the case's
    numbers; fails on a disagreement or a pair that took a plain version."""
    import torch

    from videogpa_torch.ops import ring_attention as ring
    from videogpa_torch.ops.attention import _FlashAttention

    fwd, bwd = _FlashAttention._pair(q)
    B, N, H, D = q.shape
    N_pad = -(-N // P) * P
    L = N_pad // P
    validity = ring._shard_validity(N, L) if N_pad != N else None

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, N_pad - N)) if N_pad != N else x

    qp, kp, vp = pad(q), pad(k), pad(v)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    dop = pad(do)

    def shard(x, r):
        return x[:, r * L:(r + 1) * L]

    def event():
        return torch.cuda.Event(enable_timing=True)

    def run():
        """Every rank's forward ring, then its backward ring, each pair
        between CUDA events: (outs, lses, f32 grads, per-pair ms, empty)."""
        pairs, empty, outs, lses = [], 0, [], []
        for r in range(P):  # rank r's query shard: its forward ring
            o = lse = None
            for i in range(P):
                s = ring._resident_shard(r, i, P)
                n_keys = ring._resident_keys(s, L, validity)
                empty += n_keys == 0
                e0, e1 = event(), event()
                e0.record()
                o_i, lse_i = ring._pair_forward(shard(qp, r), shard(kp, s), shard(vp, s), None,
                                                n_keys, "bnhd", None)
                e1.record()
                pairs.append((e0, e1, "fwd"))
                o, lse = (o_i, lse_i) if o is None else ring._merge(o, lse, o_i, lse_i, "bnhd")
            outs.append(o)
            lses.append(lse)
        grads = [torch.zeros(qp.shape, dtype=torch.float32, device="cuda") for _ in range(3)]
        for r in range(P):  # its backward ring: dK/dV of each resident shard
            for i in range(P):
                s = ring._resident_shard(r, i, P)
                n_keys = ring._resident_keys(s, L, validity)
                e0, e1 = event(), event()
                e0.record()
                g = ring._pair_backward(shard(qp, r), shard(kp, s), shard(vp, s), None,
                                        outs[r], lses[r], shard(dop, r), n_keys, "bnhd", None)
                e1.record()
                pairs.append((e0, e1, "bwd"))
                if g is not None:
                    shard(grads[0], r).add_(g[0].float())
                    shard(grads[1], s)[:, :n_keys].add_(g[1].float())
                    shard(grads[2], s)[:, :n_keys].add_(g[2].float())
        torch.cuda.synchronize()
        ms = {"fwd": 0.0, "bwd": 0.0}
        for e0, e1, kind in pairs:
            ms[kind] += e0.elapsed_time(e1)
        return outs, lses, grads, ms, empty

    fwd0, bwd0 = fwd.launches, bwd.launches
    outs, lses, (dq, dk, dv), _, empty = run()  # checked and counted
    launched = (fwd.launches - fwd0, bwd.launches - bwd0)
    want_launches = (P * P - empty, P * P - empty)
    pair_ms = run()[3]  # timed: the first run pays module loads and first allocations
    o_ring = torch.cat(outs, dim=1)[:, :N]
    lse_ring = torch.cat(lses, dim=2)[:, :, :N]
    grads_ring = [g[:, :N].to(torch.bfloat16) for g in (dq, dk, dv)]

    # the whole sequence: one forward with LSE, one backward (not counted)
    o_ref, lse_ref = fwd(q, k, v, layout="bnhd", with_lse=True)
    grads_ref = bwd(q, k, v, o_ref, lse_ref, do, layout="bnhd")
    whole_fwd_ms = cuda_ms(lambda: fwd(q, k, v, layout="bnhd", with_lse=True), 5)
    whole_bwd_ms = cuda_ms(lambda: bwd(q, k, v, o_ref, lse_ref, do, layout="bnhd"), 3)
    o_err, o_atol, lse_err, ok = _check(o_ring, lse_ring, o_ref, lse_ref)
    g_errs = []
    for name, g, w in zip(("dQ", "dK", "dV"), grads_ring, grads_ref):
        err, atol, g_ok = _grad_check(g, w)
        g_errs.append(err)
        ok = ok and g_ok
    log(f"[ring_shards] {label}: P = {P}, shards of {L} (valid keys "
        f"{[ring._resident_keys(s, L, validity) for s in range(P)]}), {fwd.__name__} "
        f"{launched[0]} and {bwd.__name__} {launched[1]} launches (want {want_launches[0]} "
        f"each, {empty} empty pairs); max|dO| {o_err:.3e} (atol {o_atol:.2e} + rtol {O_RTOL}), "
        f"max|dLSE| {lse_err:.3e}, max|dQ|,|dK|,|dV| {[f'{e:.3e}' for e in g_errs]}; summed "
        f"per-pair kernel ms fwd {pair_ms['fwd']:.3f} vs whole {whole_fwd_ms:.3f} "
        f"({pair_ms['fwd'] / whole_fwd_ms:.3f}x), bwd {pair_ms['bwd']:.3f} vs whole "
        f"{whole_bwd_ms:.3f} ({pair_ms['bwd'] / whole_bwd_ms:.3f}x)")
    if launched != want_launches:
        fail(f"[ring_shards] {label}: a pair did not launch its kernel (or launched twice)")
    if not ok:
        fail(f"[ring_shards] {label}: the ring disagrees with the whole-sequence kernels")
    return {"P": P, "shard": L, "launches": {fwd.__name__: launched[0], bwd.__name__: launched[1]},
            "max_abs_err_o": o_err,
            "max_abs_err_grads": g_errs, "pairs_fwd_ms": pair_ms["fwd"],
            "whole_fwd_ms": whole_fwd_ms, "pairs_bwd_ms": pair_ms["bwd"],
            "whole_bwd_ms": whole_bwd_ms}


def phase_ring_shards(train_shape, wan_shape):
    """[ring_shards]: the ring's per-shard functions at full width in one
    process (P query shards, each against every resident key shard), for
    the CogVideoX-5B train shape at P = 4 and 3 (ragged) and Wan2.2's self
    attention at P = 4. Returns {"cases", "launches"}: the pairs' launches
    per kernel (not the whole-sequence references')."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(41)
    cases, launches = {}, dict.fromkeys(_wrappers(), 0)
    for label, shape, P in (("CogVideoX-5B", train_shape, 4), ("CogVideoX-5B", train_shape, 3),
                            ("Wan2.2 self", wan_shape, 4)):
        B, N, H, D = shape
        q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
        res = _ring_case(f"{label} {shape} P={P}", q, k, v, P, gen)
        cases[f"{label} P={P}"] = res
        for name, n in res["launches"].items():
            launches[name] += n
        del q, k, v
        torch.cuda.empty_cache()
    return {"cases": cases, "launches": launches}


def phase_ring_nccl(train_shape):
    """[ring_nccl]: a world-size-1 ``nccl`` process group over a FileStore:
    ``attention(impl="ring")`` under a mesh with ``seq`` = 1 at the DiT
    train shape against ``impl="flash"`` (forward and autograd), and one
    CogVideoX-5B DPO mini-step at full width, 4 layers, under a mesh with
    ``data`` = 1 (the data-parallel path: its all-reduces on NCCL) against
    the plain step. Returns the numbers and the step's launches."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
    from videogpa_torch.ops.attention import attention, flash_attn_bwd, flash_attn_fwd
    from videogpa_torch.parallel import MeshAxes, make_mesh, set_mesh
    from videogpa_torch.train.lora import lora_init
    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)

    store_dir = tempfile.mkdtemp(prefix="videogpa_nccl_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store_dir}/store", rank=0,
                            world_size=1)
    try:
        init_s = time.perf_counter() - t0
        log(f"[ring_nccl] process group: backend {dist.get_backend()}, world size "
            f"{dist.get_world_size()}, NCCL {torch.cuda.nccl.version()}, "
            f"init {init_s:.2f} s")
        gen = torch.Generator(device="cuda").manual_seed(43)
        B, N, H, D = train_shape
        q, k, v = (x.requires_grad_(True) for x in _attn_case(gen, B, N, N, H, D, "bnhd"))
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        f0, b0 = flash_attn_fwd.launches, flash_attn_bwd.launches
        with set_mesh(make_mesh(MeshAxes(seq=1))):
            o_ring = attention(q, k, v, impl="ring", layout="bnhd")
        g_ring = torch.autograd.grad(o_ring, (q, k, v), do)
        ring_launches = (flash_attn_fwd.launches - f0, flash_attn_bwd.launches - b0)
        o_flash = attention(q, k, v, impl="flash", layout="bnhd")
        g_flash = torch.autograd.grad(o_flash, (q, k, v), do)
        o_equal = torch.equal(o_ring, o_flash)
        kv_equal = all(torch.equal(a, b) for a, b in zip(g_ring[1:], g_flash[1:]))
        dq_err, dq_atol, dq_ok = _grad_check(g_ring[0], g_flash[0])
        log(f"[ring_nccl] attention(impl='ring') under seq = 1 at {train_shape} vs "
            f"impl='flash': O bit-equal {o_equal}, dK/dV bit-equal {kv_equal}, dQ max|d| "
            f"{dq_err:.3e} (atol {dq_atol:.2e} + rtol {GRAD_RTOL}: K3's reduce-adds); ring "
            f"launches K1 {ring_launches[0]}, K3 {ring_launches[1]}")
        if not (o_equal and kv_equal and dq_ok and ring_launches == (1, 1)):
            fail("[ring_nccl] attention(impl='ring') at seq = 1 disagrees with impl='flash'")
        del q, k, v, do, o_ring, o_flash, g_ring, g_flash

        cfg = dataclasses.replace(CogVideoXConfig.cogvideox_5b(), num_layers=4)
        dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                       dtype=torch.bfloat16).requires_grad_(False)
        tcfg = TrainerConfig(learning_rate=1e-4, warmup_steps=0, max_steps=10, lora_rank=64,
                             lora_alpha=128.0, remat=True)
        shape = (1, cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height,
                 cfg.sample_width)
        g = torch.Generator(device="cuda").manual_seed(44)
        batch = {"x_win": torch.randn(shape, generator=g, device="cuda"),
                 "x_lose": torch.randn(shape, generator=g, device="cuda"),
                 "prompt_emb": torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim,
                                           generator=g, device="cuda")}
        draws = {"timesteps": torch.tensor([600], device="cuda"),
                 "noise": torch.randn((1, cfg.sample_frames, cfg.vae_latent_channels,
                                       cfg.sample_height, cfg.sample_width), generator=g,
                                      device="cuda")}
        lora = lora_init(cfg.num_layers, cfg.hidden_dim, tcfg.lora_rank,
                         torch.Generator(device="cuda").manual_seed(45), device="cuda")
        with torch.no_grad():
            for ab in lora.values():
                ab["lora_B"].normal_(0.0, 0.01, generator=g)  # every adapter live
        step, _ = make_dpo_train_step(dit, cfg, tcfg)

        def fresh():
            return init_train_state({n: {k: t.detach().clone() for k, t in ab.items()}
                                     for n, ab in lora.items()}, tcfg)

        plain_state, plain_m = step(fresh(), batch, **draws)
        mesh = make_mesh(MeshAxes(data=1))
        state = fresh()
        zero_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            with set_mesh(mesh):
                state, m = step(state, batch, **draws)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t1)
        launches = read_launches()
        nccl_events = sorted({e.key for e in prof.key_averages()
                              if "nccl" in e.key.lower() and "reduce" in e.key.lower()})
        upd = max((a.detach() - b.detach()).abs().max().item()
                  for n in lora for a, b in zip(state.lora[n].values(),
                                                plain_state.lora[n].values()))
        moved = max((a.detach() - b.detach()).abs().max().item()
                    for n in lora for a, b in zip(state.lora[n].values(), lora[n].values()))
        m, plain_m = ({k: float(x) for k, x in mm.items()} for mm in (m, plain_m))
        gn_rel = abs(m["grad_norm"] - plain_m["grad_norm"]) / plain_m["grad_norm"]
        L = cfg.num_layers
        want = dict.fromkeys(launches, 0)
        want.update(flash_attn_fwd=6 * L, flash_attn_bwd=2 * L)
        log(f"[ring_nccl] CogVideoX-5B DPO mini-step, full width, {L} layers, under data = 1 "
            f"(NCCL) vs the plain step: loss {m['loss']:.6f} vs {plain_m['loss']:.6f} "
            f"(bit-equal {m['loss'] == plain_m['loss']}, limit 1e-6 relative), grad_norm "
            f"{m['grad_norm']:.6e} vs "
            f"{plain_m['grad_norm']:.6e} (rel {gn_rel:.2e}), LoRA after the update max|d| "
            f"{upd:.3e} (limit 2.5 x lr = {2.5 * tcfg.learning_rate:.1e}; the update moved it "
            f"{moved:.3e}); {step_ms:.1f} ms (profiled); NCCL reduce events {nccl_events}; "
            f"launches {json.dumps(launches)}")
        if not nccl_events:
            fail("[ring_nccl] the data-parallel step launched no NCCL all-reduce")
        if launches != want:
            fail("[ring_nccl] the data-parallel step did not run its attentions through K1/K3")
        loss_ok = abs(m["loss"] - plain_m["loss"]) <= 1e-6 * abs(plain_m["loss"])
        if not (loss_ok and gn_rel <= 1e-2
                and upd <= 2.5 * tcfg.learning_rate and moved > 0.5 * tcfg.learning_rate):
            fail("[ring_nccl] the data-parallel step disagrees with the plain step")
        del dit, lora, state, plain_state
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "init_s": init_s,
            "nccl_events": nccl_events, "lora_max_abs_diff": upd, "grad_norm_rel": gn_rel,
            "dq_max_abs_err": dq_err}


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


# a reckoned peak (``train.memory``: the step traced under FakeTensorMode)
# against the card's max_memory_allocated for the same step: the reckoning
# leaves out cuBLAS's workspaces and the allocator's unsplit block tails
RECKON_REL = 0.15
RECKON_TIMEOUT_S = 600
# segments 5-7 of the JAX package's multichip dry run: (model, dp, tp,
# global batch) of rank 0's step
TRAIN_MEMORY_LAYOUTS = (("cogvideox", 2, 4, 2), ("wan", 2, 4, 2), ("cog15", 1, 8, 1))


def _memory_tcfg(recipe_name: str):
    """The trainer settings of a recipe that the step's memory depends on
    (accumulation, LoRA rank and alpha, remat; bf16, the flash kernels)."""
    from videogpa_torch.train.recipes import default_config
    from videogpa_torch.train.trainer import TrainerConfig

    r = default_config(recipe_name)
    return TrainerConfig(accumulate_grad_batches=r.get("accumulate_grad_batches", 1),
                         lora_rank=r["lora_rank"], lora_alpha=r["lora_alpha"], remat=True)


def _memory_fn(model: str):
    """The ``train.memory`` function of a model, as its command line names it."""
    from videogpa_torch.train.memory import parse_args

    return parse_args([model])[0]


def reckon_main(path: str) -> None:
    """``python3 chip_smoke.py --reckon PATH``: the reckonings of
    [cog15_train]'s, [train]'s and [wan-train]'s steps (one card, batch 1,
    their recipes) and of rank 0 of each ``TRAIN_MEMORY_LAYOUTS`` step under
    the fake process group, in that order, PATH (JSON) rewritten after each.
    CPU work only: no kernel launches, at a lower priority and on one thread:
    the card's phases beside it keep the host's cores."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.train import memory as M

    os.nice(10)
    torch.set_num_threads(1)

    steps = [("cog15_train", lambda: M.aot_train_memory(
                 CogVideoXConfig.cogvideox_1_5_5b(), _memory_tcfg("CogVideoX1.5-5B"),
                 mesh=M.ONE_DEVICE, batch_size=1)),
             ("train", lambda: M.aot_train_memory(
                 CogVideoXConfig.cogvideox_5b(), _memory_tcfg("CogVideoX-5B"),
                 mesh=M.ONE_DEVICE, batch_size=1)),
             ("wan_train", lambda: M.aot_wan_train_memory(
                 mesh=M.ONE_DEVICE, batch_size=1, latent_fhw=WAN_LATENT[1:],
                 tcfg=_memory_tcfg("Wan2.2-TI2V-5B")))]
    steps += [(model, lambda m=model, dp=dp, tp=tp, b=batch: _memory_fn(m)(
        mesh=M.rank_mesh(dp, tp), batch_size=b)) for model, dp, tp, batch in TRAIN_MEMORY_LAYOUTS]
    out = {}
    for name, reckon in steps:
        out[name] = reckon()
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)


def measure_layout_main(model: str, dp: str, tp: str, batch: str) -> None:
    """``python3 chip_smoke.py --measure-layout MODEL DP TP BATCH``: rank 0's
    step of that layout run for real on the card under the fake process
    group (``train.memory``, ``measure=True``), printed as one JSON line with
    every kernel's launches in it."""
    from videogpa_torch.train import memory as M

    zero_launches()
    out = _memory_fn(model)(mesh=M.rank_mesh(int(dp), int(tp)), batch_size=int(batch),
                            measure=True, reckon=False)
    out["launches"] = read_launches()
    print("RESULT " + json.dumps(out), flush=True)


class Reckonings:
    """``reckon_main``'s figures, made by a process of its own started beside
    the parity phases (its fake process group and its CPU time stay out of
    this one); ``get`` waits for the figure asked for, ``stop`` ends the
    process if it still runs."""

    def __init__(self, mode: str = "--reckon", *args: str):
        root = os.path.dirname(os.path.abspath(__file__))
        stem = "reckonings" + mode[len("--reckon"):].replace("-", "_")
        self.path = os.path.join(root, "build", stem + ".json")
        self.log_path = os.path.join(root, "build", stem + ".log")
        if os.path.exists(self.path):
            os.remove(self.path)
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, self.path, *args],
                stdout=out, stderr=subprocess.STDOUT, cwd=root)
        self._data = {}

    def get(self, name: str) -> dict:
        while name not in self._data:
            rc = self.proc.poll()
            if os.path.exists(self.path):
                with open(self.path) as f:
                    self._data = json.load(f)
            if name in self._data:
                break
            if rc is not None or time.perf_counter() - self.t0 > RECKON_TIMEOUT_S:
                with open(self.log_path) as f:
                    fail(f"no reckoning of {name} (rc {rc}): {f.read()[-3000:]}")
            time.sleep(1.0)
        log(f"[reckon] {name}: train.memory's reckoning (FakeTensorMode, the fake process "
            f"group), {len(self._data)} of them ready {time.perf_counter() - self.t0:.1f} s "
            "after they started in a process beside the card's phases")
        return self._data[name]

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def check_reckoning(tag: str, reckoned: dict, measured: int) -> dict:
    """Log a step's reckoned peak beside its measured ``max_memory_allocated``
    (bytes) and fail beyond ``RECKON_REL``."""
    ratio = reckoned["per_device_hbm_bytes"] / measured
    log(f"{tag} reckoned peak {reckoned['per_device_hbm_gib']:.3f} GiB (arguments "
        f"{reckoned['argument_gib']:.3f} + temps {reckoned['temp_gib']:.3f} + outputs "
        f"{reckoned['output_gib']:.3f}; at the peak by category "
        f"{json.dumps(reckoned['peak_by_category_gib'])}; remat residual "
        f"{reckoned['residual_gib']:.3f} GiB) against max_memory_allocated "
        f"{measured / 2 ** 30:.3f} GiB ({measured / 1e9:.2f} GB): reckoned / measured "
        f"{ratio:.4f} (limit 1 +- {RECKON_REL})")
    if abs(ratio - 1) > RECKON_REL:
        fail(f"{tag}: the reckoned peak is {ratio:.3f} of the measured one")
    return {"reckoned_gib": reckoned["per_device_hbm_gib"], "measured_gib": measured / 2 ** 30,
            "ratio": ratio, "residual_gib": reckoned["residual_gib"],
            "block_residual_bytes": reckoned["block_residual_bytes"],
            "tokens": reckoned["tokens"]}


def check_update(tag: str, state, b_norms, updates: int, accumulate: int = 2) -> None:
    """The optimiser made ``updates`` updates from gradients off zero; the
    LoRA B tensors (``b_norms``: one a call, ``accumulate`` calls an update)
    stayed zero through the first update (lr schedule(0) = 0) and left it in
    a later one, where the run has one."""
    moved = any(float(m.abs().max()) > 0 for m in state.opt_state["mu"])
    ok = state.opt_state["count"] == updates and moved and b_norms[accumulate - 1] == 0.0
    if updates > 1:
        ok = ok and b_norms[-1] > 0.0
    if not ok:
        fail(f"{tag}: expected {updates} update(s) with first moments off zero, LoRA B zero "
             f"after update 1 and off zero after a later one; got count "
             f"{state.opt_state['count']}, moments off zero {moved}, LoRA B {b_norms}")


def _block_residual(model: str, tp: int, batch: int) -> int:
    """The bytes one checkpointed block keeps under sequence sharding at
    ``tp``: each residual stream's ceil(n / tp) rows x the width in bf16 for
    each of ``batch`` rows, in whole 512-byte blocks."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.wan import WanConfig

    if model == "wan":
        cfg = WanConfig.ti2v_5b()
        width = cfg.dim
        streams = [math.prod(n // p for n, p in zip(WAN_LATENT[1:], cfg.patch_size))]
    else:
        cfg = (CogVideoXConfig.cogvideox_1_5_5b() if model == "cog15"
               else CogVideoXConfig.cogvideox_5b_i2v())
        pt = cfg.patch_size_t or 1
        video = ((cfg.sample_frames - cfg.sample_frames % pt) // pt
                 * (cfg.sample_height // cfg.patch_size) * (cfg.sample_width // cfg.patch_size))
        streams, width = [video, cfg.max_text_seq_length], cfg.hidden_dim
    return sum(-(-batch * -(-n // tp) * width * 2 // 512) * 512 for n in streams)


def phase_train_memory(reckonings, train_residual: dict) -> dict:
    """Segments 5-7 of the JAX package's dry run on the card: rank 0's DPO
    step of CogVideoX-5B-I2V and of Wan2.2-TI2V-5B at dp 2 x tp 4 (global
    batch 2) and of CogVideoX1.5-5B at dp 1 x tp 8 (batch 1), each in a
    process of its own (a process starts one default group, and [ring_nccl]
    started this one's), the three at once: the measured peak against the
    reckoned one and the card's memory, the kernels' launches, and the
    remat residual a rank keeps (1/tp of the sequence) beside the tp = 1
    figure of [train] / [wan-train]."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.wan import WanConfig

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {model: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--measure-layout", model, str(dp), str(tp),
         str(batch)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root)
        for model, dp, tp, batch in TRAIN_MEMORY_LAYOUTS}
    outs = {}
    for model, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=RECKON_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rows = [line for line in text.splitlines() if line.startswith("RESULT ")]
        if proc.returncode != 0 or not rows:
            fail(f"[train_memory] {model}: rc {proc.returncode}: {text[-3000:]}")
        outs[model] = json.loads(rows[-1][len("RESULT "):])
    wall_s = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    launches = dict.fromkeys(read_launches(), 0)
    layouts = {}
    for model, dp, tp, batch in TRAIN_MEMORY_LAYOUTS:
        m, r = outs[model], reckonings.get(model)
        tag = f"[train_memory] {model} rank 0 of dp {dp} x tp {tp}, global batch {batch}"
        if model == "wan":
            L = WanConfig.ti2v_5b().num_layers
            want = {"flash_attn_fwd_d128": 6 * 2 * L, "flash_attn_bwd_d128": 2 * 2 * L}
        else:
            L = CogVideoXConfig.cogvideox_5b_i2v().num_layers
            want = {"flash_attn_fwd": 6 * L, "flash_attn_bwd": 2 * L}
        want = {**dict.fromkeys(m["launches"], 0), **want}
        res = check_reckoning(f"{tag}, {m['tokens']} tokens:", r, m["measured_peak_bytes"])
        block = _block_residual(model, tp, batch // dp)
        src = "wan-train" if model == "wan" else "train"
        tp1 = train_residual[src.replace("-", "_")]
        log(f"{tag}: measured peak {m['measured_peak_gib']:.3f} GiB of the card's "
            f"{total / 2 ** 30:.2f} GiB; launches {json.dumps(m['launches'])}, expected "
            f"{json.dumps(want)} (6 forwards and 2 backwards of {L} layers"
            f"{' x 2 attentions' if model == 'wan' else ''}); remat residual a rank "
            f"{r['residual_gib']:.3f} GiB, {r['block_residual_bytes']:,} B a block (1/tp "
            f"layout: {block:,} B), beside [{src}]'s one card: {tp1['residual_gib']:.3f} GiB, "
            f"{tp1['block_residual_bytes']:,} B a block at {tp1['tokens']:,} tokens")
        if m["measured_peak_bytes"] >= total:
            fail(f"{tag}: the step does not fit the card")
        if m["launches"] != want:
            fail(f"{tag}: the step did not run every attention through its kernels")
        if r["block_residual_bytes"] != block:
            fail(f"{tag}: a block keeps {r['block_residual_bytes']} B, not the 1/tp "
                 f"layout's {block}")
        for k, n in m["launches"].items():
            launches[k] += n
        layouts[model] = {**res, "mesh": m["mesh"], "tokens": m["tokens"],
                          "measured_launches": m["launches"]}
    log(f"[train_memory] the three layouts measured at once in {wall_s:.1f} s")
    return {"layouts": layouts, "launches": launches, "wall_s": wall_s}


def phase_train(reckonings, mini_steps: int = 2):
    """The CogVideoX-5B DPO LoRA train step at full width and depth, its peak
    against the reckoning of the same step (``train.memory``)."""
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
        batches = [collate([ds[i % len(ds)]]) for i in range(mini_steps)]
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
            (state, metrics), ms, prof = _timed_step(
                lambda: train_step(state, batches[i], generator=gen),
                "one train mini-step (the first, profiled)" if i == 0 else None)
            profile = prof if i == 0 else profile
            step_ms.append(ms)
            m = {k: float(v) for k, v in metrics.items()}
            metrics_log.append(m)
            b_norms.append(sum(float(ab["lora_B"].detach().abs().max())
                               for ab in state.lora.values()))
            log(f"[train] mini-step {i + 1}: {step_ms[-1]:.1f} ms, " + json.dumps(m)
                + f", max|LoRA B| summed over targets {b_norms[-1]:.3e}")
        launches = read_launches()
        fwd, bwd = launches["flash_attn_fwd"], launches["flash_attn_bwd"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reckoned = check_reckoning("[train]", reckonings.get("train"),
                                   torch.cuda.max_memory_allocated())
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
        check_update("[train]", state, b_norms, mini_steps // tcfg.accumulate_grad_batches)
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
    del dit, state, lora
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "update_ms": [step_ms[i] + step_ms[i + 1] for i in range(0, mini_steps - 1, 2)],
            "peak_gb": peak_gb, "reckoned": reckoned, "profile": profile,
            "metrics": metrics_log, "checkpoint_s": [save_s, restore_s]}


def _timed_step(run, profile_label=None):
    """(``run()``'s result, its ms with the card synchronised around it, the
    device time by kernel group or None): with ``profile_label`` the call
    runs under ``profile_device_time``."""
    import torch

    out = {}

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["result"] = run()
        torch.cuda.synchronize()
        out["ms"] = 1e3 * (time.perf_counter() - t0)

    profile = profile_device_time(profile_label, call) if profile_label else call()
    return out["result"], out["ms"], profile


def _fwd_bound(B, Nq, Nk, H, D):
    """(bound ms, what bounds it) of a bf16 attention forward: 4 B H Nq Nk D
    operations against q, k, v read and O written once."""
    return _bound(4.0 * B * H * Nq * Nk * D, 2.0 * B * H * D * (2 * Nq + 2 * Nk),
                  PEAK_BF16_FLOPS)


def _bwd_bound(B, N, H, D):
    """(bound ms, what bounds it) of K3 at a self-attention shape: five N x N
    x D products a head (S, dV, dP, dQ, dK) against q, k, v, O, dO read and
    dQ, dK, dV written once in bf16, LSE and delta in f32."""
    return _bound(10.0 * B * H * N * N * D, 2.0 * B * H * N * D * 8 + 4.0 * B * H * N * 2,
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
    out["bwd_bound_ms"], out["bwd_bound_by"] = _bwd_bound(B, N, H, D)
    out["bwd_tflops"] = 10.0 * B * H * N * N * D / out["bwd_ms"] / 1e9
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


def phase_parity_short(vggt_shape, da3_shape, track_shape=None):
    """K4 against its plain version in bf16; returns (max |dO|, plain ms at
    the VGGT frame-attention shape, {"max_abs_err", "plain_ms"} at DA3's).
    ``track_shape``: VGGT's frame rows as [vggt_track] gives them (one clip),
    checked too."""
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

    # the VGGT and DA3 frame-attention shapes (1,374 and 1,370 keys: other
    # ragged last tiles), q/k/v as views of one packed projection
    full = {}
    shapes = [("VGGT", vggt_shape), ("DA3", da3_shape)]
    if track_shape is not None:
        shapes.append(("VGGT tracking", track_shape))
    for label, (B, N, H, D) in shapes:
        q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
            torch.bfloat16).unbind(2)
        o = flash_attn_short(q, k, v)
        ro, plain_ms = _timed(lambda: flash_attn_short_reference(q, k, v))
        err, atol, ok = _check_o(o, ro)
        log(f"[parity] K4 {label} frame shape {(B, N, H, D)} (strided qkv views): max|dO| "
            f"{err:.3e} (atol {atol:.2e} + rtol {O_RTOL}) {'ok' if ok else 'MISMATCH'}; plain "
            f"version {plain_ms:.2f} ms")
        if not ok:
            fail(f"flash_attn_short disagrees at the {label} frame shape")
        errs.append(err)
        full[label] = {"max_abs_err": err, "plain_ms": plain_ms}
        del q, k, v, o, ro
        torch.cuda.empty_cache()
    return max(errs), full["VGGT"]["plain_ms"], full["DA3"]


def phase_parity_d128(cam_shape, wan_shape, f32_long_shapes, track_cam_shape=None):
    """K6 against its plain version: the float32 entry (camera head, at the
    scorer's batch and at [vggt_track]'s ``track_cam_shape``, every head dim
    it takes, B*H past the grid y limit and the f32 scorer's frame and
    global rows ``f32_long_shapes``) and bf16 at head_dim 128; returns
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
    if track_cam_shape is not None:
        f32_cases.append((f"f32 camera head, tracking {tuple(track_cam_shape)} bnhd", "bnhd",
                          f32(*track_cam_shape[:2], track_cam_shape[1], *track_cam_shape[2:],
                              "bnhd")))
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
    """The metric set without Epipolar where it matches with SIFT: SIFT needs
    OpenCV on the host, which the card's machine lacks (the CPU tests hold
    it). Epipolar through SuperPoint + LightGlue stays."""
    from videogpa_torch.metrics.epipolar import SIFTMatcher

    return {name: m for name, m in metrics.items()
            if not (name == "Epipolar" and isinstance(m.matcher, SIFTMatcher))}


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


def phase_wan(num_requests: int = 2, steps: int = 2):
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


def phase_wan_train(reckonings, mini_steps: int = 2):
    """The Wan2.2-TI2V-5B DPO LoRA train step at full width and depth, its
    peak against the reckoning of the same step (``train.memory``)."""
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
        batches = [collate([ds[i % len(ds)]]) for i in range(mini_steps)]
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
        (state, metrics), ms, prof = _timed_step(
            lambda: train_step(state, batches[i], generator=gen),
            "one Wan train mini-step (the first, profiled)" if i == 0 else None)
        profile = prof if i == 0 else profile
        step_ms.append(ms)
        m = {k: float(v) for k, v in metrics.items()}
        metrics_log.append(m)
        b_norms.append(sum(float(ab["lora_B"].detach().abs().max())
                           for ab in state.lora.values()))
        log(f"[wan-train] mini-step {i + 1}: {step_ms[-1]:.1f} ms, " + json.dumps(m)
            + f", max|LoRA B| summed over targets {b_norms[-1]:.3e}")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reckoned = check_reckoning("[wan-train]", reckonings.get("wan_train"),
                               torch.cuda.max_memory_allocated())
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
    check_update("[wan-train]", state, b_norms, mini_steps // tcfg.accumulate_grad_batches)
    if launches != want:
        fail("the Wan train path did not run every attention through K6 and K7")
    ev = eval_step(state, batches[0], generator=torch.Generator(device="cuda").manual_seed(3))
    if not all(math.isfinite(float(v)) for v in ev.values()):
        fail("non-finite Wan eval metrics")
    del model, state, lora
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "update_ms": [step_ms[i] + step_ms[i + 1] for i in range(0, mini_steps - 1, 2)],
            "peak_gb": peak_gb, "reckoned": reckoned, "profile": profile,
            "metrics": metrics_log}


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


def phase_wan_sample(dit, steps: int = 3, decode_latent_frames=None):
    """``sample_ti2v`` at full width and depth: umT5-XXL (f32) encodes a
    prompt and the empty negative (2 x 512 ids), the Wan VAE (f32) encodes a
    704 x 1,280 image (posterior sample), ``steps`` UniPC steps of the [wan]
    phase's Wan2.2-TI2V-5B DiT (bf16) run the CFG pair with the clean first
    frame, and the VAE decodes the (1, 48, 21, 44, 80) latents to 81 frames
    (or their ``decode_latent_frames`` leading latent frames, a temporal
    cut: 4 k - 3 frames), streaming, with the DiT, umT5 and the VAE
    resident. Returns the VAE and umT5 for [encode_files]."""
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
    if decode_latent_frames is not None:
        pipeline.wan_vae_decode = timed("wan_vae_decode", lambda vae_, lat, *a, **k: real[
            "wan_vae_decode"](vae_, lat[:, :, :decode_latent_frames], *a, **k))
    decoded = WAN_LATENT[1] if decode_latent_frames is None else decode_latent_frames
    frames = 4 * decoded - 3
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
    decode_tflop = wan_vae_tflop(cfg, False, (1, WAN_LATENT[0], decoded) + WAN_LATENT[2:])
    image_tflop = wan_vae_tflop(cfg, True, (1, 3, 1, 704, 1280))
    out = {"t5_ms": t5_ms, "image_encode_ms": 1e3 * timing["wan_vae_encode"],
           "step_ms": 1e3 * timing["wan_denoise_loop"] / steps,
           "decode_ms": 1e3 * timing["wan_vae_decode"], "total_s": total_s, "peak_gb": peak_gb,
           "decode_tflop": decode_tflop,
           "decode_tflops": decode_tflop / timing["wan_vae_decode"],
           "decode_bound_ms": 1e3 * 1e12 * decode_tflop / PEAK_F32_FLOPS,
           "image_encode_tflop": image_tflop, "decoded_latent_frames": decoded,
           "launches": launches}
    log(f"[wan_sample] sample_ti2v 81f@704x1280, {steps} UniPC steps (CFG pair, ti2v), "
        f"decode of {decoded} of {WAN_LATENT[1]} latent frames: image "
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
    if (tuple(video.shape) != (1, 3, frames, 704, 1280)
            or not bool(torch.isfinite(video).all()) or float(video.abs().max()) > 1.0):
        fail(f"sample_ti2v's video is not finite in [-1, 1] at {frames}f@704x1280")
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


def phase_parity_int8(dit_shape, vggt_global_shape, wan_shape, da3_global_shape):
    """K8 and K9 against their plain version on the same quantised operands,
    and quantise + kernel against exact f32 attention. Returns (K8 max |dO|,
    K9 max |dO|, K8 plain ms at the DiT shape, K9 plain ms at the Wan shape,
    K8's {"max_abs_err", "plain_ms"} at the DA3 global shape)."""
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
    B, N, H, D = da3_global_shape
    q, k, v = (torch.randn(B, N, 3, H, D, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16).unbind(2)
    da3_err, da3_plain_ms = _int8_full(
        "K8", f"DA3 global shape {da3_global_shape} (v a strided view)", flash_attn_int8,
        q.contiguous(), k.contiguous(), v)
    errs["K8"].append(da3_err)
    del q, k, v
    B, N, H, D = wan_shape
    q, k, v = _int8_case(gen, B, N, N, H, D, "bnhd")
    worst, k9_plain_ms = _int8_full("K9", f"Wan shape {wan_shape}", flash_attn_int8_d128,
                                    q, k, v)
    errs["K9"].append(worst)
    del q, k, v
    torch.cuda.empty_cache()
    return (max(errs["K8"]), max(errs["K9"]), k8_plain_ms, k9_plain_ms,
            {"max_abs_err": da3_err, "plain_ms": da3_plain_ms})


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


def phase_main_int8(exact_latents, num_requests: int = 1, steps: int = 2):
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


def phase_scorer_int8(exact_results, num_batches: int = 2, K: int = 4, S: int = 10):
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


def phase_wan_int8(steps: int = 2):
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
    480x720 frame, ``steps`` DPM steps, decode. Returns the I2V DiT, T5 and
    the VAE, still resident, under "models" (for [replicate_files])."""
    import dataclasses

    import torch

    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, SamplerSettings, dit_init, sample_i2v, sample_t2v, vae_decode, vae_init,
        video_to_uint8)
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

    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _TimedSampling() as timed:
        video = sample_t2v(dit, vae, emb[:1], emb[1:], cfg, num_frames=49, height=480,
                           width=720, settings=settings,
                           generator=torch.Generator(device="cuda").manual_seed(47))
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    timing = timed.timing
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
    del dit, emb, video
    torch.cuda.empty_cache()
    probe = probe_int32_limits()

    # I2V at full width; the T2V DiT is freed, T5 stays resident for
    # [replicate_files], as a generator holds it
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
    # T5 stays resident through sample_i2v, which does not use it: the peak
    # less T5's weights is the figure comparable with runs that freed it
    t5_gb = sum(t.numel() * t.element_size() for t in t5.state_dict().values()) / 1e9
    want = dict.fromkeys(i2v_launches, 0)
    want["flash_attn_fwd"] = steps * icfg.num_layers
    log(f"[sample] sample_i2v 49f@480x720 (VAE encode of one 480x720 frame, {steps} DPM "
        f"steps, decode): {i2v_s:.3f} s, video {tuple(ivideo.shape)}, peak {i2v_peak:.2f} GB "
        f"({i2v_peak - t5_gb:.2f} GB without T5's resident {t5_gb:.2f} GB); "
        f"launches {json.dumps(i2v_launches)}")
    if (tuple(ivideo.shape) != (1, 3, 49, 480, 720) or not bool(torch.isfinite(ivideo).all())
            or float(ivideo.abs().max()) > 1.0):
        fail("sample_i2v's video is not finite in [-1, 1] at 49f@480x720")
    if i2v_launches != want:
        fail(f"the I2V path's launches {i2v_launches} are not K1's alone")
    del ivideo
    torch.cuda.empty_cache()
    return {"launches": launches, "i2v_launches": i2v_launches, "t5_ms": t5_ms,
            "models": {"cfg": icfg, "dit": idit, "vae": vae, "t5": t5, "t5_cfg": t5_cfg},
            "decode_conv_tflop": conv_tflop,
            "step_ms": step_ms, "denoise_s": timing["denoise_s"],
            "decode_ms": 1e3 * timing["decode_s"], "tile": tile, "total_s": total_s,
            "peak_gb": peak_gb, "i2v_s": i2v_s, "i2v_peak_gb": i2v_peak,
            "i2v_peak_gb_without_t5": i2v_peak - t5_gb,
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
    """One case of a bit-stable backward (``flash_attn_bwd_f32``, or
    ``flash_attn_bwd_wide``: the CUDA-core kernel in f32, the two wgmma
    kernels in bf16): the forward ``fwd`` with LSE, the backward twice
    (bit-equal), O and each gradient against the plain versions over chunks
    of heads (f32 tolerances for f32 operands, bf16 ones for bf16). With
    ``iters``, also times the kernel, and SDPA's backward in the same dtype.
    Returns a dict of the case."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import flash_attn_bwd_reference, flash_attn_fwd_reference

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
    plain_ms, worst, atols, o_err = 0.0, [0.0, 0.0, 0.0], [], 0.0
    for h in range(0, H, chunk):
        hs = slice(h, h + chunk)
        sl = (slice(None), slice(None), hs) if layout == "bnhd" else (slice(None), hs)
        ro = flash_attn_fwd_reference(q[sl], k[sl], v[sl], layout)[0]
        if q.dtype == torch.float32:
            d = (o[sl] - ro).abs()
            err, ok = d.max().item(), bool((d <= F32_O_ATOL + F32_O_RTOL * ro.abs()).all())
        else:
            err, _, ok = _check_o(o[sl], ro)
        o_err = max(o_err, err)
        if not ok:
            fail(f"{fwd.__name__} disagrees with its plain version at the {label}, heads {h}..")
        del ro
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
           "plain_ms": plain_ms, "max_abs_err": max(worst), "o_max_abs_err": o_err,
           "bit_equal": bit_equal}
    msg = (f"[parity_f32_bwd] {bwd.__name__} {label} {str(q.dtype)[6:]} {layout}, heads in "
           f"chunks of {min(chunk, H)}: max|dO| {o_err:.3e} (the forward), max|dQ| "
           f"{worst[0]:.3e}, max|dK| {worst[1]:.3e}, max|dV| {worst[2]:.3e} (atol "
           f"{min(atols):.2e}..{max(atols):.2e}) ok; two runs bit-equal")
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
        if q.dtype == torch.float32 and D >= 128:  # the cluster kernel's walk and grid
            from videogpa_torch.ops import _kernels

            out["walk"] = _kernels.bwd_wide_f32_walk()
            msg += f"; walk {json.dumps(out['walk'])}"
        msg += (f"; kernel {ms:.4f} ms ({out['tflops']:.1f} TFLOP/s counting five products), "
                f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.1f} ms, SDPA "
                f"{str(q.dtype)[6:]} backward {lib_ms:.4f} ms")
        if q.dtype == torch.bfloat16 and D > 128:
            # the two wgmma kernels recompute S and dP: seven products
            out["two_kernel_bound_ms"] = _bound(14.0 * B * H * Nq * Nk * D, 0.0,
                                                PEAK_BF16_FLOPS)[0]
            out["device_ms"] = {part: _device_ms_per_call(
                lambda: bwd(q, k, v, o, lse, do, layout=layout), 3, name)
                for part, name in (("prologue", "bwd_wide_prologue"),
                                   ("dk_dv", "bwd_wide_kernel<true"),
                                   ("dq", "bwd_wide_kernel<false"))}
            msg += (f", the two kernels' seven products' bound "
                    f"{out['two_kernel_bound_ms']:.4f} ms; device ms by kernel (torch.profiler) "
                    f"{json.dumps(out['device_ms'])}")
        del qt, kt, vt, ot, dot
    log(msg)
    del o, lse, grads
    torch.cuda.empty_cache()
    return out


def phase_parity_f32_bwd(cam_shape, vggt_shape):
    """The bit-stable backwards against their plain versions:
    ``flash_attn_bwd_f32`` at the camera head, the frame rows, one long row
    and B*H = 66,000, and ``flash_attn_bwd_wide`` at (1, 4,096, 16, 256) in
    f32 (the CUDA-core kernel) and bf16 (the two wgmma kernels), each two
    runs bit-equal, the forward's O checked too, timed beside its bound and
    SDPA's backward in the same dtype; edge cases (cross and ragged lengths,
    head dims 16, 32 and 192-512, the bhnd layout, strided views, operands
    off 16-byte alignment (the wide bf16 entries copy them), B*H = 66,000 at
    D = 192, more key tiles than the grid holds CTAs: the in-order dQ walk);
    ``attention()`` autograd in f32 through K6's f32 entry and this one.
    Returns a dict."""
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
              ("long row D=256 bf16", wide, (1, 4096, 16, 256), torch.bfloat16, 10)]
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
        ("cross Nq=300 Nk=130 D=512 f32 (a cluster of four CTAs)", wide, "bnhd",
         tuple(rnd((1, n, 2, 512)) for n in (300, 130, 130, 300))),
        ("ragged N=200 D=320 f32 bhnd (a cluster of three)", wide, "bhnd",
         tuple(bhnd(2, 200, 2, 320) for _ in range(4))),
        ("B*H = 2 x 33,000 = 66,000 N=24 D=192 f32 (a spare slot)", wide, "bnhd",
         tuple(rnd((2, 24, 33000, 192)) for _ in range(4))),
        ("B*H = 2 x 33,000 = 66,000 N=24 D=128 f32 (clusters of one CTA)", f32, "bnhd",
         tuple(rnd((2, 24, 33000, 128)) for _ in range(4))),
        ("cross Nq=150 Nk=260 D=576 f32 (five CTAs, a spare slot)", wide, "bnhd",
         tuple(rnd((1, n, 2, 576)) for n in (150, 260, 260, 150))),
        ("ragged N=130 D=1088 f32 bhnd (two groups of chunks, streamed)", wide, "bhnd",
         tuple(bhnd(1, 130, 2, 1088) for _ in range(4))),
        ("cross Nq=333 Nk=200 D=192 bf16 strided (B, H, N, D) views", wide, "bhnd",
         tuple(rnd((2, n, 3 * 192), torch.bfloat16).view(2, n, 3, 192).transpose(1, 2)
               for n in (333, 200, 200, 333))),
        ("cross Nq=300 Nk=130 D=512 bf16", wide, "bnhd",
         tuple(rnd((1, n, 2, 512), torch.bfloat16) for n in (300, 130, 130, 300))),
        ("ragged N=200 D=320 bf16 bhnd", wide, "bhnd",
         tuple(bhnd(2, 200, 2, 320, torch.bfloat16) for _ in range(4))),
        ("bf16 operands 2 bytes off 16-byte alignment N=70 D=256 (copied)", wide, "bnhd",
         tuple(rnd(70 * 2 * 256 + 1, torch.bfloat16)[1:].view(1, 70, 2, 256) for _ in range(4))),
        ("B*H = 2 x 33,000 = 66,000 N=24 D=192 bf16", wide, "bnhd",
         tuple(rnd((2, 24, 33000, 192), torch.bfloat16) for _ in range(4))),
    ]
    runs = list(out["shapes"].values())
    for label, (fwd, bwd), layout, (q, k, v, do) in edges:
        r = _bwd_f32_run(label, fwd, bwd, q, k, v, do.contiguous(), layout)
        out["edge_cases"][label] = r["max_abs_err"]
        runs.append(r)
        del q, k, v, do
    del edges, unaligned
    # the largest error of each kernel (bf16 gradients are held by bf16 tolerances)
    out["max_abs_err"] = max(r["max_abs_err"] for r in runs if r["shape"][-1] <= 128)
    out["wide_max_abs_err"] = {
        dt: max(max(r["max_abs_err"], r["o_max_abs_err"]) for r in runs
                if r["shape"][-1] > 128 and r["dtype"] == dt) for dt in ("float32", "bfloat16")}
    for key, args in (("registers_smem_d64", ("flash_attn_bwd_f32", 64)),
                      ("registers_smem_d128", ("flash_attn_bwd_wide_f32", 128)),
                      ("registers_smem_d16", ("flash_attn_bwd_f32", 16)),
                      ("registers_smem_wide_f32_d256", ("flash_attn_bwd_wide_f32", 256)),
                      ("registers_smem_wide_f32_d1088", ("flash_attn_bwd_wide_f32", 1088)),
                      ("registers_smem_wide_bf16_dkv_d256", ("flash_attn_bwd_wide_bf16", 256, 1)),
                      ("registers_smem_wide_bf16_dq_d256", ("flash_attn_bwd_wide_bf16", 256, 0)),
                      ("registers_smem_wide_bf16_dkv_d512", ("flash_attn_bwd_wide_bf16", 512, 1)),
                      ("registers_smem_wide_bf16_dq_d512", ("flash_attn_bwd_wide_bf16", 512, 0))):
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
    """``attention()`` at head dims above 128 (160 padded to 192, 256, 320,
    512) in bf16 (bhnd) and f32 (bnhd): inference through ``flash_attn_fwd_wide``,
    ``impl="flash_int8"`` taking the same exact route (the JAX package's rule
    at D >= 128: no int8 launch, the same O bit for bit), and autograd through
    ``flash_attn_fwd_wide`` + ``flash_attn_bwd_wide``, each against the plain
    version at D. Returns the largest |dO| by dtype."""
    import torch

    from videogpa_torch.ops.attention import (
        attention, flash_attn_bwd_reference, flash_attn_bwd_wide, flash_attn_fwd_reference,
        flash_attn_fwd_wide, flash_attn_int8, flash_attn_int8_d128, flash_attn_int8_f32)

    worst = {"bfloat16": 0.0, "float32": 0.0}
    for D in (160, 256, 320, 512):
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
    """The forwards above head_dim 128 and the int8 route in f32 alone:
    ``flash_attn_fwd_wide`` at (1, 4,096, 16, 256) in f32 (CUDA cores) and
    bf16 (wgmma + TMA) and ``flash_attn_int8_f32`` at the f32 scorer's
    global rows (4, 13,740, 16, 64), each held against its plain version
    (over chunks of heads) and timed beside its bound and one PyTorch call
    computing the same function (SDPA; none computes int8-QK attention);
    registers and shared memory of the wide kernels at several head dims.
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
        ms = cuda_ms(lambda: flash_attn_fwd_wide(q, k, v, layout="bnhd"),
                     iters=3 if dtype == torch.float32 else 20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         iters=3 if dtype == torch.float32 else 20)
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
        ("fwd_wide_f32_d256", ("flash_attn_fwd_wide_f32", 256)),
        ("fwd_wide_f32_d320", ("flash_attn_fwd_wide_f32", 320)),
        ("fwd_wide_bf16_d256", ("flash_attn_fwd_wide_bf16", 256)),
        ("fwd_wide_bf16_d192", ("flash_attn_fwd_wide_bf16", 192)),
        ("fwd_wide_bf16_d512", ("flash_attn_fwd_wide_bf16", 512)),
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
    walls, counts = [], []

    def timed_score_groups(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = real_score_groups(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(stats)
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
            score_cli.main(["--input_json", os.path.join(root, "groups.json"),
                            "--output_json", out_json, "--base_dir", root,
                            "--model_name", ckpt_dir,
                            "--num_frames", str(SCORE_FILES_FRAMES)] + extra)
            wall = time.perf_counter() - t0
            stats = counts[-1]
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


# ---------------------------------------------------------------------------
# DA3: the reference's default scoring backbone, and the replicate flow on it
# ---------------------------------------------------------------------------

# [slice_da3]: the card against the CPU, both in f32 (cuDNN's TF32 off, f32
# attention through K6's f32 entry): the same arithmetic up to summation
# order, ~1e-7 relative a layer (the CPU tests see <= 3e-7 against JAX); the
# heads' exp() doubles it. 1e-4 in the rel-norm is the CPU parity limit.
DA3_F32_REL = 1e-4


def regular_da3_camera_(model) -> None:
    """Shift the random camera decoder's fov outputs by +1 rad (its ReLU can
    emit fov 0: focal length inf, no reprojection), as ``regular_camera_``
    does for VGGT."""
    import torch

    with torch.no_grad():
        model.cam_dec.fc_fov.bias += 1.0


def small_da3_config():
    """DA3's grammar at DA3-Large's head dim (64): 8 blocks from alt_start 2,
    280^2 frames (20 x 20 patches, 401 tokens), DualDPT 32 / (32, 32, 64, 64)."""
    import dataclasses

    from videogpa_torch.models.da3 import DA3Config

    return dataclasses.replace(DA3Config.tiny(), img_size=280, embed_dim=128, num_heads=2,
                               dpt_features=32, dpt_out_channels=(32, 32, 64, 64))


def _normalised(clips):
    """uint8 clips -> (K, S, 3, H, W) ImageNet-normalised f32 on the CPU."""
    import numpy as np
    import torch

    from videogpa_torch.models.da3.model import IMAGENET_MEAN, IMAGENET_STD

    x = torch.from_numpy(np.stack(clips)).float().permute(0, 1, 4, 2, 3) / 255.0
    mean = torch.tensor(IMAGENET_MEAN).reshape(1, 1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD).reshape(1, 1, 3, 1, 1)
    return (x - mean) / std


def phase_slice_da3() -> None:
    """The tiny DA3 (4 views) and a small one (6 views at 280^2) in f32 on
    the card against the same weights on the CPU: depth, conf, extrinsics
    and intrinsics by rel-norm, and the selected reference view, equal; then
    the tiny DA3 scorer through process_frames_batch, card against CPU."""
    import copy

    import numpy as np
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.da3 import DA3Config, da3_forward, da3_init
    from videogpa_torch.models.da3 import vit
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.reward import VideoProcessor

    real_select = vit.select_reference_view
    picks = []

    def spy(x, strategy="saddle_balanced"):
        idx = real_select(x, strategy)
        picks.append(idx.cpu().tolist())
        return idx

    for tag, cfg, S in (("tiny", DA3Config.tiny(), 4), ("small", small_da3_config(), 6)):
        ref = da3_init(cfg, torch.Generator().manual_seed(20), device="cpu")
        regular_da3_camera_(ref)
        dev = copy.deepcopy(ref).to("cuda")
        x = _normalised(synthetic_frames(2, S, cfg.img_size, seed=21))
        picks.clear()
        vit.select_reference_view = spy
        try:
            with torch.no_grad():
                want = da3_forward(ref, x)
                zero_launches()
                got = da3_forward(dev, x.cuda())
                torch.cuda.synchronize()
        finally:
            vit.select_reference_view = real_select
        launches = {k: v for k, v in read_launches().items() if v}
        rel = {k: ((got[k].cpu() - want[k]).norm() / want[k].norm()).item()
               for k in ("depth", "depth_conf", "extrinsics", "intrinsics", "ray")}
        log(f"[slice_da3] {tag} DA3 ({cfg.img_size}^2, 2 clips x {S} views, {cfg.depth} blocks "
            f"of {cfg.num_heads} x {cfg.embed_dim // cfg.num_heads}) f32 card vs CPU: rel-norm "
            + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
            + f" (limit {DA3_F32_REL}); reference views CPU {picks[0]}, card {picks[1]}; "
            f"launches {json.dumps(launches)}")
        if picks[0] != picks[1]:
            fail(f"the {tag} DA3 selected other reference views on the card")
        if max(rel.values()) > DA3_F32_REL or not all(
                bool(torch.isfinite(got[k]).all()) for k in rel):
            fail(f"the {tag} DA3 forward on the card disagrees with the CPU")
        if launches != {"flash_attn_fwd_f32": cfg.depth}:
            fail(f"the {tag} f32 DA3 did not run its {cfg.depth} blocks through K6 f32")

        if tag == "tiny":
            lp_ref = lpips_init(torch.Generator().manual_seed(9), device="cpu")
            lp_dev = copy.deepcopy(lp_ref).to("cuda")
            clips = synthetic_frames(2, S, cfg.img_size, seed=22)

            def score(model, lp, device):
                vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model,
                                    backbone="da3", compute_dtype=torch.float32, device=device)
                return vp.process_frames_batch(clips, [0])

            got_s, want_s = score(dev, lp_dev, "cuda"), score(ref, lp_ref, "cpu")
            flip = SCORER_FLIPS / (S * cfg.img_size ** 2)
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
                    worst[name] = max(worst.get(name, 0.0), abs(a - b))
                    if not (np.isfinite(a) and abs(a - b) <= lim):
                        fail(f"tiny DA3 scorer {name}: card {a} vs CPU {b} (limit {lim:.2e})")
            log(f"[slice_da3] tiny DA3 scorer (2 clips x {S} frames) f32 card vs CPU, max |d| "
                "per score: " + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
        del ref, dev, got, want
    torch.cuda.empty_cache()


def da3_large(dtype, seed: int = 30):
    """DA3-Large on the card from a seed: the backbone in ``dtype``, the
    heads and camera MLPs f32 (the scorer's dtypes), the fov offset applied."""
    import torch

    from videogpa_torch.models.da3 import DA3Config, da3_init

    model = da3_init(DA3Config.large(), torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda", dtype=dtype)
    regular_da3_camera_(model)
    return model.eval()


def _da3_batches(vp, batches, tag, K):
    """Score each batch, timed; returns (batch ms, results)."""
    import torch

    batch_ms, results = [], []
    for b, clips in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(vp.process_frames_batch(clips, [0]))
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        log(f"[{tag}] batch {b} ({'cold' if b == 0 else 'warm'}): {batch_ms[-1]:.1f} ms, "
            f"{K / (batch_ms[-1] / 6e4):.1f} clips/min; clip 0: "
            + json.dumps({k: round(v, 6) for k, v in results[-1][0][0].items()}))
    return batch_ms, results


def phase_scorer_da3(num_batches: int = 3, K: int = 4, S: int = 10):
    """The DA3-Large scorer at full width and depth (24 blocks at 1,024, 16
    heads x 64, DualDPT 256 / (256, 512, 1,024, 1,024)) on random weights:
    ``num_batches`` batches of K clips x S frames x 518^2 through
    ``process_frames_batch``, bf16 trunk, f32 heads, the device metric set
    with a VGG16 LPIPS; launches per batch K4 16, K1 8, K5 K. Then the same
    model quantised in place (``quantize_scorer_params("da3")``) on the same
    frames: K8 8, K4 16, K5 K, and each score's drift against exact.
    Selection may pick another reference view in bf16 than in f32, so the
    scores are checked for finiteness and the geometry for its ranges."""
    import numpy as np
    import torch

    from videogpa_torch.metrics import build_metrics
    from videogpa_torch.models.da3 import DA3Config
    from videogpa_torch.models.da3.heads import dualdpt_forward
    from videogpa_torch.models.da3.vit import aavit_forward
    from videogpa_torch.models.lpips import lpips_init
    from videogpa_torch.ops.quant import QuantLinear, quantize_scorer_params
    from videogpa_torch.reward import VideoProcessor

    cfg = DA3Config.large()
    t0 = time.perf_counter()
    model = da3_large(torch.bfloat16)
    lp = lpips_init(torch.Generator(device="cuda").manual_seed(1), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[scorer_da3] DA3-Large: AA-ViT {cfg.depth} blocks at {cfg.embed_dim} "
        f"({cfg.num_heads} x {cfg.embed_dim // cfg.num_heads}), alternating from block "
        f"{cfg.alt_start}, out layers {cfg.out_layers}, DualDPT {cfg.dpt_features} / "
        f"{cfg.dpt_out_channels}; {n_params / 1e9:.3f} B params (backbone bf16, heads and "
        f"camera MLPs f32), LPIPS VGG16 f32; built in {time.perf_counter() - t0:.1f} s")
    batches = [synthetic_frames(K, S, cfg.img_size, seed=300 + b) for b in range(num_batches)]
    n_local = cfg.alt_start + (cfg.depth - cfg.alt_start) // 2
    n_global = (cfg.depth - cfg.alt_start) // 2
    out = {}
    for mode in ("exact", "int8"):
        impl = "auto"
        if mode == "int8":
            model, impl = quantize_scorer_params("da3", model)
            n_q = sum(isinstance(m, QuantLinear) for m in model.modules())
            log(f"[scorer_da3] int8: quantize_scorer_params made {n_q} linears int8 (4 x "
                f"{cfg.depth} blocks), attn_impl {impl!r}; patch embed, DualDPT and the camera "
                "MLPs as before")
            if n_q != 4 * cfg.depth:
                fail("quantize_da3_int8 did not swap 4 linears a block")
        vp = VideoProcessor(device_metrics(build_metrics(lp)), params=model, backbone="da3",
                            compute_dtype=torch.bfloat16, zbuffer_impl="packed",
                            device="cuda", attn_impl=impl)
        tag = "scorer_da3" if mode == "exact" else "scorer_da3_int8"
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        batch_ms, results = _da3_batches(vp, batches, tag, K)
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_batch = {k: v / num_batches for k, v in launches.items()}
        want = dict.fromkeys(launches, 0)
        want.update({"flash_attn_short": n_local, "scatter_min_u32": K,
                     ("flash_attn_fwd" if mode == "exact" else "flash_attn_int8"): n_global})
        log(f"[{tag}] launches per batch {json.dumps(per_batch)}; expected {json.dumps(want)} "
            f"(K4: {n_local} frame blocks of 40 x 1,370 tokens; "
            f"{'K1' if mode == 'exact' else 'K8'}: {n_global} global blocks of 4 x 13,700; K5: "
            f"one packed z-buffer a clip); peak allocated {peak_gb:.2f} GB")
        if per_batch != want:
            fail(f"the DA3 scorer ({mode}) did not run each attention and z-buffer through "
                 "its kernel")
        for r in results[-1]:
            for name, v in r[0].items():
                if not math.isfinite(v):
                    fail(f"non-finite DA3 score {name} = {v}")
            if len(r["_extrinsic"]) != S:
                fail("DA3 extrinsics of the wrong shape")
        out[mode] = {"batch_ms": batch_ms, "clips_per_min": [K / (ms / 6e4) for ms in batch_ms],
                     "peak_gb": peak_gb, "launches": launches, "per_batch": per_batch,
                     "results": results}
        if mode == "exact":
            # the geometry of one batch: depth > 0, conf > 1, proper rotations
            images = torch.from_numpy(np.stack(batches[0])).cuda()
            with torch.no_grad():
                geo = vp._reprojected(images, 0.0)
            depth, extr = geo["depth"].float(), geo["extrinsic"].float()
            det = torch.linalg.det(extr[..., :3, :3])
            ranges = {"depth_min": depth.min().item(), "depth_max": depth.max().item(),
                      "rotation_det_err": (det - 1).abs().max().item(),
                      "focal_px": [geo["intrinsic"][..., 0, 0].min().item(),
                                   geo["intrinsic"][..., 0, 0].max().item()]}
            out["ranges"] = ranges
            log(f"[scorer_da3] geometry of batch 0: {json.dumps(ranges)}")
            if not (ranges["depth_min"] > 0 and math.isfinite(ranges["depth_max"])
                    and ranges["rotation_det_err"] < 1e-3):
                fail("DA3-Large's depth or camera poses are out of range")
            del geo, images
            out["profile"] = profile_device_time(
                "one DA3 scorer batch (profiled)",
                lambda: vp.process_frames_batch(batches[-1], [0]))
            # the two model layers alone on batch 0: the trunk, and DualDPT on its taps
            x = _normalised(batches[0]).cuda().to(torch.bfloat16)
            with torch.no_grad():
                feats = aavit_forward(model.backbone, x)
                out["trunk_ms"] = cuda_ms(lambda: aavit_forward(model.backbone, x), iters=2,
                                          warmup=1)
                out["heads_ms"] = cuda_ms(
                    lambda: dualdpt_forward(model.head, feats, tuple(x.shape[-2:])), iters=2,
                    warmup=1)
            del feats, x
            out["heads_tflop"] = da3_heads_tflop(cfg, K, S)
            log(f"[scorer_da3] one batch's layers alone: AA-ViT trunk (bf16) "
                f"{out['trunk_ms']:.1f} ms; DualDPT (both chains, f32, TF32 off) "
                f"{out['heads_ms']:.1f} ms for {out['heads_tflop']:.2f} TFLOP "
                f"(torch.utils.flop_counter on meta tensors), "
                f"{out['heads_tflop'] / (out['heads_ms'] / 1e3):.1f} TFLOP/s, bound "
                f"{1e3 * out['heads_tflop'] / (PEAK_F32_FLOPS / 1e12):.1f} ms at the f32 peak")
        del vp
    drift = {}
    for got_b, want_b in zip(out["int8"]["results"], out["exact"]["results"]):
        for g, w in zip(got_b, want_b):
            for name, v in g[0].items():
                d = abs(v - w[0][name])
                worst = drift.setdefault(name, {"max_abs": 0.0, "max_rel": 0.0})
                worst["max_abs"] = max(worst["max_abs"], d)
                worst["max_rel"] = max(worst["max_rel"], d / max(abs(w[0][name]), 1e-12))
    out["int8"]["drift"] = drift
    log("[scorer_da3_int8] drift of each score against the exact scorer on the same frames "
        f"({num_batches * K} clips, random weights): "
        + json.dumps({k: {a: float(f"{b:.3e}") for a, b in v.items()} for k, v in drift.items()}))
    for mode in ("exact", "int8"):
        del out[mode]["results"]
    del model, lp
    torch.cuda.empty_cache()
    return out


def da3_heads_tflop(cfg, K: int, S: int) -> float:
    """TFLOP of DualDPT on one batch of K clips x S frames at the config's
    size, counted on meta tensors."""
    import torch

    from videogpa_torch.models.da3.heads import DualDPT, dualdpt_forward

    P = (cfg.img_size // cfg.patch_size) ** 2
    head = DualDPT(cfg, device="meta")
    feats = [(torch.empty(K, S, P, cfg.tokens_dim, device="meta", dtype=torch.bfloat16),
              torch.empty(K, S, cfg.tokens_dim, device="meta", dtype=torch.bfloat16))
             for _ in range(4)]
    return meta_tflop(lambda: dualdpt_forward(head, feats, (cfg.img_size, cfg.img_size)))


def phase_timing_da3(local_shape, global_shape):
    """K4 at DA3-Large's frame rows and K1 and K8 at its global rows, beside
    their bounds and SDPA on the same operands (standard normal draws: q and
    k contiguous, v a strided view of the packed (B, N, 3, H, D) tensor; the
    kernels' agreement at these shapes is held in [parity] and
    [parity-int8])."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import (
        flash_attn_fwd, flash_attn_int8, flash_attn_short, quantize_qk_int8)

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(61)
    for tag, shape in (("k4", local_shape), ("k1", global_shape)):
        B, N, H, D = shape
        q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
            torch.bfloat16).unbind(2)
        q, k = q.contiguous(), k.contiguous()
        fn = flash_attn_short if tag == "k4" else (
            lambda q_, k_, v_: flash_attn_fwd(q_, k_, v_, layout="bnhd"))
        out[f"{tag}_ms"] = cuda_ms(lambda: fn(q, k, v), iters=10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # yardstick only
        out[f"{tag}_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                           iters=10)
        out[f"{tag}_bound_ms"], out[f"{tag}_bound_by"] = _fwd_bound(B, N, N, H, D)
        out[f"{tag}_tflops"] = 4.0 * B * H * N * N * D / out[f"{tag}_ms"] / 1e9
        if tag == "k1":
            ops = quantize_qk_int8(q, k, "bnhd")
            out["k8_ms"] = cuda_ms(lambda: flash_attn_int8(*ops, v, layout="bnhd"), iters=10)
            out["k8_quantize_ms"] = cuda_ms(lambda: quantize_qk_int8(q, k, "bnhd"), iters=10)
            out["k8_bound_ms"], out["k8_bound_by"] = _int8_bound(B, N, N, H, D)
            del ops
        del q, k, v, qt, kt, vt
    log(f"[timing] DA3-Large attention: K4 at {list(local_shape)}, K1 and K8 at "
        f"{list(global_shape)}: " + json.dumps(out))
    torch.cuda.empty_cache()
    return out


def phase_replicate_files(models, steps: int = 2):
    """``replicate_torch.sh``'s two legs at full size. Generation:
    ``cli.replicate.main`` for 1 prompt x 1 seed (its step count cut to
    ``steps``; a video takes 50) on [sample]'s resident CogVideoX-5B-I2V
    DiT, T5-XXL and VAE (a generator built around them, the tokenizer a
    seeded stub); the DL3DV first frame (480 x 720, from memory: the card's
    machine has no OpenCV) and the mp4 writer (the frames kept in memory) are
    replaced inside the phase. Scoring: random DA3-Large weights written in
    the checkpoint key layout (``export_da3`` + ``save_file``) and read back
    by ``load_da3`` (same outputs as the module written); then
    ``cli.replicate_scorer.main`` on 2 prompts x 4 clips (the generated video
    among them) at score_batch 4 with DA3, decoded from memory, and a
    resumed run that scores nothing."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    import videogpa_torch.metrics as metrics_pkg
    from videogpa_torch.cli import generate, replicate, replicate_scorer
    from videogpa_torch.data import video_io
    from videogpa_torch.models.cogvideox import SamplerSettings
    from videogpa_torch.models.da3 import DA3Config, da3_forward
    from videogpa_torch.models.da3.convert import export_da3
    from videogpa_torch.models.loader import load_da3
    from videogpa_torch.utils.safetensors_np import save_file

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "replicate_files")
    shutil.rmtree(root, ignore_errors=True)
    scene = "0a1b2c3d"
    os.makedirs(os.path.join(root, "dl3dv", "1K", scene, "images_8"))
    open(os.path.join(root, "dl3dv", "1K", scene, "images_8", "frame_00001.png"), "wb").close()
    with open(os.path.join(root, "captions.json"), "w") as f:
        json.dump({f"1K/{scene}/images_8": "a slow walk through a sunlit courtyard"}, f)
    out_dir = os.path.join(root, "out")
    rng = np.random.default_rng(70)
    first = np.kron(rng.uniform(0, 255, (60, 90, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    written = {}

    def memory_writer(path, frames, fps=8):
        written[path] = frames
        open(path, "wb").close()  # the file the flow's skip-existing checks

    icfg, idit, vae, t5, t5_cfg = (models[k] for k in ("cfg", "dit", "vae", "t5", "t5_cfg"))
    calls = []
    generator_cls = generate.CogVideoXGenerator

    def resident(args, cfg, i2v=False, dynamic_cfg=False, lora_weight=None,
                 absolute_lora=False, device=None):
        calls.append({"lora_weight": lora_weight, "steps": args.num_inference_steps})
        gen = generator_cls.__new__(generator_cls)
        gen.cfg, gen.i2v, gen.args, gen.device, gen.attn_impl = cfg, i2v, args, "cuda", "auto"
        gen.settings = SamplerSettings(num_inference_steps=args.num_inference_steps,
                                       guidance_scale=args.guidance_scale,
                                       use_dynamic_cfg=dynamic_cfg)
        gen.dit, gen.vae, gen.t5 = idit, vae, t5
        gen.tokenizer = _StubTokenizer(t5_cfg.vocab_size, seed=71)
        return gen

    config = replicate.build_config({
        "RUN_MODE": "dpo", "RUN_SEEDS": "456", "RUN_NUM_PROMPTS": "1",
        "PROMPT_JSON": os.path.join(root, "captions.json"),
        "DL3DV_BASE_DIR": os.path.join(root, "dl3dv"), "RUN_OUTPUT_DIR": out_dir,
        "RUN_LORA_PATH": os.path.join(root, "no_lora")})
    config["num_inference_steps"] = steps
    real = (generate.CogVideoXGenerator, replicate.read_first_frame, video_io.write_video)
    generate.CogVideoXGenerator = resident
    replicate.read_first_frame = lambda path, width=720, height=480: first
    video_io.write_video = memory_writer
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = replicate.main(config, cfg=icfg)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_launches = read_launches()
        again = replicate.main(config, cfg=icfg)  # every video exists: nothing new
    finally:
        generate.CogVideoXGenerator, replicate.read_first_frame, video_io.write_video = real
    gen_peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(gen_launches, 0)
    want["flash_attn_fwd"] = steps * icfg.num_layers
    name = os.path.join(out_dir, scene, "seed_456_dpo_w1.0.mp4")
    video = written.get(name)
    log(f"[replicate_files] cli.replicate.main: 1 prompt x 1 seed, {steps} DPM steps (cut from "
        f"50), CogVideoX-5B-I2V ({icfg.num_layers} layers) with T5-XXL and the VAE resident: "
        f"{gen_s:.2f} s, wrote {[os.path.relpath(p, root) for p in paths]}, video "
        f"{None if video is None else video.shape}, peak {gen_peak:.2f} GB, generator calls "
        f"{calls}; launches {json.dumps({k: v for k, v in gen_launches.items() if v})}")
    if paths != [name] or video is None or video.shape != (49, 480, 720, 3):
        fail("cli.replicate.main did not write the 49 x 480 x 720 video it names")
    if gen_launches != want:
        fail(f"the replicate generation's launches are not K1's {want['flash_attn_fwd']} alone")
    if again != []:
        fail("a second cli.replicate.main run generated again")
    del models["dit"], models["vae"], models["t5"], idit, vae, t5
    torch.cuda.empty_cache()

    # the DA3-Large checkpoint in the checkpoint key layout, read back
    cfg = DA3Config.large()
    ckpt_dir = os.path.join(root, "da3_large")
    os.makedirs(ckpt_dir)
    model = da3_large(torch.float32, seed=72)
    t0 = time.perf_counter()
    sd = export_da3(model)
    save_file(sd, os.path.join(ckpt_dir, "model.safetensors"))
    write_s = time.perf_counter() - t0
    size_gb = os.path.getsize(os.path.join(ckpt_dir, "model.safetensors")) / 1e9
    n_keys = len(sd)
    del sd
    t0 = time.perf_counter()
    loaded, _ = load_da3(ckpt_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = _normalised(synthetic_frames(1, 10, cfg.img_size, seed=73)).cuda()
    with torch.no_grad():
        a = da3_forward(model, x, compute_dtype=torch.bfloat16)
        b = da3_forward(loaded, x, compute_dtype=torch.bfloat16)
    same = all(torch.equal(a[k], b[k]) for k in ("depth", "depth_conf", "extrinsics",
                                                 "intrinsics"))
    log(f"[replicate_files] DA3-Large in the checkpoint key layout: {n_keys} tensors, "
        f"{size_gb:.2f} GB f32 safetensors written in {write_s:.1f} s, load_da3 {load_s:.1f} s; "
        f"depth, conf, extrinsics, intrinsics of one 10-frame clip bit-equal to the module "
        f"written: {same}")
    if not same:
        fail("load_da3 does not give back the module that was written")
    del model, loaded, a, b, x
    torch.cuda.empty_cache()

    # 2 prompts x 4 clips: the generated video and 7 synthetic ones, from memory
    frames = {}
    idx = np.linspace(0, video.shape[0] - 1, 10).round().astype(int)
    side = min(video.shape[1:3])
    top, left = (video.shape[1] - side) // 2, (video.shape[2] - side) // 2
    crop = torch.from_numpy(video[idx, top:top + side, left:left + side]).permute(0, 3, 1, 2)
    frames[name] = F.interpolate(crop.float(), size=(cfg.img_size, cfg.img_size), mode="area"
                                 ).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    extra = [(scene, "seed_457_dpo_w1.0.mp4"), (scene, "seed_456_original_w1.0.mp4"),
             (scene, "seed_457_original_w1.0.mp4")] + [
        ("scene2", f"seed_{s}_{m}_w1.0.mp4") for s in (456, 457) for m in ("dpo", "original")]
    synth = synthetic_frames(len(extra), 10, cfg.img_size, seed=74)
    for (pid, fname), clip in zip(extra, synth):
        os.makedirs(os.path.join(out_dir, pid), exist_ok=True)
        path = os.path.join(out_dir, pid, fname)
        open(path, "wb").close()
        frames[path] = clip

    def memory_frames(path, n_frames=48, size=518):
        return frames[path][:n_frames]

    real_build = metrics_pkg.build_metrics

    def device_build(*a, **k):
        return device_metrics(real_build(*a, **k))

    score_cfg = replicate_scorer.build_score_config({
        "SCORE_BASE_DIR": out_dir, "SCORE_OUTPUT_CSV": os.path.join(root, "scores.csv"),
        "SCORE_NUM_FRAMES": "10", "SCORE_BATCH": "4", "SCORE_MODEL_NAME": ckpt_dir})
    real_decode = video_io.sample_uniform_frames
    video_io.sample_uniform_frames = memory_frames
    metrics_pkg.build_metrics = device_build
    try:
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = replicate_scorer.main(score_cfg, device="cuda")
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        score_launches = read_launches()
        zero_launches()
        resumed = replicate_scorer.main({**score_cfg, "resume": True}, device="cuda")
        resume_launches = read_launches()
    finally:
        video_io.sample_uniform_frames = real_decode
        metrics_pkg.build_metrics = real_build
    rows = report["rows"]
    n_local = cfg.alt_start + (cfg.depth - cfg.alt_start) // 2
    n_global = (cfg.depth - cfg.alt_start) // 2
    want = dict.fromkeys(score_launches, 0)
    want.update({"flash_attn_short": 2 * n_local, "flash_attn_fwd": 2 * n_global,
                 "scatter_min_u32": 8})
    log(f"[replicate_files] cli.replicate_scorer.main (DA3, score_batch 4, the CSV's metric "
        f"set without Epipolar, MSE-only consistency): {len(rows)} rows in {score_s:.1f} s "
        f"(load_da3 included), summary " + json.dumps(
            {m: {k: round(v, 6) for k, v in s.items()} for m, s in report["summary"].items()})
        + f"; launches {json.dumps({k: v for k, v in score_launches.items() if v})} (expected "
        f"2 batches: {json.dumps({k: v for k, v in want.items() if v})}); the generated video's "
        f"row: " + json.dumps({k: v for k, v in rows[0].items()
                               if k in ("relative_path", "consistency_score", "motion_score")}))
    if len(rows) != 8 or any(r.get("error") for r in rows) or not all(
            math.isfinite(r["consistency_score"]) for r in rows):
        fail("cli.replicate_scorer.main did not score the 8 clips")
    if {m: s["count"] for m, s in report["summary"].items()} != {"dpo": 4, "original": 4}:
        fail("the replicate scorer's per-mode summary is wrong")
    if score_launches != want:
        fail("the replicate scorer did not run DA3's attention and z-buffer through K4, K1, K5")
    if resumed["rows"] != rows or any(resume_launches.values()):
        fail("a resumed cli.replicate_scorer.main run scored again")
    log(f"[replicate_files] resumed run: {len(resumed['rows'])} rows, nothing scored")
    lightglue = _replicate_lightglue(root, score_cfg, frames, want, replicate_scorer,
                                     metrics_pkg, video_io, memory_frames)
    shutil.rmtree(root)
    return {"generate_s": gen_s, "generate_peak_gb": gen_peak, "generate_launches": gen_launches,
            "checkpoint_gb": size_gb, "write_s": write_s, "load_s": load_s, "score_s": score_s,
            "score_launches": score_launches, "summary": report["summary"],
            "lightglue": lightglue}


def _replicate_lightglue(root, score_cfg, frames, want, replicate_scorer, metrics_pkg, video_io,
                         memory_frames):
    """[replicate_files]'s scorer again over the same clips and DA3-Large
    checkpoint with ``SCORE_DESCRIPTOR_TYPE=lightglue``: the matcher's trees
    (``matcher_trees(.., matching=True)``, published widths) written with
    ``save_pytree`` and named by ``VIDEOGPA_SUPERPOINT_PATH`` /
    ``VIDEOGPA_LIGHTGLUE_PATH``, its threshold set to 0. Prints clips/min
    (without ``load_da3``) beside the run without Epipolar, the matcher's ms
    a pair split into SuperPoint, keypoint extraction (NMS + top-k + the
    descriptor samples), LightGlue and the host geometry, the matches a
    pair, the Epipolar values and the launches (those of the run without
    Epipolar: the matcher launches no kernel)."""
    import dataclasses

    import torch

    from videogpa_torch.checkpoint import save_pytree
    from videogpa_torch.metrics import epipolar
    from videogpa_torch.models import loader

    sp, lg = matcher_trees(85, matching=True)
    paths = {"VIDEOGPA_SUPERPOINT_PATH": os.path.join(root, "superpoint.npz"),
             "VIDEOGPA_LIGHTGLUE_PATH": os.path.join(root, "lightglue.npz")}
    save_pytree(sp, paths["VIDEOGPA_SUPERPOINT_PATH"])
    save_pytree(lg, paths["VIDEOGPA_LIGHTGLUE_PATH"])
    old_env = {k: os.environ.get(k) for k in paths}
    os.environ.update(paths)
    real_build, real_decode, real_load = (metrics_pkg.build_metrics,
                                          video_io.sample_uniform_frames, loader.load_da3)
    real_pair = epipolar.LightGlueMatcher.get_matched_points
    matchers, pairs, load_s = [], [], []

    def lightglue_build(*a, **k):
        metrics = real_build(*a, **k)
        m = metrics["Epipolar"].matcher
        m.lg_cfg = dataclasses.replace(m.lg_cfg, filter_threshold=0.0)
        matchers.append(m)
        return device_metrics(metrics)

    def counted_pair(self, f1, f2):
        result = real_pair(self, f1, f2)
        pairs.append(result[2])
        return result

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        result = real_load(*a, **k)
        load_s.append(time.perf_counter() - t0)
        return result

    cfg = {**score_cfg, "descriptor_type": "lightglue",
           "output_csv": os.path.join(root, "scores_lightglue.csv")}
    stages = ["superpoint_forward", "extract_keypoints", "lightglue_match", "find_fundamental",
              "sampson_distance"]
    metrics_pkg.build_metrics, video_io.sample_uniform_frames = lightglue_build, memory_frames
    loader.load_da3 = timed_load
    epipolar.LightGlueMatcher.get_matched_points = counted_pair
    ms, calls, restore = _stage_timers(epipolar, stages)
    try:
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = replicate_scorer.main(cfg, device="cuda")
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        restore()
        metrics_pkg.build_metrics, video_io.sample_uniform_frames = real_build, real_decode
        loader.load_da3 = real_load
        epipolar.LightGlueMatcher.get_matched_points = real_pair
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rows = report["rows"]
    n_pairs = len(pairs)
    per_pair = {"superpoint": ms["superpoint_forward"] / max(calls["superpoint_forward"], 1),
                "keypoints": ms["extract_keypoints"] / max(calls["extract_keypoints"], 1),
                "lightglue": ms["lightglue_match"] / max(calls["lightglue_match"], 1),
                "host_geometry": (ms["find_fundamental"] + ms["sampson_distance"])
                / max(n_pairs, 1)}
    scoring_s = score_s - sum(load_s)
    out = {"clips_per_min": len(rows) / scoring_s * 60, "score_s": score_s,
           "load_da3_s": sum(load_s), "pairs": n_pairs, "matcher_ms_per_pair": per_pair,
           "matches_per_pair": pairs, "geometry_pairs": calls["find_fundamental"],
           "epipolar": [r["epipolar"] for r in rows], "launches": launches,
           "matcher_device": str(matchers[0].device) if matchers else None,
           "matcher_layers": len(matchers[0].lg_params.layers) if matchers else None}
    log("[replicate_files] cli.replicate_scorer.main with SCORE_DESCRIPTOR_TYPE=lightglue "
        "(the matcher's trees from VIDEOGPA_SUPERPOINT_PATH / VIDEOGPA_LIGHTGLUE_PATH, "
        "threshold 0): " + json.dumps({k: v for k, v in out.items() if k != "launches"})
        + f"; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if len(rows) != 8 or any(r.get("error") for r in rows) or not all(
            math.isfinite(r["epipolar"]) for r in rows):
        fail("the lightglue scorer did not score the 8 clips")
    if out["matcher_device"] != "cuda" or out["matcher_layers"] != 9 or n_pairs != 8 * 9:
        fail("the lightglue scorer's matcher did not run on the card at full depth")
    if out["geometry_pairs"] == 0:
        fail("no pair of the lightglue run reached the fundamental matrix")
    if launches != want:
        fail("the lightglue scorer's DA3 launches differ from the run without Epipolar")
    return out


# ---------------------------------------------------------------------------
# DA3 served as a depth-and-pose model: mono / metric, nested giant + metric
# large, the Gaussian branch and renderer, the export pack, the HTTP backend
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# CogVideoX1.5-5B served at full width and depth on one card: 81 frames at
# 768 x 1360 -> 21 latent frames, rounded up to patch_size_t = 2 -> 22 x 96 x
# 170 latents -> 11 x 48 x 85 = 44,880 video tokens + 226 text = 45,106
# ---------------------------------------------------------------------------

COG15_VIDEO = (81, 768, 1360)  # frames, height, width: generate/CogVideoX1.5-5B.py


def cog15_shapes():
    """(config, one request's latent shape (1, 22, 16, 96, 170), the CFG
    pair's attention shape (2, 45,106, 48, 64))."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig, num_latent_frames

    cfg = CogVideoXConfig.cogvideox_1_5_5b()
    frames, height, width = COG15_VIDEO
    F_, sc = num_latent_frames(cfg, frames), cfg.spatial_compression_ratio
    lat = (1, F_, cfg.vae_latent_channels, height // sc, width // sc)
    p, pt = cfg.patch_size, cfg.patch_size_t
    n = cfg.max_text_seq_length + (F_ // pt) * (lat[3] // p) * (lat[4] // p)
    return cfg, lat, (2, n, cfg.num_heads, cfg.head_dim)


def small_cog15_config():
    """CogVideoX1.5's layout (patch_size_t 2, the Linear patch embed, latents
    scaled by inversion) at 2 layers of 2 x 16 and 4 latent frames of 64 x
    80: 8 + 2 x 32 x 40 = 2,568 tokens, past K4's 2,048, so its attention runs
    K1 as the 5B's does."""
    import dataclasses

    from videogpa_torch.models.cogvideox import CogVideoXConfig

    return dataclasses.replace(CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4,
                               sample_height=64, sample_width=80,
                               vae_invert_scale_latents=True)


def phase_parity_cog15(shape):
    """K1 and K8 at CogVideoX1.5-5B's CFG pair (2, 45,106, 48, 64) against
    their plain versions over one head at a time (a head's f32 score matrix
    is 8.1 GB, the pair's 781 GB), at [parity]'s and [parity-int8]'s
    tolerances; each kernel's ms beside its bound, K1's beside SDPA's and K8's
    in turns with K1's; then a small CogVideoX1.5 DiT (``small_cog15_config``)
    in bf16 on the card against f32 on the CPU. Returns K1's and K8's
    figures at the shape."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.models.cogvideox import dit_forward, dit_init
    from videogpa_torch.ops.attention import flash_attn_fwd, flash_attn_int8, quantize_qk_int8

    B, N, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(150)
    q, k, v = _int8_case(gen, B, N, N, H, D, "bnhd")
    zero_launches()
    k1_err, k1_plain_ms = _parity_full(f"CogVideoX1.5-5B shape {shape}", q, k, v, chunk=1)
    k8_err, k8_plain_ms = _int8_full("K8", f"CogVideoX1.5-5B shape {shape}", flash_attn_int8,
                                     q, k, v, chunk=1)
    k1 = {"shape_bnhd": list(shape), "max_abs_err": k1_err, "plain_ms": k1_plain_ms}
    k8 = {"shape_bnhd": list(shape), "max_abs_err": k8_err, "plain_ms": k8_plain_ms}
    ops = quantize_qk_int8(q, k, "bnhd")
    t = [cuda_ms(f, iters=3, warmup=1) for f in (
        lambda: flash_attn_fwd(q, k, v, layout="bnhd"), lambda: flash_attn_int8(*ops, v),
        lambda: flash_attn_int8(*ops, v), lambda: flash_attn_fwd(q, k, v, layout="bnhd"))]
    k1["ms"], k1["turns_ms"] = 0.5 * (t[0] + t[3]), [t[0], t[3]]
    k8["ms"], k8["turns_ms"] = 0.5 * (t[1] + t[2]), t[1:3]
    k8["quantize_qk_ms"] = cuda_ms(lambda: quantize_qk_int8(q, k, "bnhd"), iters=3, warmup=1)
    del ops
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # yardstick only: the port never calls SDPA
    k1["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=3,
                               warmup=1)
    k8["library_ms"] = None  # no PyTorch call computes int8-QK attention
    k1["bound_ms"], k1["bound_by"] = _fwd_bound(B, N, N, H, D)
    k8["bound_ms"], k8["bound_by"] = _int8_bound(B, N, N, H, D)
    for r in (k1, k8):
        r["tflops"] = 4.0 * B * H * N * N * D / r["ms"] / 1e9
    log(f"[parity_cog15] K1 at {shape}: {t[0]:.2f}, {t[3]:.2f} ms (bound {k1['bound_ms']:.2f}, "
        f"{k1['bound_by']}; {k1['tflops']:.0f} TFLOP/s), SDPA {k1['library_ms']:.2f} ms, plain "
        f"version {k1_plain_ms:.1f} ms over one head at a time; K8 {t[1]:.2f}, {t[2]:.2f} ms "
        f"(bound {k8['bound_ms']:.2f}, {k8['bound_by']}) + quantize_qk_int8 "
        f"{k8['quantize_qk_ms']:.2f} ms, plain version {k8_plain_ms:.1f} ms")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    cfg = small_cog15_config()
    ref = dit_init(cfg, torch.Generator().manual_seed(151), device="cpu").requires_grad_(False)
    dev = dit_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({n: w.to(torch.bfloat16) for n, w in ref.state_dict().items()})
    cpu_gen = torch.Generator().manual_seed(152)
    x = torch.randn(2, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                    cfg.sample_width, generator=cpu_gen)
    txt = torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim, generator=cpu_gen)
    t_ = torch.tensor([100, 900])
    want = dit_forward(ref, x, txt, t_, compute_dtype=torch.float32, attn_layout="bnhd")
    zero_launches()
    got = dit_forward(dev, x.cuda(), txt.cuda(), t_.cuda(), attn_layout="bnhd").cpu()
    small = read_launches()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[parity_cog15] small CogVideoX1.5 DiT (patch_size_t 2, {cfg.sample_frames} latent "
        f"frames of {cfg.sample_height} x {cfg.sample_width}) bf16 on the card vs f32 on the "
        f"CPU: max|d|/max|ref| {rel:.3e} (limit 5e-2); launches "
        f"{json.dumps({n: c for n, c in small.items() if c})}")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        fail("the small CogVideoX1.5 DiT on the card disagrees with the CPU reference")
    if small != {**dict.fromkeys(small, 0), "flash_attn_fwd": cfg.num_layers}:
        fail("the small CogVideoX1.5 DiT did not run its attention through K1")
    return {"k1": k1, "k8": k8}


def _cog15_dit(cfg):
    import torch

    from videogpa_torch.models.cogvideox import dit_init

    t0 = time.perf_counter()
    dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(153), device="cuda",
                   dtype=torch.bfloat16).requires_grad_(False)
    torch.cuda.synchronize()
    return dit, time.perf_counter() - t0


def phase_cog15(steps: int = 2):
    """The CogVideoX1.5-5B denoise path at full width and depth (42 layers,
    48 x 64, no depth cut) on random bf16 weights: one warm DPM step, then 1
    request x ``steps`` DPM steps of the CFG pair with dynamic CFG on (1, 22,
    16, 96, 170) latents; the warm step is profiled. Checks finite latents of
    that shape and K1's launches (42 a step, every other kernel 0). Returns
    the DiT (for [cog15-int8]) and the warm step's latents."""
    import torch

    from videogpa_torch.models.cogvideox import SamplerSettings, denoise_loop

    cfg, lat_shape, attn_shape = cog15_shapes()
    log(f"[cog15] resident before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    dit, init_s = _cog15_dit(cfg)
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"[cog15] CogVideoX1.5-5B DiT: {cfg.num_layers} layers (no depth cut), "
        f"{cfg.num_heads}x{cfg.head_dim} heads, patch {cfg.patch_size_t}x{cfg.patch_size}x"
        f"{cfg.patch_size} (Linear embed), {n_params / 1e9:.3f} B params in bf16 on the card in "
        f"{init_s:.1f} s; latents {lat_shape}, attention {attn_shape}")
    gen = torch.Generator(device="cuda").manual_seed(154)
    text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen,
                       device="cuda")
    negative = torch.randn(text.shape, generator=gen, device="cuda")
    one = SamplerSettings(num_inference_steps=1, sampler="dpm", use_dynamic_cfg=True)
    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm", use_dynamic_cfg=True)

    def run(s, seed, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise_loop(dit, text, negative, s, lat_shape,
                           generator=torch.Generator(device="cuda").manual_seed(seed), **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    warm = {}

    def warm_step():
        warm["latents"], warm["s"] = run(one, 155)

    # the warm step is the profiled one: a step at this shape costs ~7.6 s,
    # and the first runs as fast as the next (PR 22's runs)
    profile = profile_device_time("one CogVideoX1.5-5B denoise step (the warm one, profiled)",
                                  warm_step)
    zero_launches()
    lat, request_s = run(settings, 156)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm_s = warm["s"]
    for name, x in (("warm", warm["latents"]), ("timed", lat)):
        if tuple(x.shape) != lat_shape or not bool(torch.isfinite(x).all()):
            fail(f"[cog15] {name} latents {tuple(x.shape)} not finite or not {lat_shape}")
    step_ms = 1e3 * request_s / steps
    expected = steps * cfg.num_layers
    log(f"[cog15] warm step (profiled) {1e3 * warm_s:.1f} ms; 1 request x {steps} DPM steps "
        f"(CFG pair, dynamic CFG) in {request_s:.3f} s = {step_ms:.1f} ms a step, latents "
        f"{tuple(lat.shape)} finite, std {lat.float().std().item():.4f}; peak allocated "
        f"{peak_gb:.2f} GB; launches {json.dumps(launches)}; expected flash_attn_fwd 1 request "
        f"x {steps} steps x {cfg.num_layers} layers = {expected}, every other 0")
    if launches != {**dict.fromkeys(launches, 0), "flash_attn_fwd": expected}:
        fail("the CogVideoX1.5-5B denoise path did not run every attention through K1 alone")
    return {"dit": dit, "warm_latents": warm["latents"].float().cpu(), "launches": launches,
            "warm_ms": 1e3 * warm_s, "request_s": request_s, "step_ms": step_ms,
            "peak_gb": peak_gb, "profile": profile, "text": text, "negative": negative}


def phase_cog15_int8(exact):
    """[cog15]'s DiT after ``quantize_dit_int8`` in place, under
    ``attn_impl="flash_int8"``: one timed DPM step (the first int8 one: K8 and
    the int8 GEMMs ran before, in the parity phases) with the draws of
    [cog15]'s warm step, its latents against that step's
    (cosine and rel-L2, as [main-int8]). Checks finite latents and K8's
    launches (42, every other kernel 0)."""
    import torch

    from videogpa_torch.models.cogvideox import SamplerSettings, denoise_loop
    from videogpa_torch.ops.quant import QuantLinear, quantize_dit_int8

    cfg, lat_shape, _ = cog15_shapes()
    dit, text, negative = exact.pop("dit"), exact.pop("text"), exact.pop("negative")
    torch.cuda.synchronize()
    before_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_dit_int8(dit)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    after_gb = torch.cuda.memory_allocated() / 1e9
    n_q = sum(isinstance(m, QuantLinear) for m in dit.modules())
    if n_q != 6 * cfg.num_layers:
        fail("quantize_dit_int8 did not swap 6 linears a layer of the CogVideoX1.5-5B DiT")
    one = SamplerSettings(num_inference_steps=1, sampler="dpm", use_dynamic_cfg=True)

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise_loop(dit, text, negative, one, lat_shape, attn_impl="flash_int8",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    lat, step_s = run(155)  # [cog15]'s warm step's draws
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(lat.shape) != lat_shape or not bool(torch.isfinite(lat).all()):
        fail(f"[cog15-int8] latents {tuple(lat.shape)} not finite or not {lat_shape}")
    cos, rel = _cos_rel(lat.float().cpu(), exact["warm_latents"])
    log(f"[cog15-int8] quantize_dit_int8 in place: {n_q} linears in {quant_s:.2f} s, "
        f"allocated {before_gb:.2f} -> {after_gb:.2f} GB; "
        f"timed step {1e3 * step_s:.1f} ms, latents {tuple(lat.shape)} finite; against [cog15]'s "
        f"exact step on the same draws: cosine {cos:.6f}, rel-L2 {rel:.4f} (floor "
        f"{MAIN_INT8_COS_FLOOR}, ceiling {MAIN_INT8_REL_CEIL}); peak allocated {peak_gb:.2f} "
        f"GB; launches {json.dumps(launches)}; expected flash_attn_int8 {cfg.num_layers}, every "
        f"other 0")
    if not (cos > MAIN_INT8_COS_FLOOR and rel < MAIN_INT8_REL_CEIL):
        fail("the int8 CogVideoX1.5-5B step is far from the exact one")
    if launches != {**dict.fromkeys(launches, 0), "flash_attn_int8": cfg.num_layers}:
        fail("the int8 CogVideoX1.5-5B step did not run every attention through K8 alone")
    del dit
    torch.cuda.empty_cache()
    return {"launches": launches, "quantise_s": quant_s, "weights_gb": [before_gb, after_gb],
            "step_ms": 1e3 * step_s, "peak_gb": peak_gb,
            "drift_cos_rel": [cos, rel]}


# CogVideoX1.5-5B DPO training: [cog15_train] at the recipe's generator size
# (81f@768x1360: 21 latent frames of 96 x 170, trimmed to 20 by the step,
# (20 / 2) x 48 x 85 + 226 = 41,026 tokens a forward), [cog15_train_files]
# at the recipe's encoder size (81f@480x720: 21 latent frames of 60 x 90,
# 10 x 30 x 45 + 226 = 13,726 tokens)
COG15_TRAIN_LATENT = (1, 16, 21, 96, 170)  # (B, C, F, H, W)
COG15_FILES_LATENT = (16, 21, 60, 90)  # (C, F, H, W): train/CogVideoX1.5-5B/02_encode.py


def cog15_train_shape():
    """The attention shape of one forward of the CogVideoX1.5-5B train step:
    (1, 41,026, 48, 64)."""
    cfg, _, _ = cog15_shapes()
    _, _, F_, H, W = COG15_TRAIN_LATENT
    p, pt = cfg.patch_size, cfg.patch_size_t
    n = cfg.max_text_seq_length + (F_ // pt) * (H // p) * (W // p)
    return 1, n, cfg.num_heads, cfg.head_dim


def phase_parity_cog15_train(shape):
    """K1 with LSE and K3 at the CogVideoX1.5-5B train step's shape (1,
    41,026, 48, 64) against their plain versions over one head at a time,
    every head (a head's f32 score matrix is 6.7 GB; all 48 heads' 323 GB),
    at [parity]'s and [parity_bwd]'s tolerances; each kernel's ms beside its
    bound and one SDPA forward and backward of the same shape (a yardstick
    only). Returns K1's and K3's figures at the shape."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import flash_attn_bwd, flash_attn_fwd

    B, N, H, D = shape
    gen = torch.Generator(device="cuda").manual_seed(170)
    q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
    zero_launches()
    k1_err, k1_plain_ms = _parity_full(f"CogVideoX1.5-5B train shape {shape} with LSE", q, k, v,
                                       chunk=1)
    k3_worst, k3_plain_ms = _bwd_full("K3", f"CogVideoX1.5-5B train shape {shape}",
                                      flash_attn_fwd, flash_attn_bwd, q, k, v, "bnhd", gen,
                                      chunk=1)
    o, lse = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    k1 = {"shape_bnhd": list(shape), "max_abs_err": k1_err, "plain_ms": k1_plain_ms,
          "ms": cuda_ms(lambda: flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True), iters=3,
                        warmup=1)}
    k3 = {"shape_bnhd": list(shape), "max_abs_err": max(k3_worst), "plain_ms": k3_plain_ms,
          "max_abs_err_dq_dk_dv": k3_worst,
          "ms": cuda_ms(lambda: flash_attn_bwd(q, k, v, o, lse, do, layout="bnhd"), iters=3,
                        warmup=1)}
    launches = read_launches()
    # yardstick only: the port never calls SDPA
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        k1["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=3,
                                   warmup=1)
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    k3["library_ms"] = cuda_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), iters=3, warmup=1)
    k1["bound_ms"], k1["bound_by"] = _fwd_bound(B, N, N, H, D)
    k3["bound_ms"], k3["bound_by"] = _bwd_bound(B, N, H, D)
    k1["tflops"] = 4.0 * B * H * N * N * D / k1["ms"] / 1e9
    k3["tflops"] = 10.0 * B * H * N * N * D / k3["ms"] / 1e9
    for r in (k1, k3):
        r["x_bound"] = r["ms"] / r["bound_ms"]
    log(f"[parity_cog15_train] K1 with LSE at {shape}: {k1['ms']:.2f} ms (bound "
        f"{k1['bound_ms']:.2f}, {k1['bound_by']}; {k1['x_bound']:.2f}x; {k1['tflops']:.0f} "
        f"TFLOP/s), SDPA forward {k1['library_ms']:.2f} ms, plain version {k1_plain_ms:.1f} ms "
        f"over one head at a time; K3 {k3['ms']:.2f} ms (bound {k3['bound_ms']:.2f}, "
        f"{k3['bound_by']}; {k3['x_bound']:.2f}x; {k3['tflops']:.0f} TFLOP/s), SDPA backward "
        f"{k3['library_ms']:.2f} ms, plain version {k3_plain_ms:.1f} ms; launches of the "
        f"comparisons and timings {json.dumps({n: c for n, c in launches.items() if c})}")
    del q, k, v, o, lse, do, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return {"k1": k1, "k3": k3, "launches": launches}


def phase_slice_dpo_cog15() -> dict:
    """One DPO step of a small CogVideoX1.5 DiT (``small_cog15_config``),
    bf16 on the card against f32 on the CPU on the same weights and draws,
    as [slice_dpo]: latents of 5 frames of 63 x 77, which the step trims to
    4 frames of 62 x 76 (2 x 31 x 38 patches, a grid under the 2 x 32 x 40
    of the sample size; 2,364 tokens with the text, past K4's 2,048, so K1
    and K3 run). Returns the card's launches and the errors."""
    import torch

    from videogpa_torch.models.cogvideox import dit_init
    from videogpa_torch.train.lora import lora_init

    cfg = small_cog15_config()
    ref = dit_init(cfg, torch.Generator().manual_seed(172), device="cpu").requires_grad_(False)
    dev = dit_init(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    dev.load_state_dict({k: v.to(torch.bfloat16) for k, v in ref.state_dict().items()})
    gen = torch.Generator().manual_seed(173)
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, 4, gen, device="cpu")
    with torch.no_grad():
        for ab in lora.values():
            ab["lora_B"].normal_(0.0, 0.1, generator=gen)  # every adapter live
    F_, H, W = 5, 63, 77
    shape = (2, cfg.vae_latent_channels, F_, H, W)
    trimmed = (F_ - F_ % cfg.patch_size_t, H - H % cfg.patch_size, W - W % cfg.patch_size)
    tokens = (cfg.max_text_seq_length + trimmed[0] // cfg.patch_size_t
              * (trimmed[1] // cfg.patch_size) * (trimmed[2] // cfg.patch_size))
    batch = {"x_win": torch.randn(shape, generator=gen), "x_lose": torch.randn(shape, generator=gen),
             "prompt_emb": torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim,
                                       generator=gen)}
    draws = {"timesteps": torch.tensor([150, 800]),
             "noise": torch.randn((2, trimmed[0], cfg.vae_latent_channels) + trimmed[1:],
                                  generator=gen)}
    lora_dev = {n: {k: t.detach().to("cuda", copy=True) for k, t in ab.items()}
                for n, ab in lora.items()}
    m_cpu, g_cpu, l_cpu = _tiny_dpo_step(ref, cfg, lora, batch, draws, torch.float32)
    zero_launches()
    m_dev, g_dev, l_dev = _tiny_dpo_step(
        dev, cfg, lora_dev, {k: v.cuda() for k, v in batch.items()},
        {k: v.cuda() for k, v in draws.items()}, torch.bfloat16)
    launches = read_launches()
    grad_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_dev, g_cpu))
    loss_err = abs(m_dev["loss"] - m_cpu["loss"])
    upd_err = max((l_dev[n][k] - l_cpu[n][k]).abs().max().item()
                  for n in l_cpu for k in l_cpu[n])
    L = cfg.num_layers
    # two calls (accumulate 2): 6 forwards (2 policy, their 2 recomputes, 2
    # reference) and 2 backwards a layer each
    want = {**dict.fromkeys(launches, 0), "flash_attn_fwd": 2 * 6 * L, "flash_attn_bwd": 2 * 2 * L}
    log(f"[slice_dpo_cog15] small CogVideoX1.5 DPO step (patch_size_t 2, latents {shape} "
        f"trimmed to {trimmed}, {tokens} tokens) bf16 on the card vs f32 on the CPU: loss "
        f"{m_dev['loss']:.6f} vs {m_cpu['loss']:.6f} (|d| {loss_err:.2e}, limit "
        f"{DPO_LOSS_ATOL}), grad_norm {m_dev['grad_norm']:.4e} vs {m_cpu['grad_norm']:.4e}, "
        f"LoRA gradients max rel-norm error {grad_rel:.3e} (limit {DPO_GRAD_REL}), updated LoRA "
        f"max|d| {upd_err:.2e} (limit 2.5 x lr = 2.5e-3); launches "
        f"{json.dumps({n: c for n, c in launches.items() if c})}, expected "
        f"{json.dumps({n: c for n, c in want.items() if c})}")
    finite = all(math.isfinite(v) for v in m_dev.values())
    if not (finite and loss_err <= DPO_LOSS_ATOL and grad_rel <= DPO_GRAD_REL
            and upd_err <= 2.5e-3):
        fail("the small CogVideoX1.5 DPO step on the card disagrees with the CPU reference")
    if launches != want:
        fail("the small CogVideoX1.5 DPO step did not run its attention through K1 and K3")
    return {"launches": launches, "tokens": tokens, "loss_err": loss_err, "grad_rel": grad_rel,
            "update_err": upd_err}


def phase_cog15_train(dit, reckonings, steps: int = 2):
    """The CogVideoX1.5-5B DPO LoRA train step at full width and depth on
    [cog15]'s resident DiT: ``make_dpo_train_step`` with the recipe's
    ``TrainerConfig`` (``cli.train_dpo``'s mapping of the recipe: batch 1,
    accumulate 1, LoRA r 64 / alpha 128, remat, bf16, warmup 500, clip 1.0)
    on synthetic (1, 16, 21, 96, 170) latents (trimmed to 20 frames by the
    step: 41,026 tokens) and a (1, 226, 4,096) prompt embedding; ``steps``
    steps, each an optimiser update, the first profiled. Checks finite
    metrics, grad_norm > 0, the updates, K1 252 and K3 84 launches a step and
    no other, and the peak against the reckoning of the same step
    (``train.memory``) and the card's memory."""
    import torch

    from videogpa_torch.cli.train_dpo import _tcfg
    from videogpa_torch.train.lora import lora_init, lora_leaves
    from videogpa_torch.train.recipes import default_config
    from videogpa_torch.train.trainer import init_train_state, make_dpo_train_step

    cfg, _, _ = cog15_shapes()
    tcfg = _tcfg(default_config("CogVideoX1.5-5B"))
    gen = torch.Generator(device="cuda").manual_seed(174)
    batch = {"x_win": torch.randn(COG15_TRAIN_LATENT, generator=gen, device="cuda"),
             "x_lose": torch.randn(COG15_TRAIN_LATENT, generator=gen, device="cuda"),
             "prompt_emb": torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim,
                                       generator=gen, device="cuda")}
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, tcfg.lora_rank,
                     torch.Generator(device="cuda").manual_seed(175), device="cuda")
    n_lora = sum(t.numel() for t in lora_leaves(lora))
    state = init_train_state(lora, tcfg)
    train_step, _ = make_dpo_train_step(dit, cfg, tcfg)
    _, n, _, _ = cog15_train_shape()
    log(f"[cog15_train] CogVideoX1.5-5B DPO on [cog15]'s DiT ({cfg.num_layers} layers, no depth "
        f"cut), recipe CogVideoX1.5-5B: accumulate {tcfg.accumulate_grad_batches}, LoRA r "
        f"{tcfg.lora_rank} / alpha {tcfg.lora_alpha} ({n_lora / 1e6:.2f} M f32 params), lr "
        f"{tcfg.learning_rate}, warmup {tcfg.warmup_steps}, max {tcfg.max_steps}, clip "
        f"{tcfg.gradient_clip_val}, beta {tcfg.beta}, remat {tcfg.remat}, "
        f"{tcfg.compute_dtype}; latents {COG15_TRAIN_LATENT} (trimmed to 20 frames: {n:,} "
        f"tokens), prompt_emb {tuple(batch['prompt_emb'].shape)}; resident "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.num_layers
    per_step = {"flash_attn_fwd": 6 * L, "flash_attn_bwd": 2 * L}
    b_norms, step_ms, metrics_log, launches, profile = [], [], [], None, None
    for i in range(steps):
        draws = torch.Generator(device="cuda").manual_seed(176 + i)
        zero_launches()
        (_, metrics), ms, prof = _timed_step(
            lambda: train_step(state, batch, generator=draws),
            "one CogVideoX1.5-5B train step (the first, profiled)" if i == 0 else None)
        profile = prof if i == 0 else profile
        got = read_launches()
        launches = got if launches is None else {k: launches[k] + got[k] for k in got}
        step_ms.append(ms)
        m = {k: float(v) for k, v in metrics.items()}
        metrics_log.append(m)
        b_norms.append(sum(float(ab["lora_B"].detach().abs().max())
                           for ab in state.lora.values()))
        log(f"[cog15_train] step {i + 1}{' (profiled)' if i == 0 else ''}: {step_ms[-1]:.1f} ms, "
            + json.dumps(m) + f", max|LoRA B| summed over targets {b_norms[-1]:.3e}, launches "
            + json.dumps({k: c for k, c in got.items() if c}))
        if got != {**dict.fromkeys(got, 0), **per_step}:
            fail(f"[cog15_train] step {i + 1} launched {got}, not K1 {per_step['flash_attn_fwd']} "
                 f"and K3 {per_step['flash_attn_bwd']} alone")
    measured = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    reckoned = check_reckoning("[cog15_train]", reckonings.get("cog15_train"), measured)
    log(f"[cog15_train] {steps} steps (updates): {', '.join(f'{t:.1f}' for t in step_ms)} ms; "
        f"peak allocated {measured / 1e9:.2f} GB of the card's {total / 1e9:.2f} GB; remat "
        f"residual {reckoned['residual_gib']:.3f} GiB, {reckoned['block_residual_bytes']:,} B a "
        f"block at {reckoned['tokens']:,} tokens; launches a step: 6 forwards (2 policy, 2 remat "
        f"recomputes, 2 reference) and 2 backwards of {L} layers")
    if not all(math.isfinite(v) for m in metrics_log for v in m.values()):
        fail("[cog15_train] non-finite train metrics")
    if not all(m["grad_norm"] > 0 for m in metrics_log):
        fail("[cog15_train] a step's gradients are zero")
    check_update("[cog15_train]", state, b_norms, steps, accumulate=tcfg.accumulate_grad_batches)
    if measured >= total:
        fail("[cog15_train] the step does not fit the card")
    del state, lora, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "step_ms": step_ms,
            "peak_gb": measured / 1e9, "reckoned": reckoned, "profile": profile,
            "metrics": metrics_log, "tokens": n}


def phase_cog15_train_files(dit, steps: int = 2):
    """The recipe's entry from files: ``run_recipe("CogVideoX1.5-5B",
    config)`` on ``meta_data.json`` groups whose latents have the recipe
    encoder's shape (16, 21, 60, 90) (13,726 tokens a forward after the
    trim) and (226, 4,096) conditions as ``.npz``, ``load_cogvideox``
    handed [cog15]'s resident DiT: ``steps`` steps with validation on 1
    pair and a checkpoint at the last step, then a resume to ``steps + 1``.
    The exported ``final_lora`` is read back by ``import_peft`` and held
    against the last checkpoint's LoRA, then merged into the DiT by the
    generator's own path (``cli.generate.CogVideoXGenerator`` with
    ``load_models`` handing it the resident DiT, the recipe's absolute 0.2
    from ``parse_args``): block 0's merged to_q against W + 0.2 B A. The
    DiT's weights are put back after."""
    import shutil

    import torch

    import videogpa_torch.cli.train_dpo as train_cli
    from videogpa_torch.cli import generate
    from videogpa_torch.train.lora import TARGETS, import_peft
    from videogpa_torch.train.recipes import build_config, run_recipe

    cfg, _, _ = cog15_shapes()
    _, F_, H, W = COG15_FILES_LATENT
    p, pt = cfg.patch_size, cfg.patch_size_t
    tokens = cfg.max_text_seq_length + (F_ - F_ % pt) // pt * (H // p) * (W // p)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cog15_train_files")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    _write_preference_dataset(data_dir, COG15_FILES_LATENT,
                              (cfg.max_text_seq_length, cfg.text_embed_dim), seed=177)
    config = build_config("CogVideoX1.5-5B", base_path=data_dir)
    # random weights: every group's winner and loser by its score, whatever
    # the gap; a warmup shorter than the run (the schedule needs max_steps >
    # warmup)
    config.update(output_dir=os.path.join(root, "out"), max_steps=steps,
                  checkpoint_every_n_steps=steps, log_every_n_steps=1, seed=0,
                  metric_threshold=None, min_gap=0.0, motion_threshold=0.0, warmup_steps=1)
    log(f"[cog15_train_files] 2 groups of 2 videos, latents {COG15_FILES_LATENT} ({tokens:,} "
        f"tokens a forward after the trim) and conditions ({cfg.max_text_seq_length}, "
        f"{cfg.text_embed_dim}) as .npz; recipe CogVideoX1.5-5B (batch {config['batch_size']}, "
        f"accumulate {config.get('accumulate_grad_batches', 1)}, LoRA r {config['lora_rank']}, "
        f"lr {config['learning_rate']}), max_steps {steps}, checkpoint every {steps}; "
        f"load_cogvideox is handed [cog15]'s resident DiT")
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
            run_recipe("CogVideoX1.5-5B", config)
            torch.cuda.synchronize()
            out[f"{tag}_s"] = time.perf_counter() - t0
            out[f"{tag}_launches"] = read_launches()
            out[f"{tag}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        train_cli.load_cogvideox = real_load
    with open(os.path.join(root, "out", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    steps_seen = [r["step"] for r in train]
    log(f"[cog15_train_files] metrics.jsonl train records: " + json.dumps(
        [{k: r[k] for k in ("step", "time", "train/loss", "train/grad_norm",
                            "stats/samples_per_sec", "stats/max_memory_gb")} for r in train]))
    if steps_seen != list(range(1, steps + 2)):
        fail(f"train_dpo took steps {steps_seen}, expected 1..{steps} then {steps + 1} resumed")
    if not all(math.isfinite(r["train/loss"]) for r in train):
        fail("[cog15_train_files] non-finite train loss")
    L = cfg.num_layers
    want_run = {"flash_attn_fwd": steps * 6 * L + 4 * L, "flash_attn_bwd": steps * 2 * L}
    want_resume = {"flash_attn_fwd": 6 * L + 4 * L, "flash_attn_bwd": 2 * L}
    for tag, want in (("run", want_run), ("resume", want_resume)):
        got = {k: v for k, v in out[f"{tag}_launches"].items() if v}
        log(f"[cog15_train_files] {tag}: {out[f'{tag}_s']:.1f} s, peak "
            f"{out[f'{tag}_peak_gb']:.2f} GB, launches {json.dumps(got)}; expected "
            f"{json.dumps(want)} (6 forwards and 2 backwards of {L} layers a step, 4 forwards a "
            f"validation pair)")
        if got != want:
            fail(f"run_recipe CogVideoX1.5-5B ({tag}) did not run every attention through K1 "
                 "and K3")
    kept = sorted(json.load(open(os.path.join(root, "out", "checkpoints", "scores.json"))))
    state = torch.load(os.path.join(root, "out", "checkpoints", kept[-1], "state.pt"),
                       weights_only=True)
    final = os.path.join(root, "out", "final_lora")
    lora = import_peft(final, L, device="cpu")
    same = state["step"] == steps + 1 and all(
        torch.equal(lora[n][k], state["lora"][n][k]) for n in state["lora"]
        for k in ("lora_A", "lora_B"))
    log(f"[cog15_train_files] checkpoints kept {kept}; import_peft(final_lora) equals the "
        f"trained LoRA of step {state['step']}: {same}")
    if not same:
        fail("the exported CogVideoX1.5-5B LoRA is not the trained one")

    # the user's next step: the generator merges the adapter at the recipe's
    # absolute 0.2 into the DiT it loads (here the resident one)
    originals = [[getattr(blk.attn1, t).weight.clone() for t in TARGETS] for blk in dit.blocks]
    args = generate.parse_args(["--recipe", "CogVideoX1.5-5B", "--prompt_json", "unused",
                                "--output_dir", root, "--lora_path", final])
    recipe = generate._RECIPES[args.recipe]
    real_models = generate.load_models
    generate.load_models = lambda base_model, cfg_, device: (dit, None, None, None, None)
    try:
        generate.CogVideoXGenerator(args, cfg, i2v=recipe.get("i2v", False),
                                    dynamic_cfg=recipe.get("dynamic_cfg", False),
                                    lora_weight=args.lora_weight,
                                    absolute_lora=recipe.get("absolute_lora", False),
                                    device="cuda")
    finally:
        generate.load_models = real_models
    w0 = originals[0][TARGETS.index("to_q")]
    merged = dit.blocks[0].attn1.to_q.weight
    a, b = (lora["to_q"][k][0].cuda() for k in ("lora_A", "lora_B"))
    delta = 0.2 * (b @ a)
    want = w0.float() + delta
    # two bf16 roundings: the delta's and the sum's, each within 2^-8 relative
    err = (merged.float() - want).abs()
    ok = bool((err <= 2.0 ** -8 * (want.abs() + delta.abs()) + 1e-30).all())
    changed = int((merged != w0).sum())
    with torch.no_grad():
        for blk, ws in zip(dit.blocks, originals):
            for t, w in zip(TARGETS, ws):
                getattr(blk.attn1, t).weight.copy_(w)
    log(f"[cog15_train_files] the generator (--recipe CogVideoX1.5-5B, --lora_weight "
        f"{args.lora_weight} absolute) merged final_lora: block 0 to_q against W + "
        f"{args.lora_weight} B A: max|d| {err.max().item():.3e} within two bf16 roundings: {ok}; "
        f"{changed:,} of {merged.numel():,} weights changed (|0.2 B A| up to "
        f"{delta.abs().max().item():.3e}); the DiT's weights put back")
    if not (ok and changed > 0 and args.lora_weight == 0.2):
        fail("the generator did not merge the trained CogVideoX1.5-5B LoRA at 0.2")
    step_s = train[1]["time"] - train[0]["time"]
    out.update(step_ms=1e3 * step_s, samples_per_sec=[r["stats/samples_per_sec"] for r in train],
               max_memory_gb=[r["stats/max_memory_gb"] for r in train], steps=steps_seen,
               tokens=tokens, per_step={"flash_attn_fwd": 6 * L, "flash_attn_bwd": 2 * L},
               merge_max_abs_err=err.max().item(), merge_changed=changed)
    del state, lora, originals, merged, w0, want, err, delta, a, b
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out


class _TimedSampling:
    """``pipeline.denoise_loop`` and ``pipeline.decode_latents`` timed for
    the length of a ``with`` (``sample_t2v`` calls both through the module),
    the decode's tile logged; ``latent_frames`` decodes only that many
    leading latent frames (a temporal cut)."""

    def __init__(self, latent_frames=None):
        self.latent_frames, self.timing = latent_frames, {"tile_log": []}

    def __enter__(self):
        import torch

        from videogpa_torch.models.cogvideox import pipeline

        self.real = pipeline.denoise_loop, pipeline.decode_latents

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            self.timing[key] = time.perf_counter() - t0
            return out

        def loop(*a, **kw):
            out = timed("denoise_s", lambda: self.real[0](*a, **kw))
            self.timing["latents"] = tuple(out.shape)
            return out

        def decode(vae, latents, cfg, log=print):
            if self.latent_frames is not None:
                latents = latents[:, :self.latent_frames]
            return timed("decode_s", lambda: self.real[1](vae, latents, cfg,
                                                          log=self.timing["tile_log"].append))

        pipeline.denoise_loop, pipeline.decode_latents = loop, decode
        return self

    def __exit__(self, *exc):
        from videogpa_torch.models.cogvideox import pipeline

        pipeline.denoise_loop, pipeline.decode_latents = self.real
        return False


def phase_cog15_sample(steps: int = 1, decode_latent_frames=2, generate_steps: int = 1):
    """CogVideoX1.5-5B sampling at full size with the DiT ([cog15]'s weights,
    drawn again), T5-v1.1-XXL (f32) and the VAE (bf16) resident: T5 encodes a
    prompt and the empty negative (2 x 226 ids); ``sample_t2v`` runs
    ``steps`` DPM steps with dynamic CFG at 81f@768x1360 (latents rounded up
    to 22 frames), ``decode_latents`` decodes its ``decode_latent_frames``
    leading latent frames (a temporal cut; None decodes all 22, ~85 s a
    run) and ``video_to_uint8`` makes the frames. Then the user's entry,
    ``cli.generate.main --recipe CogVideoX1.5-5B`` (81f@768x1360, dynamic CFG,
    --lora_weight 0.2 as the absolute LoRA scaling, ``generate_steps`` DPM
    steps, the same leading latent frames decoded) on one prompt with a
    random PEFT LoRA written to disk, its
    models the resident ones (``generate.load_models`` replaced; the
    tokenizer a seeded stub) and the mp4 writer keeping the frames.
    Checks the videos' shapes and range, K1's launches (42 a step, every
    other kernel 0) and the merge (the fitted scale of the to_q deltas)."""
    import shutil

    import torch

    from videogpa_torch.cli import generate
    from videogpa_torch.data import video_io
    from videogpa_torch.models.cogvideox import (
        SamplerSettings, sample_t2v, vae_init, video_to_uint8)
    from videogpa_torch.models.t5 import T5Config, t5_encode, t5_encoder_init
    from videogpa_torch.train.lora import export_peft, lora_init

    cfg, lat_shape, _ = cog15_shapes()
    frames_n, height, width = COG15_VIDEO
    t5_cfg = T5Config.t5_v1_1_xxl()
    torch.cuda.empty_cache()
    log(f"[cog15_sample] resident before the phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    dit, _ = _cog15_dit(cfg)
    t5 = t5_encoder_init(t5_cfg, torch.Generator(device="cuda").manual_seed(159), device="cuda")
    vae = vae_init(cfg, torch.Generator(device="cuda").manual_seed(160), device="cuda",
                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ids = torch.randint(0, t5_cfg.vocab_size, (2, cfg.max_text_seq_length),
                        generator=torch.Generator().manual_seed(161))
    ids[1, 1:] = 0  # the empty negative prompt: EOS then padding, as the tokenizer gives it
    zero_launches()
    with torch.no_grad():
        t5_encode(t5, ids.cuda())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = t5_encode(t5, ids.cuda())
        torch.cuda.synchronize()
    t5_ms = 1e3 * (time.perf_counter() - t0)
    if not bool(torch.isfinite(emb).all()):
        fail("[cog15_sample] T5 embeddings are not finite")

    # the decoded video has every latent frame's: 4 (22 - 1) + 1 = 85 frames
    # for the 81 asked, as in the JAX package (its decode keeps them all)
    decoded = lat_shape[1] if decode_latent_frames is None else decode_latent_frames
    want_t = (decoded - 1) * cfg.temporal_compression_ratio + 1
    settings = SamplerSettings(num_inference_steps=steps, sampler="dpm", use_dynamic_cfg=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _TimedSampling(decode_latent_frames) as timed:
        video = sample_t2v(dit, vae, emb[:1], emb[1:], cfg, num_frames=frames_n, height=height,
                           width=width, settings=settings,
                           generator=torch.Generator(device="cuda").manual_seed(162))
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = video_to_uint8(video)
    sample = {"t5_ms": t5_ms, "step_ms": 1e3 * timed.timing["denoise_s"] / steps,
              "decode_ms": 1e3 * timed.timing["decode_s"], "tile_log": timed.timing["tile_log"],
              "latents": timed.timing["latents"], "decoded_latent_frames": decoded,
              "frames": int(video.shape[2]), "total_s": total_s, "peak_gb": peak_gb}
    log(f"[cog15_sample] t5_encode 2 x {cfg.max_text_seq_length} ids {t5_ms:.1f} ms; sample_t2v "
        f"{frames_n}f@{height}x{width}: {steps} DPM steps (dynamic CFG) in "
        f"{timed.timing['denoise_s']:.3f} s ({sample['step_ms']:.1f} ms a step), latents "
        f"{timed.timing['latents']}, decode_latents of {decoded} latent frames "
        f"{sample['decode_ms']:.1f} ms ({'; '.join(timed.timing['tile_log'])}), total "
        f"{total_s:.3f} s; video {tuple(video.shape)}: {video.shape[2]} frames for the "
        f"{frames_n} asked, uint8 frames {frames.shape}; peak {peak_gb:.2f} GB with the DiT, T5 "
        f"and VAE resident; launches {json.dumps(launches)}")
    if (tuple(video.shape) != (1, 3, want_t, height, width)
            or not bool(torch.isfinite(video).all()) or float(video.abs().max()) > 1.0
            or frames.shape != (1, want_t, height, width, 3)):
        fail(f"sample_t2v's video is not finite in [-1, 1] at {want_t}f@{height}x{width}")
    if launches != {**dict.fromkeys(launches, 0), "flash_attn_fwd": steps * cfg.num_layers}:
        fail("the CogVideoX1.5-5B sampling path's launches are not K1's alone")
    sample_launches = launches
    del video, frames, emb

    # the user's entry: cli.generate --recipe CogVideoX1.5-5B around the
    # resident models, with a random LoRA written as a PEFT adapter
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cog15_sample")
    shutil.rmtree(root, ignore_errors=True)
    lora_gen = torch.Generator(device="cuda").manual_seed(163)
    lora = lora_init(cfg.num_layers, cfg.hidden_dim, 64, lora_gen, device="cuda")
    for ab in lora.values():  # PEFT starts B at 0; give it values so the merge shows
        ab["lora_B"].data.normal_(0.0, 0.1, generator=lora_gen)
    export_peft(lora, os.path.join(root, "lora"), rank=64, alpha=128.0)
    with open(os.path.join(root, "prompts.json"), "w") as f:
        json.dump({"fox": "a red fox trotting through fresh snow at dawn"}, f)
    w_before = dit.blocks[0].attn1.to_q.weight.float().clone()
    written = {}

    def memory_writer(path, frames, fps=8):
        written[path] = (frames, fps)
        open(path, "wb").close()

    def resident(base_model, cfg_, device):
        return dit, vae, t5, t5_cfg, _StubTokenizer(t5_cfg.vocab_size, seed=164)

    real = (generate.load_models, video_io.write_video, generate.CogVideoXGenerator.encode_prompt)
    encode_ms = []

    def timed_encode(self, prompt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[2](self, prompt)
        torch.cuda.synchronize()
        encode_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    generate.load_models, video_io.write_video = resident, memory_writer
    generate.CogVideoXGenerator.encode_prompt = timed_encode
    argv = ["--recipe", "CogVideoX1.5-5B", "--prompt_json", os.path.join(root, "prompts.json"),
            "--output_dir", os.path.join(root, "out"), "--lora_path", os.path.join(root, "lora"),
            "--num_inference_steps", str(generate_steps), "--seed", "42"]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _TimedSampling(decode_latent_frames) as timed:
            generate.main(argv, device="cuda")
            torch.cuda.synchronize()
    finally:
        generate.load_models, video_io.write_video = real[:2]
        generate.CogVideoXGenerator.encode_prompt = real[2]
    gen_s = time.perf_counter() - t0
    gen_launches = read_launches()
    gen_peak = torch.cuda.max_memory_allocated() / 1e9
    delta = dit.blocks[0].attn1.to_q.weight.float() - w_before
    ba = (lora["to_q"]["lora_B"][0] @ lora["to_q"]["lora_A"][0]).detach()
    scale = ((delta * ba).sum() / ba.square().sum()).item()
    resid = ((delta - scale * ba).norm() / (scale * ba).norm()).item()
    if len(written) != 1:
        fail(f"cli.generate --recipe CogVideoX1.5-5B wrote {len(written)} videos, not 1")
    (path, (vid, fps)), = written.items()
    gen_run = {"s": gen_s, "encode_ms": encode_ms,
               "step_ms": 1e3 * timed.timing["denoise_s"] / generate_steps,
               "decode_ms": 1e3 * timed.timing["decode_s"], "tile_log": timed.timing["tile_log"],
               "frames": int(vid.shape[0]), "fps": fps, "peak_gb": gen_peak,
               "lora_scale_fitted": scale, "lora_residual": resid}
    log(f"[cog15_sample] cli.generate.main --recipe CogVideoX1.5-5B ({generate_steps} DPM "
        f"steps, cut from 50; --lora_weight 0.2 absolute, PEFT r 64 / alpha 128 from disk) around the "
        f"resident DiT, T5 and VAE: {gen_s:.3f} s, wrote {os.path.relpath(path, root)} at fps "
        f"{fps}: {vid.shape} {vid.dtype}; encode_prompt {encode_ms} ms, "
        f"{gen_run['step_ms']:.1f} ms a step, decode {gen_run['decode_ms']:.1f} ms "
        f"({'; '.join(timed.timing['tile_log'])}); peak {gen_peak:.2f} GB; block 0 to_q's "
        f"merged delta against B A: fitted scale {scale:.5f} (recipe 0.2, alpha / r 2.0), "
        f"residual {resid:.4f}; launches {json.dumps(gen_launches)}")
    if vid.shape != (want_t, height, width, 3) or str(vid.dtype) != "uint8" or fps != 16:
        fail(f"the recipe's video is {vid.shape} {vid.dtype} at fps {fps}, not "
             f"({want_t}, {height}, {width}, 3) uint8 at 16")
    if not (abs(scale - 0.2) < 2e-3 and resid < 0.1):
        fail("the recipe did not merge the LoRA at the absolute scaling 0.2")
    if gen_launches != {**dict.fromkeys(gen_launches, 0),
                        "flash_attn_fwd": generate_steps * cfg.num_layers}:
        fail("the recipe's sampling path's launches are not K1's alone")
    shutil.rmtree(root)
    del dit, t5, vae, lora, written, vid
    torch.cuda.empty_cache()
    return {"sample": sample, "generate": gen_run, "sample_launches": sample_launches,
            "generate_launches": gen_launches}


def _da3_mono_config(cfg):
    """A mono config of ``cfg``'s widths: alternating attention off, four of
    its eight blocks tapped."""
    import dataclasses

    return dataclasses.replace(cfg, alt_start=-1, out_layers=(1, 3, 5, 7))


def _gs_scene(N: int, seed: int, tied: bool):
    """N gaussians in front of the cameras; ``tied``: every depth equal."""
    import numpy as np

    from videogpa_torch.models.da3 import Gaussians

    rng = np.random.default_rng(seed)
    z = np.full(N, 2.0) if tied else rng.uniform(1.5, 3.0, N)
    quats = rng.normal(size=(N, 4))
    return Gaussians(
        means=np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.45, 0.45, N), z], -1)[None]
        .astype(np.float32),
        harmonics=rng.normal(size=(1, N, 3, 1)).astype(np.float32),
        opacities=rng.uniform(0.3, 0.95, (1, N)).astype(np.float32),
        scales=rng.uniform(0.01, 0.05, (1, N, 3)).astype(np.float32),
        rotations=(quats / np.linalg.norm(quats, axis=-1, keepdims=True))[None].astype(np.float32))


def phase_slice_da3_nested() -> None:
    """The tiny DA3 (4 views) and the small one (6 views at 280^2, heads of
    64), each with a mono net of its widths, a GSDPT head and a gaussian
    scene, in f32 on the card against the same weights on the CPU: the mono
    forward's depth and sky, ``nested_inference``'s depth, conf, extrinsics,
    scale factor and selected reference view, GSDPT on the CPU trunk's
    features, and ``render_3dgs`` at random and at tied depths (the pick
    among equal depths in ``lax.top_k``'s order), each by rel-norm."""
    import copy

    import numpy as np
    import torch

    from videogpa_torch.models.da3 import (
        DA3Config, da3_init, gsdpt_forward, gsdpt_init, mono_forward, mono_init,
        nested_inference, render_3dgs)
    from videogpa_torch.models.da3 import vit

    real_select = vit.select_reference_view
    picks = []

    def spy(x, strategy="saddle_balanced"):
        idx = real_select(x, strategy)
        picks.append(idx.cpu().tolist())
        return idx

    for tag, cfg, S in (("tiny", DA3Config.tiny(), 4), ("small", small_da3_config(), 6)):
        mcfg = _da3_mono_config(cfg)
        av_ref = da3_init(cfg, torch.Generator().manual_seed(80), device="cpu")
        regular_da3_camera_(av_ref)
        m_ref = mono_init(mcfg, torch.Generator().manual_seed(81), device="cpu")
        gs_ref = gsdpt_init(cfg, generator=torch.Generator().manual_seed(82), device="cpu")
        av_dev, m_dev, gs_dev = (copy.deepcopy(m).to("cuda") for m in (av_ref, m_ref, gs_ref))
        frames = synthetic_frames(1, S, cfg.img_size, seed=83)[0]
        x = _normalised([frames])
        rel = {}
        with torch.no_grad():
            want = mono_forward(m_ref, x)
            zero_launches()
            got = mono_forward(m_dev, x.cuda())
            torch.cuda.synchronize()
            mono_launches = {k: v for k, v in read_launches().items() if v}
            rel.update({f"mono_{k}": _rel(got[k], want[k]) for k in ("depth", "sky")})

            picks.clear()
            vit.select_reference_view = spy
            try:
                want_n = nested_inference(av_ref, m_ref, frames, compute_dtype=torch.float32)
                got_n = nested_inference(av_dev, m_dev, frames, compute_dtype=torch.float32)
            finally:
                vit.select_reference_view = real_select
            rel.update({f"nested_{k}": _rel(torch.from_numpy(getattr(got_n, k)),
                                            torch.from_numpy(getattr(want_n, k)))
                        for k in ("depth", "conf", "extrinsics")})
            rel["nested_scale_factor"] = abs(got_n.scale_factor / want_n.scale_factor - 1)

            feats = vit.aavit_forward(av_ref.backbone, x)
            imgs = torch.from_numpy(frames).permute(0, 3, 1, 2)[None].float() / 255
            want_g = gsdpt_forward(gs_ref, feats, imgs)
            got_g = gsdpt_forward(gs_dev, [(t.cuda(), c.cuda()) for t, c in feats], imgs.cuda())
            rel.update({f"gsdpt_{k}": _rel(g, w)
                        for k, g, w in zip(("raw", "opacity"), got_g, want_g)})

        rng = np.random.default_rng(84)
        extr = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        extr[:, :3, 3] = rng.normal(size=(2, 3)) * 0.05
        W, H = 96, 64
        intr = np.tile(np.array([[60.0 / W, 0, 0.5], [0, 60.0 / H, 0.5], [0, 0, 1]], np.float32),
                       (2, 1, 1))
        for scene in ("random", "tied"):
            g = _gs_scene(4000, seed=85, tied=scene == "tied")
            want_r = render_3dgs(extr, intr, (H, W), g, max_per_tile=32, device="cpu")
            got_r = render_3dgs(extr, intr, (H, W), g, max_per_tile=32, device="cuda")
            rel.update({f"render_{scene}_{k}": _rel(a, b)
                        for k, a, b in zip(("color", "depth"), got_r, want_r)})
        log(f"[slice_da3_nested] {tag} ({cfg.img_size}^2, {S} views; mono {mcfg.depth} blocks "
            f"of {mcfg.num_heads} x {mcfg.embed_dim // mcfg.num_heads}) f32 card vs CPU, "
            f"rel-norm " + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
            + f" (limit {DA3_F32_REL}); scale factor CPU {want_n.scale_factor:.6f}, card "
            f"{got_n.scale_factor:.6f}; reference views CPU {picks[0]}, card {picks[1]}; mono "
            f"launches {json.dumps(mono_launches)}")
        if picks[0] != picks[1]:
            fail(f"the {tag} nested DA3 selected other reference views on the card")
        if max(rel.values()) > DA3_F32_REL or not (
                np.isfinite(got_n.depth).all() and got_n.scale_factor > 0):
            fail(f"the {tag} mono / nested / GSDPT / renderer on the card disagrees with the CPU")
        if mono_launches != {"flash_attn_fwd_f32": max(mcfg.out_layers) + 1}:
            fail(f"the {tag} f32 mono net did not run its blocks through K6 f32")
        del av_ref, m_ref, gs_ref, av_dev, m_dev, gs_dev
    torch.cuda.empty_cache()


def _giant_launches(any_cfg, met_cfg) -> dict:
    """K1 and K4 launches of one nested call: the anyview branch's odd
    alternating blocks attend over the clip, its other blocks and every
    metric block within a frame."""
    alt = range(any_cfg.alt_start, any_cfg.depth)
    n_global = sum(i % 2 for i in alt)
    return {"flash_attn_fwd": n_global,
            "flash_attn_short": any_cfg.depth - n_global + max(met_cfg.out_layers) + 1}


def phase_da3_nested(calls: int = 2):
    """``nested_inference`` on ``da3nested-giant-large`` at full width and
    depth on random weights: DA3-Giant (40 blocks at 1,536, 24 heads x 64,
    SwiGLU, DualDPT 256 / (256, 512, 1,024, 1,024)) and the metric DA3-Large
    (24 plain blocks at 1,024, the sky DPT), bf16 trunks, f32 heads, one
    scene of 10 frames at 518^2; 1 cold and ``calls`` warm calls. Each call:
    the anyview, metric and host-alignment ms, peak GB, launches (exactly K1
    14 and K4 26 + 24), a finite scale factor > 0, finite depths and
    extrinsics."""
    import numpy as np
    import torch

    from videogpa_torch.models.da3 import DA3Config, da3_init, mono_init, nested_inference
    from videogpa_torch.utils.timing import StageTimer

    any_cfg, met_cfg = DA3Config.from_name("da3nested-giant-large")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anyview = da3_init(any_cfg, torch.Generator(device="cuda").manual_seed(90), device="cuda",
                       dtype=torch.bfloat16)
    regular_da3_camera_(anyview)
    metric = mono_init(met_cfg, torch.Generator(device="cuda").manual_seed(91), device="cuda",
                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_any = sum(p.numel() for p in anyview.parameters())
    n_met = sum(p.numel() for p in metric.parameters())
    frames = synthetic_frames(1, 10, any_cfg.img_size, seed=92)[0]
    want = dict.fromkeys(read_launches(), 0)
    want.update(_giant_launches(any_cfg, met_cfg))
    runs, total = [], dict.fromkeys(want, 0)
    for c in range(1 + calls):
        timer = StageTimer(sync=torch.cuda.synchronize)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        pred = nested_inference(anyview, metric, frames, timer=timer)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = read_launches()
        for k, v in launches.items():
            total[k] += v
        run = {"call_ms": ms, **{f"{k}_ms": 1e3 * timer.totals[k]
                                 for k in ("anyview", "metric", "align")},
               "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "scale_factor": pred.scale_factor,
               "depth_range": [float(pred.depth.min()), float(pred.depth.max())]}
        runs.append(run)
        log(f"[da3_nested] call {c} ({'cold' if c == 0 else 'warm'}): " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in run.items()})
            + f"; launches {json.dumps({k: v for k, v in launches.items() if v})}")
        if launches != want:
            fail(f"nested call {c} launched {launches}, not K1 {want['flash_attn_fwd']} and "
                 f"K4 {want['flash_attn_short']} alone")
        if not (np.isfinite(pred.scale_factor) and pred.scale_factor > 0
                and np.isfinite(pred.depth).all() and np.isfinite(pred.extrinsics).all()
                and pred.depth.shape == (10, 518, 518)):
            fail(f"nested call {c} gave a non-finite or non-positive result")
    profile = profile_device_time("one nested call (profiled)",
                                  lambda: nested_inference(anyview, metric, frames))
    # each branch's layers alone on the same frames: the trunks, then the heads on their taps
    from videogpa_torch.models.da3.heads import dualdpt_forward
    from videogpa_torch.models.da3.mono import mono_forward, mono_vit_forward
    from videogpa_torch.models.da3.vit import aavit_forward

    x = _normalised([frames]).cuda()
    layers = {}
    with torch.no_grad():
        xb = x.to(torch.bfloat16)
        feats = aavit_forward(anyview.backbone, xb)
        layers["giant_trunk_ms"] = cuda_ms(lambda: aavit_forward(anyview.backbone, xb), iters=2,
                                           warmup=1)
        layers["giant_dualdpt_ms"] = cuda_ms(
            lambda: dualdpt_forward(anyview.head, feats, tuple(x.shape[-2:])), iters=2, warmup=1)
        del feats
        layers["metric_trunk_ms"] = cuda_ms(
            lambda: mono_vit_forward(metric.backbone, xb[0]), iters=2, warmup=1)
        layers["metric_forward_ms"] = cuda_ms(
            lambda: mono_forward(metric, x, compute_dtype=torch.bfloat16), iters=2, warmup=1)
    del x, xb
    heads_tflop = da3_heads_tflop(any_cfg, 1, 10)
    log(f"[da3_nested] layers alone: " + json.dumps({k: round(v, 2) for k, v in layers.items()})
        + f"; the giant's DualDPT at {heads_tflop / (layers['giant_dualdpt_ms'] / 1e3):.1f} "
        f"TFLOP/s (f32, TF32 off)")
    log(f"[da3_nested] da3nested-giant-large: anyview {n_any / 1e9:.3f} B parameters (bf16 "
        f"trunk, f32 heads), metric {n_met / 1e9:.3f} B, drawn on the card in {init_s:.1f} s; "
        f"the giant's DualDPT {heads_tflop:.2f} TFLOP a call (meta count); launches a call "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    del anyview, metric
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": total, "init_s": init_s, "anyview_params": n_any,
            "metric_params": n_met, "giant_heads_tflop": heads_tflop, "layers_ms": layers,
            "profile": profile}


def phase_da3_giant_attention(global_shape, local_shape):
    """K1 at DA3-Giant's global rows and K4 at its frame rows against their
    plain versions (K1 over chunks of 4 heads), then timed beside their
    bounds and SDPA on the same operands (standard normal draws, q and k
    contiguous, v a strided view of the packed (B, N, 3, H, D) tensor)."""
    import torch
    import torch.nn.functional as F

    from videogpa_torch.ops.attention import (
        flash_attn_fwd, flash_attn_short, flash_attn_short_reference)

    gen = torch.Generator(device="cuda").manual_seed(95)
    out = {}
    for tag, shape in (("k1", global_shape), ("k4", local_shape)):
        B, N, H, D = shape
        q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
            torch.bfloat16).unbind(2)
        q, k = q.contiguous(), k.contiguous()
        if tag == "k1":
            err, plain_ms = _parity_full(f"DA3-Giant global shape {shape} (v a strided view)",
                                         q, k, v)
            fn = lambda: flash_attn_fwd(q, k, v, layout="bnhd")  # noqa: E731
        else:
            o = flash_attn_short(q, k, v)
            ro, plain_ms = _timed(lambda: flash_attn_short_reference(q, k, v))
            err, atol, ok = _check_o(o, ro)
            log(f"[parity] K4 DA3-Giant frame shape {shape} (strided qkv views): max|dO| "
                f"{err:.3e} (atol {atol:.2e} + rtol {O_RTOL}) {'ok' if ok else 'MISMATCH'}; "
                f"plain version {plain_ms:.2f} ms")
            if not ok:
                fail("flash_attn_short disagrees at the DA3-Giant frame shape")
            del o, ro
            fn = lambda: flash_attn_short(q, k, v)  # noqa: E731
        ms = cuda_ms(fn, iters=10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # yardstick only
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters=10)
        bound_ms, bound_by = _fwd_bound(B, N, N, H, D)
        out[tag] = {"shape_bnhd": list(shape), "max_abs_err": err, "plain_ms": plain_ms,
                    "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                    "tflops": 4.0 * B * H * N * N * D / ms / 1e9}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    log("[timing] DA3-Giant attention: " + json.dumps(out))
    return out


def _colmap_text_project(root: str, n: int, size: int):
    """A COLMAP text project of n cameras on a circle around the origin
    (rotations about y, 3 units away), image files as empty placeholders.
    Returns the image paths in name order."""
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "sparse"))
    f = 0.9 * size
    with open(os.path.join(root, "sparse", "cameras.txt"), "w") as fh:
        fh.write(f"1 PINHOLE {size} {size} {f} {f} {size / 2} {size / 2}\n")
    paths = []
    with open(os.path.join(root, "sparse", "images.txt"), "w") as fh:
        for i in range(n):
            half = 0.05 * i  # rotation of 0.1 rad a camera about y
            name = f"frame_{i:03d}.png"
            fh.write(f"{i + 1} {math.cos(half)} 0 {math.sin(half)} 0 0 0 3 1 {name}\n\n")
            paths.append(os.path.join(root, "images", name))
            open(paths[-1], "wb").close()
    return paths


def phase_da3_service():
    """DA3-Large at full width written in the checkpoint key layout
    (``export_da3``), loaded by the port's ``ModelBackend`` (``/reload``)
    and served through ``make_handler`` on a ``ThreadingHTTPServer`` bound to
    127.0.0.1, port 0 (loopback only): four ``/infer`` requests of 10 frames
    at 518^2 — images with export glb, images with gs_ply, a synthetic COLMAP
    text project whose poses drive the Umeyama alignment (npz), and images
    with gs_video (10 views rendered from 2.68 M gaussians) — each polled on
    ``/tasks/<id>`` until done, then ``/tasks``, ``/status`` and ``/memory``.
    Per request: latency, inference and export ms, launches (K1 8, K4 16),
    peak GB and the artefact's size. The card's machine has no OpenCV, PIL
    or mp4 encoder: the backend's image decoder is swapped for frames held
    in memory (named by path or key) and the video writer for one that keeps
    the frames, inside the phase."""
    import shutil
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from videogpa_torch.data import video_io
    from videogpa_torch.models.da3 import DA3Config
    from videogpa_torch.models.da3 import export as export_mod
    from videogpa_torch.models.da3 import model as model_mod
    from videogpa_torch.models.da3.convert import export_da3
    from videogpa_torch.models.da3.service import ModelBackend, make_handler
    from videogpa_torch.utils.safetensors_np import save_file

    cfg = DA3Config.large()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "da3_service")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "da3_large")
    os.makedirs(ckpt)
    model = da3_large(torch.float32, seed=100)
    save_file(export_da3(model), os.path.join(ckpt, "model.safetensors"))
    del model
    torch.cuda.empty_cache()

    clips = synthetic_frames(2, 10, cfg.img_size, seed=101)
    memory = {f"mem://{c}/{i}": f for c, clip in enumerate(clips) for i, f in enumerate(clip)}
    col_paths = _colmap_text_project(os.path.join(root, "scene"), 10, cfg.img_size)
    memory.update(zip(col_paths, clips[1]))
    videos = {}

    def memory_writer(path, frames, fps=8):
        videos[path] = (np.asarray(frames), fps)
        open(path, "wb").close()

    stage_ms = {"inference": [], "export": []}

    def timed(stage, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_ms[stage].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    real = (ModelBackend.__dict__["_decode_image"], video_io.write_video,
            model_mod.da3_inference, export_mod.export)
    ModelBackend._decode_image = staticmethod(lambda item: memory[item])
    video_io.write_video = memory_writer
    model_mod.da3_inference = timed("inference", real[2])
    export_mod.export = timed("export", real[3])
    server = None
    try:
        backend = ModelBackend(model_dir=ckpt, out_root=os.path.join(root, "out"),
                               device="cuda")
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(backend))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def call(path, payload=None):
            data = None if payload is None else json.dumps(payload).encode()
            req = urllib.request.Request(base + path, data=data,
                                         headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=600).read())

        status0 = call("/status")
        t0 = time.perf_counter()
        reload = call("/reload", {})
        load_s = time.perf_counter() - t0
        keys = [[f"mem://{c}/{i}" for i in range(10)] for c in range(2)]
        requests = [("images_glb", {"images": keys[0], "export": "glb"}),
                    ("images_gs_ply", {"images": keys[0], "export": "gs_ply"}),
                    ("colmap_npz", {"colmap": os.path.join(root, "scene"), "export": "npz"}),
                    ("images_gs_video", {"images": keys[1], "export": "gs_video"})]
        want = dict.fromkeys(read_launches(), 0)
        n_global = (cfg.depth - cfg.alt_start) // 2
        want.update({"flash_attn_fwd": n_global, "flash_attn_short": cfg.depth - n_global})
        results, total = {}, dict.fromkeys(want, 0)
        for tag, payload in requests:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            n_stage = len(stage_ms["inference"])
            t0 = time.perf_counter()
            tid = call("/infer", payload)["task_id"]
            while True:
                task = call(f"/tasks/{tid}")
                if task["status"] in ("done", "error"):
                    break
                time.sleep(0.01)
            latency = 1e3 * (time.perf_counter() - t0)
            launches = read_launches()
            for k, v in launches.items():
                total[k] += v
            if task["status"] != "done":
                fail(f"the served request {tag} ended {task['status']}: {task.get('error')}")
            path = task["result"]
            if os.path.isdir(path):
                size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
                           for f in fs)
            else:
                size = os.path.getsize(path)
            extra = {}
            if tag == "images_gs_video":
                frames, fps = videos[path]
                size = frames.nbytes
                extra = {"video_frames": list(frames.shape), "fps": fps,
                         "mean_level": float(frames.mean())}
                if frames.shape != (10, 518, 518, 3) or not frames.std() > 0:
                    fail("gs_video did not render 10 views of 518^2 with content")
            if tag == "colmap_npz":
                pred = np.load(path)
                extra = {"gt_camera_centres_recovered": bool(np.isfinite(
                    pred["extrinsics"]).all()), "depth_range": [float(pred["depth"].min()),
                                                                 float(pred["depth"].max())]}
            results[tag] = {"latency_ms": latency,
                            "inference_ms": stage_ms["inference"][n_stage],
                            "export_ms": stage_ms["export"][n_stage],
                            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "artifact": os.path.relpath(path, root), "artifact_bytes": size,
                            "n_frames": task["n_frames"], **extra}
            log(f"[da3_service] {tag}: " + json.dumps(
                {k: (round(v, 2) if isinstance(v, float) else v)
                 for k, v in results[tag].items()})
                + f"; launches {json.dumps({k: v for k, v in launches.items() if v})}")
            if launches != want:
                fail(f"the served request {tag} launched {launches}, not K1 "
                     f"{want['flash_attn_fwd']} and K4 {want['flash_attn_short']} alone")
        tasks = call("/tasks")["tasks"]
        status = call("/status")
        mem = call("/memory")
        log(f"[da3_service] /status before {json.dumps(status0)}, after {json.dumps(status)}; "
            f"/reload {json.dumps(reload)} in {load_s:.2f} s; /tasks {len(tasks)} all "
            f"{sorted({t['status'] for t in tasks})}; /memory {json.dumps(mem)}")
        if (len(tasks) != len(requests) or any(t["status"] != "done" for t in tasks)
                or not status["model_loaded"] or status0["model_loaded"]
                or not mem.get("cuda", {}).get("total_gb")):
            fail("the backend's /tasks, /status or /memory is not what the requests left")
        backend._model = None
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        (ModelBackend._decode_image, video_io.write_video, model_mod.da3_inference,
         export_mod.export) = real
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return {"requests": results, "launches": total, "load_s": load_s}


# ---------------------------------------------------------------------------
# The learned matcher (SuperPoint + LightGlue) behind EpipolarMetric
# ("lightglue"), and DA3's evaluation half (TSDF fusion, chamfer / F-score,
# the Evaluator)
# ---------------------------------------------------------------------------

# f32 on both sides, TF32 off: summation order only, ~1e-7 a layer
MATCH_REL = 1e-5
# keypoints in one device's set and not the other's, on a textured pair (no
# exact plateaus; a near-tie at the top-k boundary or inside an NMS window
# can still fall the other way by an ulp). Their order is reported, not
# held: scores 1e-6 apart swap places (LightGlue does not see the order)
KP_DIFF_SHARE = 1e-2
# matches0 entries equal card vs CPU, end to end (each side its own keypoints)
MATCH_AGREE = 0.9
# Epipolar card vs CPU when both match the same pairs of points: the same
# host geometry, but the pairs may come in another order (keypoints whose
# scores lie 1e-6 apart swap places), and an f32 SVD over reordered rows
# rounds differently
EPI_REL = 1e-4
# TSDF fusion card vs CPU: the integration is elementwise, spelt out sum by
# sum, with true divisions, so the two should agree bit for bit; a voxel
# whose projection sits within an ulp of a pixel edge may still fall the
# other way if a device rounds one operation differently
FUSE_FLIP_SHARE, RECON_REL = 1e-4, 1e-3


def matcher_trees(seed: int, matching: bool):
    """SuperPoint and LightGlue parameter trees in the JAX package's layout
    (``superpoint_init`` / ``lightglue_init``), at the published widths, as
    numpy from a seed: kernels U(+-1/sqrt(fan_in)), biases U(+-0.1),
    layer-norm scales 1 + U(+-0.1) (``tests/test_torch_bridge.py::
    random_jax_tree``'s draws).

    Random weights match nothing: deep random ReLU convolutions give nearly
    parallel descriptors, and random attention makes the similarity rank one,
    so the mutual rule keeps one match a pair. With ``matching`` the trees
    are made to match: He-scaled SuperPoint kernels (x sqrt(6), activations
    keep their scale through the 8 ReLU layers), and a LightGlue whose layers
    still run but add nothing to the residual stream (``fc2`` zero), between
    an identity input projection, a final projection of 128 x identity (a
    sharp dual softmax) and a matchability of constant output: the matcher
    pairs the descriptors' mutual nearest neighbours."""
    import numpy as np

    from videogpa_torch.models.matching import LightGlueConfig, SuperPointConfig

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def kernel(shape, gain=1.0):
        fan_in = float(np.prod(shape[:-1]))
        return (gain * rng.uniform(-1, 1, shape) / fan_in ** 0.5).astype(f32)

    def bias(n):
        return rng.uniform(-0.1, 0.1, n).astype(f32)

    def lin(i, o, with_bias=True):
        p = {"kernel": kernel((i, o))}
        if with_bias:
            p["bias"] = bias(o)
        return p

    spc, lgc = SuperPointConfig(), LightGlueConfig()
    gain = 6 ** 0.5 if matching else 1.0
    names = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
    sp, in_ch = {}, 1
    for name, out_ch in zip(names, spc.channels):
        sp[name] = {"kernel": kernel((3, 3, in_ch, out_ch), gain), "bias": bias(out_ch)}
        in_ch = out_ch
    for name, i, o, k in (("convPa", in_ch, 256, 3), ("convPb", 256, 65, 1),
                          ("convDa", in_ch, 256, 3), ("convDb", 256, spc.descriptor_dim, 1)):
        sp[name] = {"kernel": kernel((k, k, i, o), gain), "bias": bias(o)}

    d = lgc.descriptor_dim

    def ffn():
        return {"fc1": lin(2 * d, 2 * d),
                "ln": {"scale": (1 + rng.uniform(-0.1, 0.1, 2 * d)).astype(f32),
                       "bias": bias(2 * d)},
                "fc2": lin(2 * d, d)}

    lg = {"input_proj": lin(d, d), "posenc_Wr": lin(2, d // lgc.num_heads // 2, False),
          "layers": [{"self": {"Wqkv": lin(d, 3 * d), "out_proj": lin(d, d), "ffn": ffn()},
                      "cross": {"to_qk": lin(d, d), "to_v": lin(d, d), "to_out": lin(d, d),
                                "ffn": ffn()}} for _ in range(lgc.n_layers)],
          "final_proj": lin(d, d), "matchability": lin(d, 1)}
    if matching:
        eye, zero = np.eye(d, dtype=f32), np.zeros(d, f32)
        lg["input_proj"] = {"kernel": eye, "bias": zero}
        lg["final_proj"] = {"kernel": 128 * eye, "bias": zero}
        lg["matchability"]["kernel"][:] = 0
        for layer in lg["layers"]:
            for blk in ("self", "cross"):
                layer[blk]["ffn"]["fc2"]["kernel"][:] = 0
                layer[blk]["ffn"]["fc2"]["bias"][:] = 0
    return sp, lg


def matcher_modules(seed: int, matching: bool, device):
    """``matcher_trees`` through the bridge: (SuperPoint, LightGlue) on ``device``."""
    from videogpa_torch.convert import load_jax_params
    from videogpa_torch.models.matching import LightGlue, SuperPoint

    sp, lg = matcher_trees(seed, matching)
    return (load_jax_params(SuperPoint(), sp).eval().to(device),
            load_jax_params(LightGlue(), lg).eval().to(device))


def textured_frames(T: int, size: int, step: int, seed: int):
    """(T, size, size, 3) uint8: a bicubic-upsampled random texture panned
    ``step`` pixels a frame. No flat 8-pixel cells (``synthetic_frames``'),
    so no exact plateaus of equal keypoint scores."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.uniform(0, 255, (1, 3, size // 4 + 2,
                                                (size + step * T) // 4 + 2)).astype(np.float32))
    big = F.interpolate(tex, scale_factor=4, mode="bicubic").clamp(0, 255).round()
    big = big[0].permute(1, 2, 0).numpy().astype(np.uint8)
    return np.stack([big[:size, step * t: step * t + size] for t in range(T)])


def _rel_norm(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_slice_matching():
    """SuperPoint (2,048 keypoints, 256-d descriptors) and LightGlue (9
    layers, d 256, 4 heads) at the published widths, JAX-layout random trees
    through the bridge (SuperPoint's from ``matcher_trees(.., matching=True)``,
    LightGlue's at the published init), on one pair of 518^2 frames, f32,
    card against CPU: SuperPoint's scores and descriptors by rel-norm, the
    keypoints (how many differ in place or in set: on ``synthetic_frames``'
    blocky pair reported, on a textured pair held), LightGlue's
    log-assignment on the CPU's keypoints by rel-norm, and matches0 end to
    end (threshold 0). Then the matching trees (``matcher_trees``) on a
    textured pair panned 8 pixels: matches, the share that pair each point
    with itself, and Epipolar card against CPU. Card ms of each stage on the
    pair (warm)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from videogpa_torch.metrics.epipolar import LightGlueMatcher, epipolar_error, grey_pair
    from videogpa_torch.models.matching import (
        LightGlueConfig, SuperPointConfig, extract_keypoints, lightglue_match, log_assignment,
        superpoint_forward)

    spc = SuperPointConfig()
    lgc = dataclasses.replace(LightGlueConfig(), filter_threshold=0.0)
    out = {}
    # SuperPoint from the matching trees: at the published init its scores
    # are bias-dominated, one maximum an 8 x 8 cell at nearly one value, so
    # their order is the last bits'; LightGlue at the published init
    sp_cpu = matcher_modules(80, matching=True, device="cpu")[0]
    lg_cpu = matcher_modules(80, matching=False, device="cpu")[1]
    sp_dev, lg_dev = copy.deepcopy(sp_cpu).to("cuda"), copy.deepcopy(lg_cpu).to("cuda")
    pairs = {"synthetic_frames": synthetic_frames(1, 2, 518, seed=81)[0],
             "textured": textured_frames(2, 518, 8, seed=82)}
    with torch.no_grad():
        for tag, pair in pairs.items():
            imgs = torch.from_numpy(grey_pair(pair[0], pair[1]))
            hw = tuple(imgs.shape[-2:])
            s_w, d_w = superpoint_forward(sp_cpu, imgs, spc)
            s_g, d_g = superpoint_forward(sp_dev, imgs.cuda(), spc)
            kp_w = extract_keypoints(s_w, d_w, spc)
            kp_g = extract_keypoints(s_g, d_g, spc)
            kp_diff = int((kp_g[0].cpu() != kp_w[0]).any(-1).sum())
            n_kp = kp_w[0].shape[0] * kp_w[0].shape[1]
            not_shared = sum(len({tuple(p) for p in a.tolist()} ^ {tuple(p) for p in b.tolist()})
                             for a, b in zip(kp_g[0].cpu(), kp_w[0]))
            row = {"scores_rel": _rel_norm(s_g, s_w), "descriptors_rel": _rel_norm(d_g, d_w),
                   "keypoints_differ": kp_diff, "of": n_kp, "keypoints_not_shared": not_shared}
            if tag == "textured":
                args = [kp_w[0][:1], kp_w[2][:1], kp_w[3][:1], kp_w[0][1:], kp_w[2][1:],
                        kp_w[3][1:]]
                la_w = log_assignment(lg_cpu, *args, hw, lgc)
                la_g = log_assignment(lg_dev, *[a.cuda() for a in args], hw, lgc)
                row["log_assignment_rel"] = _rel_norm(la_g, la_w)
                m_w = lightglue_match(lg_cpu, *args, hw, lgc)[0]
                m_g = lightglue_match(lg_dev, kp_g[0][:1], kp_g[2][:1], kp_g[3][:1],
                                      kp_g[0][1:], kp_g[2][1:], kp_g[3][1:], hw, lgc)[0]
                row["matches0_agree"] = float((m_g.cpu() == m_w).float().mean())
                row["matches_cpu"] = int((m_w >= 0).sum())
                # card ms a stage, warm
                row["card_ms"] = {
                    "superpoint": cuda_ms(lambda: superpoint_forward(sp_dev, imgs.cuda(), spc),
                                          3),
                    "extract_keypoints": cuda_ms(lambda: extract_keypoints(s_g, d_g, spc), 3),
                    "lightglue": cuda_ms(lambda: lightglue_match(
                        lg_dev, *[a.cuda() for a in args], hw, lgc), 3)}
            out[tag] = row
            log(f"[slice_matching] random SuperPoint (He-scaled) + LightGlue at the published "
                f"widths, {tag} pair 518^2, f32 card vs CPU: " + json.dumps(
                    {k: (float(f"{v:.3e}") if isinstance(v, float) else v)
                     for k, v in row.items()}))
    tex = out["textured"]
    if max(tex["scores_rel"], tex["descriptors_rel"], out["synthetic_frames"]["scores_rel"],
           out["synthetic_frames"]["descriptors_rel"], tex["log_assignment_rel"]) > MATCH_REL:
        fail(f"SuperPoint or LightGlue on the card disagrees with the CPU (limit {MATCH_REL})")
    if tex["keypoints_not_shared"] > KP_DIFF_SHARE * tex["of"]:
        fail("SuperPoint picked other keypoints on the card on the textured pair")
    if tex["matches0_agree"] < MATCH_AGREE:
        fail("LightGlue's matches on the card disagree with the CPU's")
    del sp_cpu, lg_cpu, sp_dev, lg_dev

    # the matching trees: the geometry runs
    clip = textured_frames(2, 518, 8, seed=83)
    matchers = {}
    for dev in ("cpu", "cuda"):
        sp, lg = matcher_modules(84, matching=True, device=dev)
        m = LightGlueMatcher(sp_params=sp, lg_params=lg, device=dev)
        m.lg_cfg = dataclasses.replace(m.lg_cfg, filter_threshold=0.0)
        matchers[dev] = m
    res = {dev: m.get_matched_points(clip[0], clip[1]) for dev, m in matchers.items()}
    epi = {dev: epipolar_error(clip, m) for dev, m in matchers.items()}
    p1, p2, n = res["cuda"]

    def pair_set(r):
        return None if r[0] is None else np.unique(np.concatenate([r[0], r[1]], 1), axis=0)

    same = (res["cpu"][2] == n and p1 is not None and res["cpu"][0] is not None
            and np.array_equal(pair_set(res["cuda"]), pair_set(res["cpu"])))
    self_share = 0.0 if p1 is None else float((np.abs(p1 - p2 - [8, 0]).max(1) < 0.5).mean())
    epi_rel = abs(epi["cuda"] - epi["cpu"]) / max(abs(epi["cpu"]), 1e-30)
    out["matching"] = {"matches": n, "matches_cpu": res["cpu"][2], "same_pairs": same,
                       "pairs_point_with_itself": self_share, "epipolar": epi["cuda"],
                       "epipolar_cpu": epi["cpu"], "epipolar_rel": epi_rel}
    log("[slice_matching] matching trees on a textured pair panned 8 px (518^2): " + json.dumps(
        out["matching"]) + f" (Epipolar limit {EPI_REL} relative when the pairs agree)")
    if n < 20 or not math.isfinite(epi["cuda"]) or epi["cuda"] < 0:
        fail("the matching trees left too few matches for the geometry on the card")
    if same and epi_rel > EPI_REL:
        fail("Epipolar on the card disagrees with the CPU on the same pairs")
    torch.cuda.empty_cache()
    return out


def _stage_timers(module, names):
    """Wrap ``module``'s functions ``names`` in card-synchronised timers;
    returns (ms by name, calls by name, restore)."""
    import torch

    real = {n: getattr(module, n) for n in names}
    ms, calls = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)

    def timed(name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = real[name](*a, **k)
            torch.cuda.synchronize()
            ms[name] += 1e3 * (time.perf_counter() - t0)
            calls[name] += 1
            return result
        return run

    for n in names:
        setattr(module, n, timed(n))
    return ms, calls, lambda: [setattr(module, n, f) for n, f in real.items()]


def _eval_scene(root: str, S: int, size: int, seed: int):
    """An ``npz_dir`` scene: S uint8 frames (``synthetic_frames``), GT poses
    of a slow pan (x steps of 5 cm, a degree of yaw a frame), pinhole
    intrinsics, GT points on the plane z = 2 m."""
    import numpy as np

    frames = synthetic_frames(1, S, size, seed)[0]
    E = np.tile(np.eye(4, dtype=np.float32)[:3], (S, 1, 1))
    for s in range(S):
        a = np.radians(1.0 * s)
        E[s, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[s, 0, 3] = -0.05 * s
    K = np.array([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]], np.float32)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 301), np.linspace(-1.2, 1.2, 241))
    points = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 2.0)], -1).astype(np.float32)
    np.savez(os.path.join(root, "pan.npz"), frames=frames, extrinsics=E,
             intrinsics=np.tile(K, (S, 1, 1)), points=points)


def _bumpy_scene(S: int, size: int):
    """Depths (S, size, size) of a bumpy surface between 1.5 and 3.5 m seen by
    translated, yawed cameras; intrinsics; world->camera extrinsics; and the
    surface as the first view's pixels unprojected (the GT cloud)."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    depths = np.stack([2.5 + 0.6 * np.sin(xx / 40 + s / 3) * np.cos(yy / 55)
                       + 0.3 * np.sin((xx + yy) / 17) for s in range(S)]).astype(np.float32)
    K = np.array([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]], np.float32)
    E = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    for s in range(S):
        a = np.radians(2.0 * s)
        E[s, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[s, 0, 3] = 0.04 * s
    cam = np.stack([(xx - size / 2) / 500.0, (yy - size / 2) / 500.0,
                    np.ones_like(xx)], -1) * depths[0][..., None]
    gt = (cam.reshape(-1, 3) - E[0, :3, 3]) @ E[0, :3, :3]  # R^T (x_cam - t)
    return depths, np.tile(K, (S, 1, 1)), E, gt.astype(np.float32)


def phase_da3_eval(S: int = 10):
    """DA3's evaluation half at full size. ``Evaluator`` in its three modes
    (pose, recon_posed, recon_unposed) on one ``npz_dir`` scene of S x 518^2
    with DA3-Large at full width (bf16 trunk, f32 heads, random weights,
    the fov offset applied): per mode the inference ms, the fusion ms, the
    voxel count and voxel size reached, the surface points, the chamfer ms
    on the host, the metrics, peak GB and the launches (K1 8, K4 16 a call).
    Then ``fuse_depths_tsdf`` on the card against the CPU on a synthetic
    bumpy scene of S x 518^2 at about 8 M voxels: the surface points, and
    chamfer / F-score against the first view's pixels unprojected."""
    import shutil

    import numpy as np
    import torch

    from videogpa_torch.models.da3 import bench, recon

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "da3_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    _eval_scene(root, S, 518, seed=90)
    model = da3_large(torch.bfloat16, seed=91)
    grids, surface = [], []
    real_integrate, real_fuse = recon._tsdf_integrate, bench.fuse_depths_tsdf

    def integrate(centers, depths, intrinsics, extrinsics, trunc, max_depth):
        grids.append((int(centers.shape[0]), trunc / 4.0))  # trunc is 4 voxels
        return real_integrate(centers, depths, intrinsics, extrinsics, trunc, max_depth)

    def fuse(*a, **k):
        pts = real_fuse(*a, **k)
        surface.append(len(pts))
        return pts

    recon._tsdf_integrate, bench.fuse_depths_tsdf = integrate, fuse
    ms, calls, restore = _stage_timers(bench, ["da3_inference", "fuse_depths_tsdf",
                                               "evaluate_3d_reconstruction"])
    out = {"modes": {}}
    old_env = os.environ.get("DA3_BENCH_DIR")
    os.environ["DA3_BENCH_DIR"] = root
    try:
        zero_launches()
        for mode in ("pose", "recon_posed", "recon_unposed"):
            for d in (ms, calls):
                for k in d:
                    d[k] = type(d[k])(0)
            grids.clear()
            surface.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = bench.Evaluator(model, mode=mode).run(bench.DATASET_REGISTRY["npz_dir"]())
            wall = time.perf_counter() - t0
            row = {k: v for k, v in summary["rows"][0].items() if k not in ("scene", "views")}
            out["modes"][mode] = {
                "wall_ms": 1e3 * wall, "inference_ms": ms["da3_inference"],
                "fusion_ms": ms["fuse_depths_tsdf"],
                "chamfer_ms": ms["evaluate_3d_reconstruction"],
                "voxels": grids[0][0] if grids else None,
                "voxel_size": grids[0][1] if grids else None,
                "surface_points": surface[0] if surface else None,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "metrics": row}
            log(f"[da3_eval] Evaluator(mode={mode!r}), DA3-Large, 1 scene of {S} x 518^2: "
                + json.dumps(out["modes"][mode]))
            if summary["scenes"] != 1 or not all(
                    math.isfinite(v) or (mode == "recon_unposed" and v == float("inf"))
                    for v in row.values()):
                fail(f"the Evaluator's {mode} run gave no finite metrics")
            if mode == "recon_posed" and not (grids and surface and surface[0] > 0):
                fail("recon_posed fused no surface")
        out["launches"] = read_launches()
    finally:
        restore()
        recon._tsdf_integrate, bench.fuse_depths_tsdf = real_integrate, real_fuse
        if old_env is None:
            os.environ.pop("DA3_BENCH_DIR", None)
        else:
            os.environ["DA3_BENCH_DIR"] = old_env
    want = dict.fromkeys(out["launches"], 0)
    want.update({"flash_attn_fwd": 3 * 8, "flash_attn_short": 3 * 16})
    log(f"[da3_eval] launches over the three runs {json.dumps({k: v for k, v in out['launches'].items() if v})} "
        f"(expected {json.dumps({k: v for k, v in want.items() if v})})")
    if out["launches"] != want:
        fail("the Evaluator's DA3 did not run its attention through K1 and K4")
    del model
    torch.cuda.empty_cache()

    # fuse_depths_tsdf card vs CPU at ~8 M voxels
    depths, intr, extr, gt = _bumpy_scene(S, 518)
    kw = dict(voxel_size=0.0132)
    grids.clear()
    recon._tsdf_integrate = integrate
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = recon.fuse_depths_tsdf(depths, intr, extr, device="cuda", **kw)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        want_pts = recon.fuse_depths_tsdf(depths, intr, extr, device="cpu", **kw)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        recon._tsdf_integrate = real_integrate
    ref = gt[::2]
    t0 = time.perf_counter()
    m_got = recon.evaluate_3d_reconstruction(got, ref, threshold=0.02)
    chamfer_ms = 1e3 * (time.perf_counter() - t0)
    m_want = recon.evaluate_3d_reconstruction(want_pts, ref, threshold=0.02)
    bit_equal = got.shape == want_pts.shape and np.array_equal(got, want_pts)
    count_share = abs(len(got) - len(want_pts)) / max(len(want_pts), 1)
    worst = max(abs(m_got[k] - m_want[k]) / max(abs(m_want[k]), 1e-12)
                for k in ("acc", "comp", "precision", "recall", "fscore"))
    out["fusion"] = {"voxels": grids[0][0], "voxel_size": grids[0][1], "card_ms": card_ms,
                     "cpu_ms": cpu_ms, "peak_gb": peak, "surface_points": len(got),
                     "surface_points_cpu": len(want_pts), "bit_equal": bit_equal,
                     "chamfer_ms": chamfer_ms, "metrics_card": m_got, "metrics_cpu": m_want,
                     "metrics_worst_rel": worst}
    log(f"[da3_eval] fuse_depths_tsdf, bumpy scene {S} x 518^2, card vs CPU: "
        + json.dumps(out["fusion"]) + f" (limits: point count {FUSE_FLIP_SHARE} relative, "
        f"metrics {RECON_REL} relative)")
    if len(got) == 0 or count_share > FUSE_FLIP_SHARE or worst > RECON_REL:
        fail("fuse_depths_tsdf on the card disagrees with the CPU")
    shutil.rmtree(root)
    return out


# [slice_track]: the VGGT track head (on the tiny VGGT, through vggt_forward)
# and the VGGSfM tracker at its published widths, f32 on the card against the
# same weights in f32 on the CPU. Random weights make the trackers' refinement
# chaotic (an f32 rounding difference grows about 100x an iteration), so the
# update formers' flow heads and the feature updaters are damped by
# TRACK_DAMP. tests/test_torch_vggt_track.py and
# tests/test_torch_vggsfm_tracker.py damp by 0.05, enough for JAX against the
# port on the CPU; the card's f32 convolutions and products differ from the
# CPU's by more, and at 0.05 the VGGSfM coarse tracks of an f32 and a float64
# run on the CPU already differ by 0.05-0.07 px (1.2e-3 px at 0.02). With it
# the iterations contract and the two devices differ by summation order. Limits: tracked pixels
# within TRACK_COORD_ATOL, vis and conf within TRACK_PROB_ATOL (the CPU tests
# hold the same functions to 1e-3 px and 1e-5 against JAX); at the query frame
# each track is its query point, bit for bit.
TRACK_DAMP, TRACK_COORD_ATOL, TRACK_PROB_ATOL = 0.02, 1e-2, 1e-4


def damp_trackers_(module, factor: float = TRACK_DAMP) -> None:
    """Scale every update former's flow head and every feature updater."""
    import torch

    with torch.no_grad():
        for name, m in module.named_modules():
            if name.endswith(("flow_head", "ffeat_updater")):
                m.weight.mul_(factor)
                m.bias.mul_(factor)


def _max_abs(got, want) -> float:
    return float((got.float().cpu() - want.float()).abs().max())


def phase_slice_track() -> dict:
    """The tiny VGGT with a reduced track head (features 16, hidden 32, 3
    levels of radius 2, depth 2; 4 frames of 56^2, 8 queries, 4 iterations)
    and the published VGGSfM tracker (2 frames of 192^2, 16 queries, 6 coarse
    iterations, fine tracking at pradius 15), f32 on the card against the CPU."""
    import copy

    import numpy as np
    import torch

    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init
    from videogpa_torch.models.vggt.track import track_head_init
    from videogpa_torch.models.vggt.vggsfm_tracker import (
        vggsfm_tracker_forward, vggsfm_tracker_init)

    cfg = VGGTConfig.tiny()
    ref = vggt_init(cfg, torch.Generator().manual_seed(140), device="cpu").eval()
    ref.track_head = track_head_init(cfg, features=16, generator=torch.Generator().manual_seed(141),
                                     device="cpu", hidden_size=32, corr_levels=3,
                                     corr_radius=2, depth=2).eval()
    damp_trackers_(ref)
    dev = copy.deepcopy(ref).cuda()
    rng = np.random.default_rng(142)
    imgs = torch.from_numpy(np.stack(synthetic_frames(1, 4, cfg.img_size, seed=142))).float()
    imgs = imgs.permute(0, 1, 4, 2, 3) / 255.0
    qp = torch.from_numpy(rng.uniform(4, cfg.img_size - 4, (1, 8, 2)).astype(np.float32))
    kw = dict(compute_dtype=torch.float32, track_kwargs={"corr_levels": 3, "corr_radius": 2})
    with torch.no_grad():
        want = vggt_forward(ref, imgs, query_points=qp, **kw)
        zero_launches()
        got = vggt_forward(dev, imgs.cuda(), query_points=qp.cuda(), **kw)
        torch.cuda.synchronize()
    head_launches = {k: v for k, v in read_launches().items() if v}
    head = {k: _max_abs(got[k], want[k]) for k in ("track", "vis", "conf")}
    head_reset = bool(torch.equal(got["track"][:, 0].cpu(), qp))

    tref = vggsfm_tracker_init(torch.Generator().manual_seed(143), device="cpu").eval()
    damp_trackers_(tref)
    tdev = copy.deepcopy(tref).cuda()
    # inputs whose coarse tracks lie 0.069 px or more off integers on the CPU,
    # over 10x the coarse tracks' f32 error: both devices crop the same patches
    frames = torch.from_numpy(np.stack(synthetic_frames(1, 2, 192, seed=144))).float()
    frames = frames.permute(0, 1, 4, 2, 3) / 255.0
    tq = torch.from_numpy(np.random.default_rng(144).uniform(24, 168, (1, 16, 2))
                          .astype(np.float32))
    with torch.no_grad():
        w_fine, w_coarse, w_vis, _ = vggsfm_tracker_forward(tref, frames, tq)
        g_fine, g_coarse, g_vis, g_score = vggsfm_tracker_forward(tdev, frames.cuda(), tq.cuda())
        torch.cuda.synchronize()
        card_ms = cuda_ms(lambda: vggsfm_tracker_forward(tdev, frames.cuda(), tq.cuda()), iters=2,
                          warmup=1)
    tracker = {"fine": _max_abs(g_fine, w_fine), "coarse": _max_abs(g_coarse, w_coarse),
               "vis": _max_abs(g_vis, w_vis)}
    frac = w_coarse[:, 1:] % 1.0
    margin = float(torch.minimum(frac, 1 - frac).min())
    tracker_reset = bool(torch.equal(g_fine[:, 0].cpu(), tq))
    out = {"track_head": head, "track_head_launches": head_launches, "vggsfm": tracker,
           "vggsfm_card_ms": card_ms, "coarse_distance_from_integers": margin}
    log(f"[slice_track] f32 card vs CPU, max|d| (limits {TRACK_COORD_ATOL} px, vis/conf "
        f"{TRACK_PROB_ATOL}): the tiny VGGT's track head " + json.dumps(
            {k: float(f"{v:.3e}") for k, v in head.items()})
        + f", launches {json.dumps(head_launches)}; the published VGGSfM tracker "
        + json.dumps({k: float(f"{v:.3e}") for k, v in tracker.items()})
        + f" ({card_ms:.1f} ms on the card; the coarse tracks lie {margin:.3f} px or more off "
        f"integers, where the fine crop's floor could pick another patch)")
    if max(head["track"], tracker["fine"], tracker["coarse"]) > TRACK_COORD_ATOL:
        fail("the tracks on the card disagree with the CPU")
    if max(head["vis"], head["conf"], tracker["vis"]) > TRACK_PROB_ATOL:
        fail("vis or conf on the card disagree with the CPU")
    if not (head_reset and tracker_reset and g_score is None):
        fail("a track on the card left its query point at the query frame")
    return out


def conv_census(module, run, top: int = 4) -> list:
    """Each convolution of ``module`` as ``run()`` calls it (its module name,
    input and weight shapes), then each called once alone on a random input
    of that shape under the profiler: device ms, the peak allocated above
    its input and output (cuDNN's workspace), and its kernels' names.
    Returns the ``top`` slowest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen, hooks = {}, []

    def record(name):
        def hook(m, inp, out):  # returns None: the output stays as it is
            seen.setdefault((name, tuple(inp[0].shape)), m)
        return hook

    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(record(name)))
    try:
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for (name, shape), m in seen.items():
        x = torch.randn(shape, device="cuda", dtype=m.weight.dtype)
        with torch.no_grad():
            y = m(x)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() + y.numel() * y.element_size()
            del y
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                m(x)
                torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(evt, "self_device_time_total", None)
                kernels[evt.key[:70]] = (evt.self_cuda_time_total if us is None else us) / 1e3
        rows.append({"conv": name, "input": list(shape), "weight": list(m.weight.shape),
                     "device_ms": sum(kernels.values()),
                     "workspace_gb": max(0, torch.cuda.max_memory_allocated() - base) / 1e9,
                     "kernels_ms": {k: round(v, 3) for k, v in
                                    sorted(kernels.items(), key=lambda kv: -kv[1])[:3]}})
        del x
    torch.cuda.empty_cache()
    return sorted(rows, key=lambda r: -r["device_ms"])[:top]


def phase_vggt_track(query_pts: int = 256, query_frames: int = 2, runs: int = 2) -> dict:
    """``predict_tracks`` at full width on one clip of 10 x 518^2: VGGT-1B
    (bf16 trunk and DPT heads' weights, f32 camera and track heads) with the
    published track head (features 128, hidden 384, 7 levels of radius 4,
    depth 6, 4 iterations), then the published VGGSfM tracker (6 coarse
    iterations, fine tracking at pradius 15), random weights from seeds;
    ``query_pts`` queries from each of ``query_frames`` query frames; a cold
    and a warm run of each route. Prints each run's wall ms split into trunk,
    the other heads, the track head or tracker, and host, and the peak
    allocated GB (the track head also into its DPT and its tracker);
    checks shapes, finiteness, vis/conf in [0, 1], each track at its query
    point at its query frame, and that every attention of each
    ``vggt_forward`` launched its kernel (K1 24, K4 48, K6 f32 16). Then
    one profiled call on the head with one query frame, the track head's
    DPT's own peak, and its slowest convolutions (``conv_census``)."""
    import numpy as np
    import torch

    from videogpa_torch.models.vggt import VGGTConfig, vggt_init
    from videogpa_torch.models.vggt import model as vmodel
    from videogpa_torch.models.vggt import sfm
    from videogpa_torch.models.vggt import track as vtrack
    from videogpa_torch.models.vggt.vggsfm_tracker import vggsfm_tracker_init

    cfg = VGGTConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = vggt_init(cfg, torch.Generator(device="cuda").manual_seed(150), device="cuda",
                      dtype=torch.bfloat16, enable_track=True).eval()
    regular_camera_(model)
    model.camera_head.float()
    model.track_head.float()
    tracker = vggsfm_tracker_init(torch.Generator(device="cuda").manual_seed(151),
                                  device="cuda").eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_head = sum(p.numel() for p in model.track_head.parameters())
    n_tracker = sum(p.numel() for p in tracker.parameters())
    frames = synthetic_frames(1, 10, cfg.img_size, seed=152)[0]
    images = frames.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    S, _, H, W = images.shape
    per_forward = dict.fromkeys(read_launches(), 0)
    per_forward.update(flash_attn_fwd=cfg.depth, flash_attn_short=cfg.backbone_depth + cfg.depth,
                       flash_attn_fwd_f32=cfg.camera_trunk_depth * cfg.camera_iterations)
    routes = {"vggt_head": ({}, 1 + query_frames, "track_head_forward"),
              "vggsfm": ({"tracker": tracker, "track_kwargs": {
                  "coarse_iters": 6, "fine_tracking": True, "fine_pradius": 15}}, 1,
                  "vggsfm_tracker_forward")}
    grid = np.linspace(0, H * W - 1, query_pts).astype(int)
    queries = np.stack([grid % W, grid // W], axis=1).astype(np.float32)
    result = {"init_s": init_s, "track_head_params": n_head, "tracker_params": n_tracker,
              "routes": {}, "launches": {}}
    for route, (kw, forwards, tracking) in routes.items():
        want = {k: v * forwards for k, v in per_forward.items()}
        total, timed = dict.fromkeys(want, 0), []
        for r in range(runs):
            ms, _, restore = _stage_timers(vmodel, ("aggregator_forward", "camera_head_forward",
                                                    "dpt_head_forward", "track_head_forward"))
            tms, _, trestore = _stage_timers(sfm, ("vggsfm_tracker_forward",))
            hms, _, hrestore = _stage_timers(vtrack, ("dpt_head_forward", "tracker_forward"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            try:
                out = sfm.predict_tracks(model, images, max_query_pts=query_pts,
                                         query_frame_num=query_frames, **kw)
                torch.cuda.synchronize()
            finally:
                restore()
                trestore()
                hrestore()
            wall = 1e3 * (time.perf_counter() - t0)
            launches = read_launches()
            for k, v in launches.items():
                total[k] += v
            track_ms = ms["track_head_forward"] + tms["vggsfm_tracker_forward"]
            run = {"wall_ms": wall, "trunk_ms": ms["aggregator_forward"],
                   "other_heads_ms": ms["camera_head_forward"] + ms["dpt_head_forward"],
                   f"{tracking.split('_forward')[0]}_ms": track_ms,
                   **({"track_dpt_ms": hms["dpt_head_forward"],
                       "tracker_ms": hms["tracker_forward"]} if route == "vggt_head" else {}),
                   "host_ms": wall - sum(ms.values()) - tms["vggsfm_tracker_forward"],
                   "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "track_range": [float(out["tracks"].min()), float(out["tracks"].max())],
                   "vis_mean": float(out["vis"].mean())}
            timed.append(run)
            log(f"[vggt_track] {route} run {r} ({'cold' if r == 0 else 'warm'}): " + json.dumps(
                {k: (round(v, 3) if isinstance(v, float) else v) for k, v in run.items()})
                + f"; query frames {out['query_frames']}; launches "
                + json.dumps({k: v for k, v in launches.items() if v}))
            Q = query_frames
            if launches != want:
                fail(f"[vggt_track] {route} launched {launches}, not {want}")
            if not (out["tracks"].shape == (Q, S, query_pts, 2)
                    and out["vis"].shape == out["conf"].shape == (Q, S, query_pts)):
                fail(f"[vggt_track] {route} returned tracks of the wrong shape")
            if not all(np.isfinite(out[k]).all() for k in ("tracks", "vis", "conf")):
                fail(f"[vggt_track] {route} returned non-finite tracks, vis or conf")
            if not all(((out[k] >= 0) & (out[k] <= 1)).all() for k in ("vis", "conf")):
                fail(f"[vggt_track] {route} returned vis or conf outside [0, 1]")
            for q, qf in enumerate(out["query_frames"]):
                if not np.array_equal(out["tracks"][q, qf], queries):
                    fail(f"[vggt_track] {route}: the tracks left their queries at frame {qf}")
        result["routes"][route] = timed
        result["launches"][route] = total
    real_dpt, dpt_mem, dpt_args = vtrack.dpt_head_forward, [], []

    def dpt_with_peak(*a, **k):
        if not dpt_args:
            dpt_args.append((a, k))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats = real_dpt(*a, **k)
        torch.cuda.synchronize()
        dpt_mem.append([base / 1e9, torch.cuda.max_memory_allocated() / 1e9])
        return feats

    vtrack.dpt_head_forward = dpt_with_peak
    try:
        result["profile"] = profile_device_time(
            "one predict_tracks call on the VGGT head, 1 query frame (profiled)",
            lambda: sfm.predict_tracks(model, images, max_query_pts=query_pts,
                                       query_frame_num=1))
    finally:
        vtrack.dpt_head_forward = real_dpt
    result["track_dpt_allocated_before_and_peak_gb"] = dpt_mem
    log(f"[vggt_track] the track head's DPT (f32, width 128): allocated before and peak "
        f"GB {json.dumps([[round(a, 3), round(b, 3)] for a, b in dpt_mem])}")
    (a, k), = dpt_args
    result["track_dpt_convs"] = conv_census(model.track_head.feature_extractor,
                                            lambda: real_dpt(*a, **k))
    del a, k, dpt_args
    log("[vggt_track] the track head's DPT, slowest convolutions alone (f32, cuDNN's "
        "heuristic pick): " + json.dumps(result["track_dpt_convs"]))
    log(f"[vggt_track] VGGT-1B with its track head ({n_head / 1e6:.1f} M parameters, f32) and "
        f"the VGGSfM tracker ({n_tracker / 1e6:.1f} M, f32), drawn on the card in {init_s:.1f} s; "
        f"{query_pts} queries x {query_frames} query frames on 10 x {H}^2; launches a forward "
        + json.dumps({k: v for k, v in per_forward.items() if v}))
    del model, tracker
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# Four cards over NCCL: python3 chip_smoke.py --ranks 4 [--phases NAME,...]
# ---------------------------------------------------------------------------

RANKS_WORLD = 4
# the parent kills the ranks and fails past RANKS_WALL_S; a collective that
# waits past the process group's timeout fails its rank before that
RANKS_WALL_S, RANKS_PG_TIMEOUT_S = 900, 240
# [ranks_nccl]'s bandwidth figure: one all-reduce of 2^28 bytes of f32
RANKS_BUSBW_BYTES = 2 ** 28
# [ranks_overlap]'s outputs against the one-card computation of the same
# thing, by the norm of the difference over the norm of the one-card output:
# both are bf16 runs of one function that round at other points (partial
# sums all-reduced in bf16, GEMMs of other shapes), and guidance (x 11 at
# CFG 6) scales the sampler's rounding, so the bound is RANKS_FLOOR_MULT x
# the one-card bf16 output's own distance from the one-card output in f32
RANKS_FLOOR_MULT = 3
# the DPO steps' settings: LoRA r 64 / alpha 128, remat, bf16, accumulate 1,
# clip 1.0, warmup 0 so that the first update moves the LoRA
RANKS_TRAIN_KW = dict(learning_rate=1e-4, warmup_steps=0, max_steps=10, lora_rank=64,
                      lora_alpha=128.0, remat=True)
# global batch of each phase (a data rank takes its batch_specs slice)
RANKS_BATCH = {"ranks_train": 2, "ranks_seq_train": 2, "ranks_wan_train": 1,
               "ranks_cog15_train": 1, "ranks_overlap": 4}
# the mesh each phase runs on (ranks_overlap: the sampler's, then the scorer's)
RANKS_PHASE_MESH = {"ranks_ring": ("seq",), "ranks_train": ("dp_tp",),
                    "ranks_seq_train": ("seq",), "ranks_wan_train": ("model",),
                    "ranks_overlap": ("gen", "score"), "ranks_cog15_train": ("model",)}


def ranks_plan(world: int = RANKS_WORLD) -> dict:
    """Every mesh of the ``--ranks`` mode, in the order every rank makes
    them: {name: (``MeshAxes`` keyword arguments, the ranks or None for the
    whole world)}. dp x tp is the JAX package's dry-run rule (dp 2 where the
    count of devices is even, tp the rest); the sampler and the scorer take
    the two halves of the ranks, as its segment 4 does."""
    dp = 2 if world % 2 == 0 else 1
    tp = world // dp
    half = world // 2
    return {"data": ({"data": world}, None), "seq": ({"seq": world}, None),
            "model": ({"model": world}, None), "dp_tp": ({"data": dp, "model": tp}, None),
            "gen": ({"model": half}, list(range(half))),
            "score": ({"data": world - half}, list(range(half, world)))}


def ranks_coord(axes: dict, ranks, rank: int):
    """``rank``'s (data, seq, model) coordinate on a mesh of ``axes`` over
    ``ranks`` (None: the whole world), row-major as ``make_mesh`` lays the
    ranks out; None for a rank outside it."""
    members = list(range(rank + 1)) if ranks is None else list(ranks)
    if rank not in members:
        return None
    i = members.index(rank)
    seq, model = axes.get("seq", 1), axes.get("model", 1)
    return i // (seq * model), (i // model) % seq, i % model


def ranks_rows(phase: str, rank: int, world: int = RANKS_WORLD):
    """The rows of ``phase``'s global batch that ``rank`` holds (its
    ``batch_specs`` slice over its mesh's data axis), or None for a rank
    the phase's batch does not reach."""
    mesh = RANKS_PHASE_MESH[phase][-1]
    axes, ranks = ranks_plan(world)[mesh]
    coord = ranks_coord(axes, ranks, rank)
    if coord is None:
        return None
    n = RANKS_BATCH[phase] // axes.get("data", 1)
    return range(coord[0] * n, (coord[0] + 1) * n)


def cog5b_train_shape():
    """The attention shape of one forward of the CogVideoX-5B train step:
    (1, 17,776, 48, 64)."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig

    cfg = CogVideoXConfig.cogvideox_5b()
    n = cfg.max_text_seq_length + cfg.sample_frames * (
        cfg.sample_height // cfg.patch_size) * (cfg.sample_width // cfg.patch_size)
    return 1, n, cfg.num_heads, cfg.head_dim


def ranks_ring_pairs(n_tokens: int, P: int) -> int:
    """The (query shard, key shard) pairs a rank's ring launches a kernel
    for: its P resident shards less the empty ones of a padded sequence."""
    from videogpa_torch.ops import ring_attention as ring

    L = -(-n_tokens // P)
    validity = ring._shard_validity(n_tokens, L) if L * P != n_tokens else None
    return sum(ring._resident_keys(s, L, validity) > 0 for s in range(P))


def ranks_launches(phase: str, rank: int, world: int = RANKS_WORLD) -> dict:
    """The kernel launches ``rank`` makes on ``phase``'s sharded path, by
    wrapper (those left out: 0). L the layers; a DPO step runs 6 forwards (2
    policy, their 2 remat recomputes, 2 reference) and 2 backwards of every
    attention, each one launch on a rank whatever its share of the heads or
    of the batch, or one a ring pair under ``seq``; the ring phase runs one
    autograd call a shape."""
    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.models.vggt import VGGTConfig
    from videogpa_torch.models.wan import WanConfig

    cog = CogVideoXConfig.cogvideox_5b()
    cog_tokens = cog5b_train_shape()[1]
    if phase == "ranks_ring":
        pairs = [ranks_ring_pairs(n, world) for n in (cog_tokens, cog15_train_shape()[1])]
        return {"flash_attn_fwd": sum(pairs), "flash_attn_bwd": sum(pairs)}
    if phase in ("ranks_train", "ranks_seq_train"):
        pairs = ranks_ring_pairs(cog_tokens, world) if phase == "ranks_seq_train" else 1
        return {"flash_attn_fwd": 6 * cog.num_layers * pairs,
                "flash_attn_bwd": 2 * cog.num_layers * pairs}
    if phase == "ranks_cog15_train":
        L = CogVideoXConfig.cogvideox_1_5_5b().num_layers
        return {"flash_attn_fwd": 6 * L, "flash_attn_bwd": 2 * L}
    if phase == "ranks_wan_train":  # self- and cross-attention a layer
        L = WanConfig.ti2v_5b().num_layers
        return {"flash_attn_fwd_d128": 6 * 2 * L, "flash_attn_bwd_d128": 2 * 2 * L}
    if phase == "ranks_overlap":
        if ranks_coord(*ranks_plan(world)["gen"], rank) is not None:
            return {"flash_attn_fwd": cog.num_layers}  # one CFG-pair forward
        v = VGGTConfig()
        return {"flash_attn_fwd": v.depth, "flash_attn_short": v.backbone_depth + v.depth,
                "flash_attn_fwd_f32": v.camera_trunk_depth * v.camera_iterations}
    raise ValueError(f"no launches for {phase!r}")


def _ranks_tcfg(**kw):
    from videogpa_torch.train.trainer import TrainerConfig

    return TrainerConfig(**RANKS_TRAIN_KW, **kw)


def _rlog(tag: str, msg: str) -> None:
    import torch.distributed as dist

    log(f"[{tag}] r{dist.get_rank()}: {msg}")


def _sync_all() -> None:
    """Every rank here and its card idle: an all-reduce of one value on the
    world, read back."""
    import torch
    import torch.distributed as dist

    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    if x.item() != dist.get_world_size():
        fail(f"the world all-reduce summed {x.item()}")


def _outside_allocator() -> int:
    """Bytes in use on this card that PyTorch's allocator does not hold
    (contexts, NCCL's buffers and channels, library handles)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free - torch.cuda.memory_reserved()


def _ranks_nccl(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_nccl]: on each axis above 1 of every mesh this rank is in, an
    all-reduce, an all-gather into one tensor and a ``batch_isend_irecv``
    ring, each against its closed form; the NCCL version and the transports
    NCCL's INIT log names; the bus bandwidth of one 256 MiB all-reduce over
    the world."""
    import re

    import torch
    import torch.distributed as dist

    from videogpa_torch.parallel.mesh import AXES

    checked = []
    for name, (axes, _) in ranks_plan(world).items():
        mesh = meshes[name]
        if mesh.get_coordinate() is None:
            continue  # a sub-mesh of the other ranks
        for axis in AXES:
            if axes.get(axis, 1) == 1:
                continue
            group = mesh.get_group(axis)
            members = dist.get_process_group_ranks(group)
            n, me = len(members), dist.get_rank(group)
            x = torch.full((1024,), float(rank + 1), device="cuda")
            dist.all_reduce(x, group=group)
            got = torch.empty(n * 8, device="cuda")
            dist.all_gather_into_tensor(got, torch.full((8,), float(rank), device="cuda"),
                                        group=group)
            nxt = dist.get_global_rank(group, (me + 1) % n)
            prv = dist.get_global_rank(group, (me - 1) % n)
            recv = torch.empty(16, device="cuda")
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, torch.full((16,), float(rank), device="cuda"), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            for req in reqs:
                req.wait()
            ok = (bool((x == sum(m + 1 for m in members)).all())
                  and torch.equal(got.cpu(), torch.tensor(members, dtype=torch.float32)
                                  .repeat_interleave(8))
                  and bool((recv == prv).all()))
            checked.append(f"{name}.{axis} {members}")
            if not ok:
                fail(f"[ranks_nccl] {name}.{axis} over {members}: all_reduce {x[0].item()} (want "
                     f"{sum(m + 1 for m in members)}), all_gather {got[::8].tolist()}, ring "
                     f"received {recv[0].item()} (want {prv})")
    _rlog("ranks_nccl", f"all_reduce, all_gather_into_tensor and a batch_isend_irecv ring "
          f"equal their closed forms on {len(checked)} groups: {'; '.join(checked)}")

    big = torch.ones(RANKS_BUSBW_BYTES // 4, device="cuda")
    for _ in range(2):
        dist.all_reduce(big)
    torch.cuda.synchronize()
    iters = 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        dist.all_reduce(big)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    alg = RANKS_BUSBW_BYTES / (ms * 1e-3) / 1e9
    bus = alg * 2 * (world - 1) / world
    del big
    torch.cuda.empty_cache()

    transports, version = [], None
    path = os.path.join(workdir, f"nccl_r{rank}.log")
    if os.path.exists(path):
        with open(path, errors="replace") as f:
            text = f.read()
        transports = sorted(set(re.findall(r" via (\S+)", text)))
        m = re.search(r"NCCL version (\S+)", text)
        version = m.group(1) if m else None
        nvls = sorted(set(re.findall(r"NVLS[^\n]{0,60}", text)))[:3]
    else:
        nvls = []
    out = {"groups": len(checked), "allreduce_ms": ms, "algbw_gb_s": alg, "busbw_gb_s": bus,
           "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
           "nccl_log_version": version, "transports": transports, "nvls_lines": nvls}
    _rlog("ranks_nccl", f"NCCL {out['nccl_version']} ({version or 'no version line'} in its "
          f"INIT log); transports in the log: {transports or 'none found'}; NVLS: {nvls or 'none'}"
          f"; all-reduce of {RANKS_BUSBW_BYTES / 2 ** 20:.0f} MiB f32 over the world: {ms:.3f} ms, "
          f"algbw {alg:.1f} GB/s, busbw {bus:.1f} GB/s (2(n-1)/n x algbw; a figure only)")
    return out


def _kernel_overlap(trace_path: str) -> dict:
    """From a chrome trace of the profiler: the device time of the NCCL
    kernels, of the attention kernels, and of the NCCL kernels that ran while
    an attention kernel ran (ms)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
               if e.get("cat") == "kernel" and "ts" in e]
    comm = [(a, b) for a, b, n in kernels if "nccl" in n.lower()]
    attn = sorted((a, b) for a, b, n in kernels if "flash_attn" in n)
    overlap = 0.0
    for a, b in comm:
        for c, d in attn:
            overlap += max(0.0, min(b, d) - max(a, c))
    return {"nccl_ms": sum(b - a for a, b in comm) / 1e3,
            "attention_ms": sum(b - a for a, b in attn) / 1e3, "overlap_ms": overlap / 1e3,
            "nccl_kernels": len(comm), "attention_kernels": len(attn)}


def _ranks_ring(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_ring]: ``attention(impl="ring")`` over ``seq`` = world at the
    CogVideoX-5B train shape (1, 17,776, 48, 64) and the CogVideoX1.5-5B one
    (1, 41,026, 48, 64), whose shards are ragged: forward and autograd
    against whole K1/K3 calls on this card, the ring's own (O, LSE) of this
    rank's shard, the pairs' launches, and how much of the rotations' NCCL
    time ran beside the pairs' kernels (a profiled second call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from videogpa_torch.ops import ring_attention as ring
    from videogpa_torch.ops.attention import attention, flash_attn_bwd, flash_attn_fwd
    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.parallel.mesh import axis_rank, axis_size

    mesh = meshes["seq"]
    group, r, P = mesh.get_group("seq"), axis_rank(mesh, "seq"), axis_size(mesh, "seq")
    cases, launched = {}, dict.fromkeys(_wrappers(), 0)
    for label, shape in (("CogVideoX-5B", cog5b_train_shape()),
                         ("CogVideoX1.5-5B", cog15_train_shape())):
        B, N, H, D = shape
        gen = torch.Generator(device="cuda").manual_seed(61)
        q, k, v = _attn_case(gen, B, N, N, H, D, "bnhd")
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        # the one-card computation, twice: the second gives the noise floor
        # (K3 sums dQ with reduce-adds)
        o_ref, lse_ref = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
        g_ref = flash_attn_bwd(q, k, v, o_ref, lse_ref, do, layout="bnhd")
        o_2, lse_2 = flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
        g_2 = flash_attn_bwd(q, k, v, o_2, lse_2, do, layout="bnhd")
        floor = [(o_2.float() - o_ref.float()).abs().max().item()] + [
            (a.float() - b.float()).abs().max().item() for a, b in zip(g_2, g_ref)]
        del o_2, lse_2, g_2

        # the ring's forward on this rank's shard: its O and LSE rows
        L = -(-N // P)
        n_valid = N if L * P != N else None

        def my_shard(x):
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, L * P - N)) if n_valid else x
            return x[:, r * L:(r + 1) * L].contiguous()

        rows = slice(r * L, min((r + 1) * L, N))
        n_rows = rows.stop - rows.start
        o_s, lse_s = ring._ring_forward(my_shard(q), my_shard(k), my_shard(v), None, group,
                                        n_valid, "bnhd", None)
        o_err, o_atol, lse_err, shard_ok = _check(o_s[:, :n_rows], lse_s[:, :, :n_rows],
                                                  o_ref[:, rows], lse_ref[:, :, rows])
        del o_s, lse_s

        # the public entry, forward and autograd, counted
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        with set_mesh(mesh):
            o = attention(qq, kk, vv, impl="ring", layout="bnhd")
        grads = torch.autograd.grad(o, (qq, kk, vv), do)
        torch.cuda.synchronize()
        ring_ms = 1e3 * (time.perf_counter() - t0)
        got = read_launches()
        pairs = ranks_ring_pairs(N, P)
        want = {**dict.fromkeys(got, 0), "flash_attn_fwd": pairs, "flash_attn_bwd": pairs}
        o_pub_err, o_pub_atol, ok = _check_o(o, o_ref)
        g_errs = []
        for g, w in zip(grads, g_ref):
            err, atol, g_ok = _grad_check(g, w)
            g_errs.append((err, atol))
            ok = ok and g_ok
        del o, grads

        # a second call under the profiler: the rotations beside the pairs
        trace = os.path.join(workdir, f"ring_{label}_r{rank}.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with set_mesh(mesh):
                o = attention(qq, kk, vv, impl="ring", layout="bnhd")
            torch.autograd.grad(o, (qq, kk, vv), do)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        ov = _kernel_overlap(trace)
        os.remove(trace)
        del o, qq, kk, vv
        _rlog("ranks_ring", f"{label} {shape} over seq = {P} (shards of {L}, this rank's "
              f"{n_rows} valid rows; {pairs} non-empty pairs): shard O max|d| {o_err:.3e} (atol "
              f"{o_atol:.2e} + rtol {O_RTOL}), LSE max|d| {lse_err:.3e} (atol {LSE_ATOL} + rtol "
              f"{LSE_RTOL}); attention(impl='ring') O max|d| {o_pub_err:.3e} (atol "
              f"{o_pub_atol:.2e} + rtol {O_RTOL}), dQ/dK/dV max|d| "
              f"{[f'{e:.3e}' for e, _ in g_errs]} (atol {[f'{a:.2e}' for _, a in g_errs]} + rtol "
              f"{GRAD_RTOL}); one-card noise floor (two runs) O/dQ/dK/dV "
              f"{[f'{e:.3e}' for e in floor]}; forward + autograd {ring_ms:.1f} ms (first call); "
              f"launches {json.dumps({n: c for n, c in got.items() if c})} (want K1 {pairs}, "
              f"K3 {pairs}); profiled call: NCCL {ov['nccl_kernels']} kernels "
              f"{ov['nccl_ms']:.3f} ms, attention {ov['attention_kernels']} kernels "
              f"{ov['attention_ms']:.3f} ms, NCCL time beside an attention kernel "
              f"{ov['overlap_ms']:.3f} ms")
        if not (shard_ok and ok):
            fail(f"[ranks_ring] {label}: the ring over {P} cards disagrees with the whole calls")
        if got != want:
            fail(f"[ranks_ring] {label}: launches {got}, want {want}")
        if ov["nccl_kernels"] and ov["attention_kernels"] and ov["overlap_ms"] <= 0:
            fail(f"[ranks_ring] {label}: no rotation ran beside a pair's kernel")
        for n, c in got.items():
            launched[n] += c
        cases[label] = {"shape": list(shape), "shard_o_err": o_err, "lse_err": lse_err,
                        "o_err": o_pub_err, "grad_errs": [e for e, _ in g_errs],
                        "floor_o_dq_dk_dv": floor, "ms_first": ring_ms, **ov}
        del q, k, v, do, o_ref, lse_ref, g_ref
        torch.cuda.empty_cache()
    return {"cases": cases, "launches": launched}


def _broadcast_floor(vec, group, src: int):
    """``vec`` (a 1-D f32 tensor on the card) of rank ``src`` of ``group``
    sent to every member: (max |d|, |d| / |src's|) of this rank's against it."""
    import torch.distributed as dist

    theirs = vec.clone()
    dist.broadcast(theirs, src=src, group=group)
    d = vec - theirs
    return d.abs().max().item(), (d.norm() / theirs.norm().clamp_min(1e-30)).item()


def _dpo_compare(tag: str, ref: dict, got: dict, lr: float,
                 bounds=(DPO_GRAD_REL, DPO_LOSS_ATOL), exact=None) -> dict:
    """A sharded DPO step's numbers against the one-card step's: the loss,
    grad_norm, each LoRA leaf's first moment after the update (0.1 x the
    clipped gradient) and the LoRA itself; fails beyond the bounds of the
    model's bf16-against-f32 DPO slice (``bounds``: grad_norm and each moment
    by relative norm, the loss by absolute difference; [slice_dpo]'s by
    default) and the LoRA beyond 2.5 x lr. With ``exact``, the one-card step
    in f32, each moment's bound is RANKS_FLOOR_MULT x the one-card bf16
    step's own distance from it on that leaf instead."""
    grad_rel, loss_atol = bounds
    loss_d = abs(got["metrics"]["loss"] - ref["metrics"]["loss"])
    gn_rel = abs(got["metrics"]["grad_norm"] - ref["metrics"]["grad_norm"]) / ref["metrics"][
        "grad_norm"]
    leaf_rel = [_rel_norm(a, b) for a, b in zip(got["mu"], ref["mu"])]
    mu_rel = max(leaf_rel)
    if exact is None:
        leaf_limit = [grad_rel] * len(leaf_rel)
    else:
        leaf_limit = [RANKS_FLOOR_MULT * _rel_norm(a, b) for a, b in zip(ref["mu"], exact["mu"])]
    _rlog(tag, "first moments by leaf, rel-norm d against the one-card step (limit): "
          + ", ".join(f"{n} {e:.3e} ({lim:.3e})"
                      for n, e, lim in zip(ref["names"], leaf_rel, leaf_limit))
          + ("" if exact is None else
             f"; the limits are {RANKS_FLOOR_MULT} x the one-card bf16 step's rel-norm d from "
             f"the one-card f32 step (loss {exact['metrics']['loss']:.6f}, grad_norm "
             f"{exact['metrics']['grad_norm']:.6e}; f32 step {exact['ms']:.1f} ms)"))
    lora_d = max((a - b).abs().max().item() for a, b in zip(got["lora"], ref["lora"]))
    moved = max((a - b).abs().max().item() for a, b in zip(got["lora"], ref["lora0"]))
    out = {"loss": got["metrics"]["loss"], "loss_ref": ref["metrics"]["loss"], "loss_d": loss_d,
           "grad_norm": got["metrics"]["grad_norm"], "grad_norm_ref": ref["metrics"]["grad_norm"],
           "grad_norm_rel": gn_rel, "moment_rel_max": mu_rel, "moment_rel": leaf_rel,
           "moment_limit": leaf_limit, "lora_max_d": lora_d, "lora_moved": moved}
    _rlog(tag, f"against the one-card step: loss {out['loss']:.6f} vs {out['loss_ref']:.6f} "
          f"(|d| {loss_d:.2e}, limit {loss_atol}), grad_norm {out['grad_norm']:.6e} vs "
          f"{out['grad_norm_ref']:.6e} (rel {gn_rel:.2e}, limit {grad_rel}), first moments "
          f"max rel-norm d {mu_rel:.3e}, LoRA after the update max|d| "
          f"{lora_d:.3e} (limit 2.5 x lr = {2.5 * lr:.1e}; the update moved it {moved:.3e})")
    finite = all(math.isfinite(v) for v in got["metrics"].values())
    if not (finite and loss_d <= loss_atol and gn_rel <= grad_rel
            and all(e <= lim for e, lim in zip(leaf_rel, leaf_limit))
            and lora_d <= 2.5 * lr and moved > 0.5 * lr):
        fail(f"[{tag}] the sharded step disagrees with the one-card step")
    return out


def _live_lora(num_layers: int, dim: int, rank: int, seed: int) -> dict:
    """A LoRA tree of ``lora_init`` with every B drawn too (every adapter
    live, so every gradient is off zero)."""
    import torch

    from videogpa_torch.train.lora import lora_init

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lora = lora_init(num_layers, dim, rank, gen, device="cuda")
    with torch.no_grad():
        for ab in lora.values():
            ab["lora_B"].normal_(0.0, 0.01, generator=gen)
    # kept on the host: a step's state holds the rank's one copy on the card
    return {n: {k: t.detach().cpu() for k, t in ab.items()} for n, ab in lora.items()}


def _run_step(step, lora0: dict, tcfg, batch, draws, mesh=None) -> dict:
    """One train-step call from a fresh state on a copy of ``lora0``, under
    ``mesh``: the metrics, first moments and LoRA (on the host) and the ms
    with the card synchronised around it."""
    import torch

    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.train.lora import lora_leaves
    from videogpa_torch.train.trainer import init_train_state

    state = init_train_state({n: {k: t.to("cuda", copy=True) for k, t in ab.items()}
                              for n, ab in lora0.items()}, tcfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with set_mesh(mesh):
        state, m = step(state, batch, **draws)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
            "names": [f"{n}.{k}" for n in lora0 for k in ("lora_A", "lora_B")],
            "mu": [t.detach().float().cpu() for t in state.opt_state["mu"]],
            "lora": [t.detach().float().cpu() for t in lora_leaves(state.lora)],
            "lora0": lora_leaves(lora0)}


def _floor(tag: str, ref: dict) -> dict:
    """The one-card step's spread across the cards (each rank ran it on its
    own card on the same draws): each rank's against rank 0's, the largest."""
    import torch
    import torch.distributed as dist

    vec = torch.cat([torch.tensor([ref["metrics"]["loss"], ref["metrics"]["grad_norm"]])]
                    + [t.reshape(-1) for t in ref["mu"]]).cuda()
    lo = torch.cat([t.reshape(-1) for t in ref["lora"]]).cuda()
    d_all, _ = _broadcast_floor(vec[:2], None, 0)
    mu_d, mu_rel = _broadcast_floor(vec[2:], None, 0)
    lora_d, _ = _broadcast_floor(lo, None, 0)
    spread = torch.tensor([d_all, mu_rel, lora_d], device="cuda")
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    d_all, mu_rel, lora_d = spread.tolist()
    out = {"loss_grad_norm_max_d": d_all, "moment_rel": mu_rel, "lora_max_d": lora_d}
    if dist.get_rank() == 0:
        _rlog(tag, f"noise floor, the one-card step on each card against rank 0's card, the "
              f"largest: loss / grad_norm max|d| {d_all:.3e}, first moments rel-norm d "
              f"{mu_rel:.3e}, LoRA max|d| {lora_d:.3e}")
    return out


def _cog_dpo_case(cfg, batch_size: int, latent_fhw, seed: int):
    """(batch, draws) of a CogVideoX DPO step, made from ``seed`` on the card:
    the whole global batch (latents (B, C, F, H, W) and the prompt), its
    timesteps and the noise of the frames the step keeps."""
    import torch

    F_, H, W = latent_fhw
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch_size, cfg.vae_latent_channels, F_, H, W)
    batch = {"x_win": torch.randn(shape, generator=g, device="cuda"),
             "x_lose": torch.randn(shape, generator=g, device="cuda"),
             "prompt_emb": torch.randn(batch_size, cfg.max_text_seq_length, cfg.text_embed_dim,
                                       generator=g, device="cuda")}
    pt = cfg.patch_size_t or 1
    kept = (F_ - F_ % pt, cfg.vae_latent_channels, H - H % cfg.patch_size,
            W - W % cfg.patch_size)
    draws = {"timesteps": torch.tensor([600, 250][:batch_size], device="cuda"),
             "noise": torch.randn((batch_size,) + kept, generator=g, device="cuda")}
    return batch, draws


_RANK_CACHE: dict = {}


def _cog5b_reference():
    """The one-card CogVideoX-5B DPO step at global batch 2 on this card
    (cached: [ranks_train] and [ranks_seq_train] both hold their steps
    against it)."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
    from videogpa_torch.train.trainer import make_dpo_train_step

    if "cog5b" not in _RANK_CACHE:
        cfg = CogVideoXConfig.cogvideox_5b()
        tcfg = _ranks_tcfg()
        batch, draws = _cog_dpo_case(cfg, 2, (cfg.sample_frames, cfg.sample_height,
                                              cfg.sample_width), seed=62)
        lora0 = _live_lora(cfg.num_layers, cfg.hidden_dim, tcfg.lora_rank, 63)
        dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                       dtype=torch.bfloat16).requires_grad_(False)
        ref = _run_step(make_dpo_train_step(dit, cfg, tcfg)[0], lora0, tcfg, batch, draws)
        floor = _floor("ranks_train", ref)
        _RANK_CACHE["cog5b"] = (cfg, tcfg, batch, draws, lora0, ref, floor)
        del dit
        torch.cuda.empty_cache()
    return _RANK_CACHE["cog5b"]


def _sharded_dpo(tag: str, phase: str, rank: int, make_model, specs_of, make_step, cfg, tcfg,
                 batch, draws, lora0, ref, mesh, shard_model: bool,
                 bounds=(DPO_GRAD_REL, DPO_LOSS_ATOL), exact=None) -> dict:
    """``phase``'s DPO step under ``mesh`` on this rank: the model made
    whole (``make_model``) and, with ``shard_model``, split by ``specs_of``
    (``shard_tree``); this rank's ``batch_specs`` rows of the batch; the
    step twice from fresh states, the first checked against ``ref`` and
    counted, the second timed. Returns the numbers, the launches, the peak
    allocated since the model was laid out and the bytes outside the
    allocator."""
    import torch

    from videogpa_torch.parallel.sharding import batch_specs, shard_tree

    model = make_model()
    if shard_model:
        model = shard_tree(model, specs_of(model), mesh)
    rows = ranks_rows(phase, rank)
    local = shard_tree(batch, batch_specs(batch), mesh)
    if local["x_win"].shape[0] != len(rows) or not torch.equal(
            local["x_win"], batch["x_win"][rows.start:rows.stop]):
        fail(f"[{tag}] batch_specs gave this rank rows other than {rows}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_step(model, cfg, tcfg)[0]
    zero_launches()
    first = _run_step(step, lora0, tcfg, local, draws, mesh)
    got = read_launches()
    second = _run_step(step, lora0, tcfg, local, draws, mesh)
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(got, 0), **ranks_launches(phase, rank)}
    res = _dpo_compare(tag, ref, first, tcfg.learning_rate, bounds, exact)
    _rlog(tag, f"rows {list(rows)} of the global batch of {RANKS_BATCH[phase]}; step "
          f"{first['ms']:.1f} ms (first call) and {second['ms']:.1f} ms, the one-card step "
          f"{ref['ms']:.1f} ms on this card; peak allocated {peak / 2 ** 30:.3f} GiB; outside "
          f"the allocator {_outside_allocator() / 2 ** 30:.3f} GiB; launches "
          f"{json.dumps({n: c for n, c in got.items() if c})}, want "
          f"{json.dumps({n: c for n, c in want.items() if c})}")
    if got != want:
        fail(f"[{tag}] the sharded step launched {got}, not {want}")
    del model, step
    torch.cuda.empty_cache()
    return {**res, "rows": list(rows), "step_ms": [first["ms"], second["ms"]],
            "one_card_ms": ref["ms"], "peak_bytes": peak, "launches": got}


def _ranks_train(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_train]: the CogVideoX-5B DPO step at dp 2 x tp 2, global batch
    2, 42 layers, 24 of 48 heads a rank, 17,776 tokens, against the one-card
    step at batch 2 on the same draws."""
    import torch

    from videogpa_torch.models.cogvideox import dit_init
    from videogpa_torch.parallel.sharding import dit_param_specs
    from videogpa_torch.train.trainer import make_dpo_train_step

    cfg, tcfg, batch, draws, lora0, ref, floor = _cog5b_reference()
    res = _sharded_dpo(
        "ranks_train", "ranks_train", rank,
        lambda: dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                         dtype=torch.bfloat16).requires_grad_(False),
        dit_param_specs, make_dpo_train_step, cfg, tcfg, batch, draws, lora0, ref,
        meshes["dp_tp"], shard_model=True)
    return {**res, "floor": floor}


def _ranks_seq_train(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_seq_train]: the same step with ``attn_impl="ring"`` over seq =
    world (the model whole on every rank, the batch whole: data 1), against
    the same one-card step."""
    import dataclasses

    import torch

    from videogpa_torch.models.cogvideox import dit_init
    from videogpa_torch.train.trainer import make_dpo_train_step

    cfg, tcfg, batch, draws, lora0, ref, floor = _cog5b_reference()
    res = _sharded_dpo(
        "ranks_seq_train", "ranks_seq_train", rank,
        lambda: dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                         dtype=torch.bfloat16).requires_grad_(False),
        None, make_dpo_train_step, cfg, dataclasses.replace(tcfg, attn_impl="ring"), batch,
        draws, lora0, ref, meshes["seq"], shard_model=False)
    return {**res, "floor": floor}


def _ranks_wan_train(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_wan_train]: the Wan2.2-TI2V-5B DPO step at tp = world (6 of 24
    heads a rank, the q/k RMS norm over the whole width across the ranks),
    batch 1 with a clean first frame, 18,480 tokens, through K6/K7, against
    the one-card step; each LoRA leaf's moment within RANKS_FLOOR_MULT x the
    one-card bf16 step's distance from the one-card f32 step on that leaf."""
    import dataclasses

    import torch

    from videogpa_torch.models.wan import WanConfig, wan_init
    from videogpa_torch.parallel.sharding import wan_param_specs
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    cfg = WanConfig.ti2v_5b()
    tcfg = _ranks_tcfg()
    C, F_, H, W = WAN_LATENT
    g = torch.Generator(device="cuda").manual_seed(64)
    batch = {"x_win": torch.randn((1, C, F_, H, W), generator=g, device="cuda"),
             "x_lose": torch.randn((1, C, F_, H, W), generator=g, device="cuda"),
             "prompt_emb": torch.randn((1, cfg.text_len, cfg.text_dim), generator=g,
                                       device="cuda"),
             "image_latent": torch.randn((1, C, 1, H, W), generator=g, device="cuda")}
    draws = {"timesteps": torch.tensor([500], device="cuda"),
             "noise": torch.randn((1, C, F_, H, W), generator=g, device="cuda")}
    lora0 = _live_lora(cfg.num_layers, cfg.dim, tcfg.lora_rank, 65)

    def make_model():
        return wan_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        dtype=torch.bfloat16).requires_grad_(False)

    model = make_model()
    ref = _run_step(make_wan_dpo_train_step(model, cfg, tcfg)[0], lora0, tcfg, batch, draws)
    # the same step in f32 on this card: how far bf16 alone moves each leaf
    t32 = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    exact = _run_step(make_wan_dpo_train_step(model, cfg, t32)[0], lora0, t32, batch, draws)
    del model
    torch.cuda.empty_cache()
    floor = _floor("ranks_wan_train", ref)
    res = _sharded_dpo("ranks_wan_train", "ranks_wan_train", rank, make_model, wan_param_specs,
                       make_wan_dpo_train_step, cfg, tcfg, batch, draws, lora0, ref,
                       meshes["model"], shard_model=True,
                       bounds=(WAN_DPO_GRAD_REL, WAN_DPO_LOSS_ATOL), exact=exact)
    return {**res, "floor": floor}


def _ranks_cog15_train(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_cog15_train]: the CogVideoX1.5-5B DPO step at dp 1 x tp =
    world, batch 1, 41,026 tokens (the residual streams in 1/tp blocks,
    ``seq_shard``), against the one-card step."""
    import torch

    from videogpa_torch.models.cogvideox import dit_init
    from videogpa_torch.parallel.sharding import dit_param_specs
    from videogpa_torch.train.trainer import make_dpo_train_step

    cfg, _, _ = cog15_shapes()
    tcfg = _ranks_tcfg()
    batch, draws = _cog_dpo_case(cfg, 1, COG15_TRAIN_LATENT[2:], seed=66)
    lora0 = _live_lora(cfg.num_layers, cfg.hidden_dim, tcfg.lora_rank, 67)

    def make_model():
        return dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                        dtype=torch.bfloat16).requires_grad_(False)

    model = make_model()
    ref = _run_step(make_dpo_train_step(model, cfg, tcfg)[0], lora0, tcfg, batch, draws)
    del model
    torch.cuda.empty_cache()
    floor = _floor("ranks_cog15_train", ref)
    res = _sharded_dpo("ranks_cog15_train", "ranks_cog15_train", rank, make_model,
                       dit_param_specs, make_dpo_train_step, cfg, tcfg, batch, draws, lora0, ref,
                       meshes["model"], shard_model=True)
    return {**res, "floor": floor}


def _ranks_overlap(rank: int, world: int, meshes: dict, workdir: str) -> dict:
    """[ranks_overlap]: the JAX dry run's segment 4 at full size. The first
    half of the ranks runs the CogVideoX-5B sampler at tp = half (one
    CFG-pair DPM step at 49f@480x720, ``denoise_loop``), the second half the
    VGGT-1B forward at dp = half (``vggt_forward`` on 4 clips x 10 frames x
    518^2, 4 / half clips a rank; bf16 trunk, f32 camera head). Each against
    its one-card output on this card; the wall time of each half alone and of
    both at once, started together after a barrier."""
    import torch
    import torch.distributed as dist

    from videogpa_torch.models.cogvideox import (
        CogVideoXConfig, SamplerSettings, denoise_loop, dit_init)
    from videogpa_torch.models.vggt import VGGTConfig, vggt_forward, vggt_init
    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.parallel.mesh import P as Spec
    from videogpa_torch.parallel.sharding import dit_param_specs, shard_tree

    gen_mesh, score_mesh = meshes["gen"], meshes["score"]
    sampler = gen_mesh.get_coordinate() is not None
    tag = "ranks_overlap"
    if sampler:
        cfg = CogVideoXConfig.cogvideox_5b()
        dit = dit_init(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                       dtype=torch.bfloat16).requires_grad_(False)
        g = torch.Generator(device="cuda").manual_seed(68)
        text = torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=g,
                           device="cuda")
        negative = torch.randn(text.shape, generator=g, device="cuda")
        shape = (1, cfg.sample_frames, cfg.vae_latent_channels, cfg.sample_height,
                 cfg.sample_width)
        settings = SamplerSettings(num_inference_steps=1, sampler="dpm")

        def run(dtype=torch.bfloat16):
            with set_mesh(gen_mesh if sharded else None):
                return denoise_loop(dit, text, negative, settings, shape,
                                    generator=torch.Generator(device="cuda").manual_seed(69),
                                    compute_dtype=dtype)
        mesh, what = gen_mesh, (f"CogVideoX-5B sampler, one CFG-pair DPM step at 49f@480x720 "
                                f"(latents {shape})")
    else:
        vcfg = VGGTConfig()
        model = vggt_init(vcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                          dtype=torch.bfloat16).eval()
        regular_camera_(model)
        model.camera_head.float()
        images = torch.rand((RANKS_BATCH[tag], 10, 3, vcfg.img_size, vcfg.img_size),
                            generator=torch.Generator(device="cuda").manual_seed(70),
                            device="cuda")

        def run(dtype=torch.bfloat16):
            x = shard_tree(images, Spec("data"), score_mesh) if sharded else images
            with set_mesh(score_mesh if sharded else None), torch.no_grad():
                out = vggt_forward(model, x, compute_dtype=dtype, dpt_chunk=8)
            return {k: out[k] for k in ("pose_enc", "depth", "world_points")}
        mesh, what = score_mesh, (f"VGGT-1B forward, {RANKS_BATCH[tag]} clips x 10 frames x "
                                  f"{vcfg.img_size}^2")

    # the one-card output on this card, twice (run to run: the second call
    # timed), and in f32: the bf16 output's own distance from it sets the bound
    sharded = False
    want = run()
    again, one_ms = _timed(run)
    exact = run(torch.float32)
    if sampler:
        want, again, exact = ({"latents": x} for x in (want, again, exact))
    same = all(torch.equal(again[k], want[k]) for k in want)
    floor = max(_rel_norm(want[k], exact[k]) for k in want)
    limit = RANKS_FLOOR_MULT * floor
    if sampler:
        dit = shard_tree(dit, dit_param_specs(dit), gen_mesh)
    else:
        rows = ranks_rows(tag, rank)
        want = {k: v[rows.start:rows.stop] for k, v in want.items()}
    del again, exact
    torch.cuda.empty_cache()
    sharded = True

    # checked and counted: both halves at once
    _sync_all()
    zero_launches()
    got = run()
    torch.cuda.synchronize()
    launches = read_launches()
    _sync_all()
    if sampler:
        got = {"latents": got}
    errs = {k: _rel_norm(got[k], want[k]) for k in want}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    del got

    def wall(active: bool) -> float:
        """ms from a barrier to the next, this rank running its half when
        ``active``."""
        _sync_all()
        t0 = time.perf_counter()
        if active:
            run()
            torch.cuda.synchronize()
        _sync_all()
        return 1e3 * (time.perf_counter() - t0)

    alone_gen = wall(sampler)
    alone_score = wall(not sampler)
    both = wall(True)
    wl = {**dict.fromkeys(launches, 0), **ranks_launches(tag, rank)}
    members = dist.get_process_group_ranks(mesh.get_group("model" if sampler else "data"))
    _rlog(tag, f"{what} on ranks {members}: "
          f"rel-norm d against the one-card output "
          f"{json.dumps({k: f'{v:.3e}' for k, v in errs.items()})} (limit {RANKS_FLOOR_MULT} x "
          f"the one-card bf16 output's rel-norm d from f32, {floor:.3e}: {limit:.3e}; two "
          f"one-card bf16 runs bit-equal: {same}); one-card {one_ms:.1f} ms; wall from barrier "
          f"to barrier: sampler alone {alone_gen:.1f} ms, "
          f"scorer alone {alone_score:.1f} ms (sum {alone_gen + alone_score:.1f}), both at once "
          f"{both:.1f} ms; launches {json.dumps({n: c for n, c in launches.items() if c})}, "
          f"want {json.dumps({n: c for n, c in wl.items() if c})}")
    if not finite or max(errs.values()) > limit:
        fail(f"[{tag}] the {'sampler' if sampler else 'scorer'} half disagrees with one card")
    if launches != wl:
        fail(f"[{tag}] launches {launches}, want {wl}")
    if sampler:
        del dit
    else:
        del model, images
    torch.cuda.empty_cache()
    return {"role": "sampler" if sampler else "scorer", "rel_norm": errs, "floor": floor,
            "limit": limit, "one_card_bit_equal": same,
            "one_card_ms": one_ms, "sampler_alone_ms": alone_gen, "scorer_alone_ms": alone_score,
            "both_ms": both, "launches": launches}


RANK_PHASES = {"ranks_nccl": _ranks_nccl, "ranks_ring": _ranks_ring,
               "ranks_train": _ranks_train, "ranks_seq_train": _ranks_seq_train,
               "ranks_wan_train": _ranks_wan_train, "ranks_overlap": _ranks_overlap,
               "ranks_cog15_train": _ranks_cog15_train}
RANKS_PHASES = tuple(RANK_PHASES)


def _rank_entry(rank: int, world: int, workdir: str, phases: list, log_path: str) -> None:
    """One rank of ``--ranks``: its card first, then an NCCL group over a
    FileStore with a timeout, every mesh of ``ranks_plan`` in order, then
    ``phases``; its results go to ``workdir/rank{rank}.json``."""
    global _LOG_PATH
    import datetime
    import inspect

    import torch

    torch.cuda.set_device(rank)
    _LOG_PATH = log_path
    import torch.distributed as dist

    from videogpa_torch.parallel import MeshAxes, make_mesh

    torch.ones(1, device="cuda")  # this process's context on its card
    context_bytes = _outside_allocator()
    if "ranks_nccl" in phases:  # NCCL reads these at its first communicator
        os.environ.update(NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT",
                          NCCL_DEBUG_FILE=os.path.join(workdir, f"nccl_r{rank}.log"))
    kw = {}
    if "device_id" in inspect.signature(dist.init_process_group).parameters:
        kw["device_id"] = torch.device("cuda", rank)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=RANKS_PG_TIMEOUT_S), **kw)
    try:
        meshes = {name: make_mesh(MeshAxes(**axes), ranks=ranks)
                  for name, (axes, ranks) in ranks_plan(world).items()}
        _sync_all()
        init_s = time.perf_counter() - t0
        out = {"init_s": init_s, "context_bytes": context_bytes, "phases": {}}
        if rank == 0:
            log(f"[ranks] {world} ranks: NCCL group and the meshes "
                f"{json.dumps({n: a for n, (a, _) in ranks_plan(world).items()})} in "
                f"{init_s:.2f} s; device {torch.cuda.get_device_name(rank)}")
        for phase in phases:
            t1 = time.perf_counter()
            res = RANK_PHASES[phase](rank, world, meshes, workdir)
            _sync_all()
            res["wall_s"] = time.perf_counter() - t1
            res["outside_allocator_bytes"] = _outside_allocator() - context_bytes
            out["phases"][phase] = res
            if rank == 0:
                mark(phase)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException as e:
        # out at once: a rank that raised leaves the others inside a
        # collective, where tearing its communicators down could wait on them
        import traceback

        log(f"[ranks] r{rank}: {type(e).__name__}: {e}\n{traceback.format_exc()[-4000:]}")
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def reckon_ranks_main(path: str, phases: str) -> None:
    """``python3 chip_smoke.py --reckon-ranks PATH PHASES``: ``train.memory``'s
    reckoning of rank 0 of [ranks_train]'s step (rank_mesh(2, 2), global
    batch 2) and of [ranks_cog15_train]'s (rank_mesh(1, 4), batch 1), where
    PHASES (comma-separated) holds them, PATH (JSON) rewritten after each.
    CPU work only, as ``reckon_main``."""
    import torch

    from videogpa_torch.models.cogvideox import CogVideoXConfig
    from videogpa_torch.train import memory as M

    os.nice(10)
    torch.set_num_threads(1)
    tcfg = _ranks_tcfg()
    steps = {"ranks_train": lambda: M.aot_train_memory(
                 CogVideoXConfig.cogvideox_5b(), tcfg, mesh=M.rank_mesh(2, 2),
                 batch_size=RANKS_BATCH["ranks_train"]),
             "ranks_cog15_train": lambda: M.aot_train_memory(
                 CogVideoXConfig.cogvideox_1_5_5b(), tcfg, mesh=M.rank_mesh(1, 4),
                 batch_size=RANKS_BATCH["ranks_cog15_train"])}
    out = {}
    for name in [p for p in phases.split(",") if p in steps]:
        out[name] = steps[name]()
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)


def ranks_main(argv: list) -> int:
    """``python3 chip_smoke.py --ranks 4 [--phases NAME,...]``: the port's
    multi-card path on four cards over NCCL (``RANK_PHASES``, each alone
    with ``--phases``). Needs four visible cards; starts the ranks itself
    and fails if one raises or the wall limit passes."""
    import shutil

    world = int(argv[0]) if argv and argv[0].isdigit() else 0
    phases = list(RANKS_PHASES)
    if "--phases" in argv[1:]:
        phases = argv[argv.index("--phases") + 1].split(",")
    if world != RANKS_WORLD or any(p not in RANK_PHASES for p in phases):
        print(f"chip_smoke: --ranks takes {RANKS_WORLD} and --phases from "
              f"{','.join(RANKS_PHASES)}; got {argv}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --ranks {world} needs {world} CUDA devices, this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"(torch.cuda.is_available() is {torch.cuda.is_available()})", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    global _LOG_PATH
    root = os.path.dirname(os.path.abspath(__file__))
    _LOG_PATH = os.path.join(root, "build", "chip_smoke_ranks.log")
    if os.path.exists(_LOG_PATH):
        os.remove(_LOG_PATH)
    workdir = os.path.join(root, "build", "ranks")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout.rstrip()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
        f"{torch.cuda.device_count()} cards: {cards}; phases {phases}")
    for line in topo.splitlines():
        log(f"[env] topo: {line}")
    phase_build()
    reckon = None
    if {"ranks_train", "ranks_cog15_train"} & set(phases):
        reckon = Reckonings("--reckon-ranks", ",".join(phases))
        atexit.register(reckon.stop)
    ctx = mp.start_processes(_rank_entry, args=(world, workdir, phases, _LOG_PATH),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > RANKS_WALL_S:
                fail(f"[ranks] the ranks ran past the wall limit of {RANKS_WALL_S} s")
    except SystemExit:
        raise
    except Exception as e:  # a rank raised or exited non-zero
        fail(f"[ranks] {type(e).__name__}: {str(e)[-3000:]}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_wall = time.perf_counter() - t0
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    summary = {"world": world, "ranks_wall_s": ranks_wall, "cards": cards,
               "init_s": [r["init_s"] for r in results], "phases": {}}
    for phase in phases:
        per = [r["phases"][phase] for r in results]
        entry = {"wall_s": max(p["wall_s"] for p in per),
                 "outside_allocator_gib": [p["outside_allocator_bytes"] / 2 ** 30 for p in per],
                 "launches": [{n: c for n, c in p.get("launches", {}).items() if c}
                              for p in per]}
        if phase in ("ranks_train", "ranks_cog15_train"):
            reckoned = reckon.get(phase)
            model, tp = ("cog15", 4) if phase == "ranks_cog15_train" else ("cogvideox", 2)
            block = _block_residual(model, tp, 1)
            entry["memory"] = [check_reckoning(f"[{phase}] rank {r}:", reckoned, p["peak_bytes"])
                               for r, p in enumerate(per)]
            log(f"[{phase}] remat residual a rank {reckoned['residual_gib']:.3f} GiB, "
                f"{reckoned['block_residual_bytes']:,} B a block (1/tp layout: {block:,} B); "
                f"bytes outside the allocator a rank beyond its context "
                f"{[round(g, 3) for g in entry['outside_allocator_gib']]} GiB")
            if reckoned["block_residual_bytes"] != block:
                fail(f"[{phase}] a block keeps {reckoned['block_residual_bytes']} B, not the "
                     f"1/tp layout's {block}")
        for key in ("step_ms", "one_card_ms", "loss_d", "grad_norm_rel", "moment_rel",
                    "moment_limit", "lora_max_d", "floor", "role", "rel_norm", "limit",
                    "sampler_alone_ms", "scorer_alone_ms", "both_ms", "busbw_gb_s", "algbw_gb_s",
                    "transports", "nccl_version", "cases", "peak_bytes"):
            if key in per[0]:
                entry[key] = [p.get(key) for p in per]
        summary["phases"][phase] = entry
    log(json.dumps({"ranks": summary}))
    for card in cards:
        log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": world}}), flush=True)
    return 0


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
    # [vggt_track]'s forwards: one clip of 10 frames, batch 1
    track_shape = (10, n_frame, vcfg.num_heads, vcfg.embed_dim // vcfg.num_heads)
    track_global_shape = (1, 10 * n_frame, vcfg.num_heads, vcfg.embed_dim // vcfg.num_heads)
    track_cam_shape = (1, 10, vcfg.num_heads, vcfg.tokens_dim // vcfg.num_heads)
    from videogpa_torch.models.wan import WanConfig

    wcfg = WanConfig.ti2v_5b()
    wan_tokens = math.prod(n // p for n, p in zip(WAN_LATENT[1:], wcfg.patch_size))
    # Wan2.2 DiT self-attention, batch 1 per train forward: (1, 18480, 24, 128)
    wan_shape = (1, wan_tokens, wcfg.num_heads, wcfg.head_dim)
    from videogpa_torch.models.da3 import DA3Config

    dcfg = DA3Config.large()
    da3_frame = 1 + (dcfg.img_size // dcfg.patch_size) ** 2  # 1,370 tokens, no registers
    da3_local_shape = (4 * 10, da3_frame, dcfg.num_heads, dcfg.embed_dim // dcfg.num_heads)
    da3_global_shape = (4, 10 * da3_frame, dcfg.num_heads, dcfg.embed_dim // dcfg.num_heads)
    gcfg = DA3Config.giant()  # the nested preset's anyview branch: one scene of 10 frames
    giant_local_shape = (10, da3_frame, gcfg.num_heads, gcfg.embed_dim // gcfg.num_heads)
    giant_global_shape = (1, 10 * da3_frame, gcfg.num_heads, gcfg.embed_dim // gcfg.num_heads)
    _, cog15_latents, cog15_attn_shape = cog15_shapes()  # (2, 45,106, 48, 64)
    cog15_train_attn_shape = cog15_train_shape()  # (1, 41,026, 48, 64)

    phase_build()
    reckonings = Reckonings()
    atexit.register(reckonings.stop)
    fwd_err, fwd_plain_ms, fwd_da3 = phase_parity(dit_shape, vggt_global_shape,
                                                  da3_global_shape, track_global_shape)
    bwd_err, bwd_plain_ms = phase_parity_bwd(train_shape)
    short_err, short_plain_ms, short_da3 = phase_parity_short(vggt_shape, da3_local_shape,
                                                              track_shape)
    d128_f32_err, d128_bf16_err, cam_plain_ms, wan_plain_ms = phase_parity_d128(
        cam_shape, wan_shape, (vggt_shape, vggt_global_shape), track_cam_shape)
    k7_err, k7_plain_ms, k7_cross_plain_ms, k6_wan_err, k6_cross_plain_ms = (
        phase_parity_bwd_d128(wan_shape, wcfg.text_len))
    ring_shards = phase_ring_shards(train_shape, wan_shape)
    ring_nccl = phase_ring_nccl(train_shape)
    mark("ring_shards, ring_nccl")
    zbuf_plain_ms = phase_parity_zbuffer()
    k8_err, k9_err, k8_plain_ms, k9_plain_ms, k8_da3 = phase_parity_int8(
        dit_shape, vggt_global_shape, wan_shape, da3_global_shape)
    mark("parity_zbuffer, parity_int8")
    headdim = phase_parity_headdim()
    headdim_launches = headdim["launches"]
    f32_bwd = phase_parity_f32_bwd(cam_shape, vggt_shape)
    wide = phase_timing_wide()
    mark("parity_headdim, parity_f32_bwd, timing_wide")
    phase_parity_quant(dit_shape)
    phase_slice()
    phase_slice_dpo()
    phase_slice_scorer()
    phase_slice_vggt_bf16()
    phase_slice_wan()
    phase_slice_int8()
    phase_slice_sampling()
    phase_slice_wan_vae()
    phase_slice_da3()
    phase_slice_da3_nested()
    matching_run = phase_slice_matching()
    track_slice = phase_slice_track()
    mark("parity and slices")
    main_run = phase_main()
    sample_run = phase_sample(main_run.pop("dit"))
    replicate_run = phase_replicate_files(sample_run.pop("models"))
    mark("main, sample, replicate_files")
    torch.cuda.empty_cache()
    cog15_parity = phase_parity_cog15(cog15_attn_shape)
    cog15_train_parity = phase_parity_cog15_train(cog15_train_attn_shape)
    slice_dpo_cog15 = phase_slice_dpo_cog15()
    cog15_run = phase_cog15(steps=1)
    # the train phases run on [cog15]'s DiT before [cog15-int8] quantises it
    cog15_train_run = phase_cog15_train(cog15_run["dit"], reckonings)
    cog15_files_run = phase_cog15_train_files(cog15_run["dit"])
    cog15_int8_run = phase_cog15_int8(cog15_run)
    # both runs decode the first 2 of their 22 latent frames (5 frames at 768
    # x 1360) to keep the command inside its limit (PERF.md §4)
    cog15_sample_run = phase_cog15_sample()
    mark("parity_cog15, parity_cog15_train, slice_dpo_cog15, cog15, cog15_train, "
         "cog15_train_files, cog15-int8, cog15_sample")
    train_run = phase_train(reckonings)
    log(f"[cog15_train] beside [train]: CogVideoX1.5-5B step (an update) "
        f"{cog15_train_run['step_ms'][-1]:.1f} ms at {cog15_train_run['tokens']:,} tokens, peak "
        f"{cog15_train_run['peak_gb']:.2f} GB, remat residual "
        f"{cog15_train_run['reckoned']['block_residual_bytes']:,} B a block; CogVideoX-5B "
        f"mini-step {train_run['step_ms'][-1]:.1f} ms (update "
        f"{train_run['update_ms'][-1]:.1f} ms) at {train_run['reckoned']['tokens']:,} tokens, "
        f"peak {train_run['peak_gb']:.2f} GB, "
        f"{train_run['reckoned']['block_residual_bytes']:,} B a block")
    scorer_run = phase_scorer(num_batches=2)
    da3_run = phase_scorer_da3(num_batches=2)
    nested_run = phase_da3_nested(calls=1)
    service_run = phase_da3_service()
    eval_run = phase_da3_eval()
    track_run = phase_vggt_track()
    mark("train, scorer, scorer_da3, da3_nested, da3_service, da3_eval, vggt_track")
    score_files_run = phase_score_files()
    log("[score_files] clips/min through score_groups: " + json.dumps(
        {tag: round(r["clips_per_min"], 1) for tag, r in score_files_run["runs"].items()})
        + f"; [scorer]'s process_frames_batch (six metrics with LPIPS VGG16, warm batches): "
        + json.dumps([round(x, 1) for x in scorer_run["clips_per_min"][1:]])
        + " (the CLI scores the consistency score alone, MSE-only with no LPIPS network)")
    train_files_run = phase_train_files(score_files_run["runs"]["batch4"]["json"])
    wan_run = phase_wan()
    wan_dit = wan_run.pop("dit")
    wan_sample_run = phase_wan_sample(wan_dit, steps=2, decode_latent_frames=6)
    encode_wan_run = phase_encode_files_wan(wan_sample_run.pop("vae"), wan_sample_run.pop("t5"))
    wan_train_files_run = phase_wan_train_files(wan_dit)
    del wan_dit
    torch.cuda.empty_cache()
    wan_train_run = phase_wan_train(reckonings)
    train_memory_run = phase_train_memory(reckonings, {"train": train_run["reckoned"],
                                                       "wan_train": wan_train_run["reckoned"]})
    encode_cog_run = phase_encode_files_cogvideox()
    mark("score_files, train_files, wan, wan_sample, encode_files, wan_train_files, wan_train, "
         "train_memory")
    main_int8_run = phase_main_int8(main_run["latents"])
    scorer_int8_run = phase_scorer_int8(scorer_run["results"])
    wan_int8_run = phase_wan_int8()
    timing = phase_timing(dit_shape, train_shape, vggt_global_shape)
    timing.update(phase_timing_scorer(vggt_shape, cam_shape, vggt_global_shape))
    timing.update(phase_timing_wan(wan_shape, wcfg.text_len))
    timing.update(phase_timing_int8(dit_shape, vggt_global_shape, wan_shape))
    timing_da3 = phase_timing_da3(da3_local_shape, da3_global_shape)
    giant = phase_da3_giant_attention(giant_global_shape, giant_local_shape)
    mark("int8 paths and timing")

    attn_share = main_run["launches_per_step"] * timing["fwd_ms"] / main_run["step_ms"][-1]
    n_mini = len(train_run["step_ms"])
    per_mini = (train_run["launches"]["flash_attn_fwd"] // n_mini,
                train_run["launches"]["flash_attn_bwd"] // n_mini)
    train_attn_ms = per_mini[0] * timing["fwd_ms_train_shape"] + per_mini[1] * timing["bwd_ms"]
    log("[timing] " + json.dumps({
        "denoise_step_ms": main_run["step_ms"],
        "request_s": main_run["request_s"],
        "denoise_peak_allocated_gb": main_run["peak_gb"],
        "train_mini_step_ms": train_run["step_ms"],
        "train_update_ms": train_run["update_ms"],
        "train_peak_allocated_gb": train_run["peak_gb"],
        "train_reckoned_vs_measured": train_run["reckoned"],
        "train_checkpoint_save_restore_s": train_run["checkpoint_s"],
        "scorer_batch_ms": scorer_run["batch_ms"],
        "scorer_clips_per_min": scorer_run["clips_per_min"],
        "scorer_peak_allocated_gb": scorer_run["peak_gb"],
        "da3_scorer_batch_ms": da3_run["exact"]["batch_ms"],
        "da3_scorer_clips_per_min": da3_run["exact"]["clips_per_min"],
        "da3_scorer_peak_allocated_gb": da3_run["exact"]["peak_gb"],
        "da3_scorer_geometry_ranges": da3_run["ranges"],
        "da3_scorer_heads_tflop": da3_run["heads_tflop"],
        "da3_scorer_trunk_ms_heads_ms": [da3_run["trunk_ms"], da3_run["heads_ms"]],
        "da3_int8_scorer_batch_ms": da3_run["int8"]["batch_ms"],
        "da3_int8_scorer_clips_per_min": da3_run["int8"]["clips_per_min"],
        "da3_int8_scorer_peak_allocated_gb": da3_run["int8"]["peak_gb"],
        "da3_int8_scorer_drift_vs_exact": da3_run["int8"]["drift"],
        "da3_attention": timing_da3,
        "replicate_files": {k: v for k, v in replicate_run.items()
                            if k not in ("generate_launches", "score_launches", "lightglue")},
        "replicate_files_lightglue": {k: v for k, v in replicate_run["lightglue"].items()
                                      if k != "launches"},
        "slice_matching": matching_run,
        "da3_eval": {k: v for k, v in eval_run.items() if k != "launches"},
        "da3_nested": {k: v for k, v in nested_run.items() if k != "launches"},
        "da3_service": {k: v for k, v in service_run.items() if k != "launches"},
        "da3_giant_attention": giant,
        "ring_shards": ring_shards["cases"],
        "ring_nccl": {k: v for k, v in ring_nccl.items() if k != "launches"},
        "slice_track": track_slice,
        "vggt_track": {k: v for k, v in track_run.items() if k != "launches"},
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
        "wan_train_reckoned_vs_measured": wan_train_run["reckoned"],
        "train_memory": train_memory_run["layouts"],
        "train_memory_wall_s": train_memory_run["wall_s"],
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
        "sample_i2v_peak_allocated_gb_without_resident_t5": sample_run["i2v_peak_gb_without_t5"],
        "sample_int32_probe": sample_run["int32_probe"],
        "cog15_latent_shape": list(cog15_latents),
        "cog15_attention_shape_bnhd": list(cog15_attn_shape),
        "cog15_denoise_step_ms": cog15_run["step_ms"],
        "cog15_warm_step_ms": cog15_run["warm_ms"],
        "cog15_denoise_peak_allocated_gb": cog15_run["peak_gb"],
        "cog15_int8": {k: v for k, v in cog15_int8_run.items() if k != "launches"},
        "cog15_sample": cog15_sample_run["sample"],
        "cog15_generate": cog15_sample_run["generate"],
        "cog15_k1_k8": cog15_parity,
        "cog15_train_k1_k3": {k: cog15_train_parity[k] for k in ("k1", "k3")},
        "slice_dpo_cog15": {k: v for k, v in slice_dpo_cog15.items() if k != "launches"},
        "cog15_train": {k: v for k, v in cog15_train_run.items()
                        if k not in ("launches", "profile")},
        "cog15_train_profile": cog15_train_run["profile"],
        "cog15_train_files": {k: v for k, v in cog15_files_run.items()
                              if not k.endswith("_launches")},
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
        "da3_frame_attention_shape_bnhd": list(da3_local_shape),
        "da3_global_attention_shape_bnhd": list(da3_global_shape),
        "da3_giant_frame_attention_shape_bnhd": list(giant_local_shape),
        "da3_giant_global_attention_shape_bnhd": list(giant_global_shape),
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
                                for k in train_run["launches"]},
            "scorer_da3": da3_run["exact"]["launches"],
            "scorer_da3_int8": da3_run["int8"]["launches"],
            "replicate_files": {k: replicate_run["generate_launches"][k]
                                + replicate_run["score_launches"][k]
                                for k in train_run["launches"]},
            "replicate_files_lightglue": replicate_run["lightglue"]["launches"],
            "da3_nested": nested_run["launches"], "da3_service": service_run["launches"],
            "da3_eval": eval_run["launches"],
            "ring_shards": ring_shards["launches"], "ring_nccl": ring_nccl["launches"],
            "vggt_track": track_run["launches"]["vggt_head"],
            "train_memory": train_memory_run["launches"],
            "vggt_track_vggsfm": track_run["launches"]["vggsfm"],
            "cog15": cog15_run["launches"], "cog15_int8": cog15_int8_run["launches"],
            "cog15_sample": {k: cog15_sample_run["sample_launches"][k]
                             + cog15_sample_run["generate_launches"][k]
                             for k in train_run["launches"]},
            "slice_dpo_cog15": slice_dpo_cog15["launches"],
            "cog15_train": cog15_train_run["launches"],
            "cog15_train_files": {k: cog15_files_run["run_launches"][k]
                                  + cog15_files_run["resume_launches"][k]
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
         "max_abs_err": max(fwd_err, cog15_parity["k1"]["max_abs_err"],
                            cog15_train_parity["k1"]["max_abs_err"]), "ms": timing["fwd_ms"],
         "plain_ms": fwd_plain_ms,
         "bound_ms": timing["fwd_bound_ms"], "bound_by": timing["fwd_bound_by"],
         "library_ms": timing["fwd_library_ms"],
         "train_shape_with_lse": {"ms": timing["fwd_ms_train_shape"],
                                  "bound_ms": timing["fwd_train_bound_ms"],
                                  "library_ms": timing["fwd_train_library_ms"]},
         "vggt_global_shape": {"ms": timing["fwd_vggt_ms"],
                               "bound_ms": timing["fwd_vggt_bound_ms"],
                               "bound_by": timing["fwd_vggt_bound_by"],
                               "library_ms": timing["fwd_vggt_library_ms"]},
         "da3_global_shape": {**fwd_da3, "ms": timing_da3["k1_ms"],
                              "bound_ms": timing_da3["k1_bound_ms"],
                              "bound_by": timing_da3["k1_bound_by"],
                              "library_ms": timing_da3["k1_library_ms"]},
         "da3_giant_global_shape": giant["k1"],
         "cog15_shape": cog15_parity["k1"],
         "cog15_train_shape_with_lse": cog15_train_parity["k1"],
         "launches_in_parity_cog15_train": cog15_train_parity["launches"]["flash_attn_fwd"]},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd.cu",
         "replaces": "videogpa_tpu/ops/attention.py:951,983",
         **by_path("flash_attn_bwd"),
         "max_abs_err": max(bwd_err, cog15_train_parity["k3"]["max_abs_err"]),
         "ms": timing["bwd_ms"], "plain_ms": bwd_plain_ms,
         "bound_ms": timing["bwd_bound_ms"], "bound_by": timing["bwd_bound_by"],
         "library_ms": timing["bwd_library_ms"],
         "cog15_train_shape": cog15_train_parity["k3"],
         "launches_in_parity_cog15_train": cog15_train_parity["launches"]["flash_attn_bwd"]},
        {"name": "flash_attn_short", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_short.cu",
         "replaces": "videogpa_tpu/ops/attention.py:544",
         **by_path("flash_attn_short"),
         "max_abs_err": short_err, "ms": timing["k4_ms"], "plain_ms": short_plain_ms,
         "bound_ms": timing["k4_bound_ms"], "bound_by": timing["k4_bound_by"],
         "library_ms": timing["k4_library_ms"],
         "da3_frame_shape": {**short_da3, "ms": timing_da3["k4_ms"],
                             "bound_ms": timing_da3["k4_bound_ms"],
                             "bound_by": timing_da3["k4_bound_by"],
                             "library_ms": timing_da3["k4_library_ms"]},
         "da3_giant_frame_shape": giant["k4"]},
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
         "max_abs_err": max(k8_err, cog15_parity["k8"]["max_abs_err"]), "ms": timing["k8_ms"],
         "plain_ms": k8_plain_ms,
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
                                   timing["k8_vggt_exact_kernel_turns_ms"]},
         "da3_global_shape": {**k8_da3, "ms": timing_da3["k8_ms"],
                              "bound_ms": timing_da3["k8_bound_ms"],
                              "bound_by": timing_da3["k8_bound_by"], "library_ms": None,
                              "quantize_qk_ms": timing_da3["k8_quantize_ms"]},
         "cog15_shape": cog15_parity["k8"]},
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
                            "d128 (flash_attn_bwd_wide_f32.cu)": f32_bwd["registers_smem_d128"]}},
        # the entries above head_dim 128 and the int8 route with f32 operands:
        # no model of the repo has such a head or runs int8 in f32, so every
        # main path launches them 0 times; they ran in [parity_headdim],
        # [parity_f32_bwd] and [timing]
        {"name": "flash_attn_fwd_wide_bf16", "wrapper": "flash_attn_fwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_wide_bf16.cu",
         "replaces": "videogpa_tpu/ops/attention.py:65",
         **by_path("flash_attn_fwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_fwd_wide"],
         "max_abs_err": max(headdim["wide_max_abs_err"]["bfloat16"],
                            wide["bfloat16"]["max_abs_err"],
                            f32_bwd["wide_max_abs_err"]["bfloat16"]),
         **{k: wide["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape_bnhd")},
         "registers_smem": {k: v for k, v in wide["registers_smem"].items()
                            if k.startswith("fwd_wide_bf16")}},
        {"name": "flash_attn_fwd_wide_f32", "wrapper": "flash_attn_fwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_fwd_wide.cu",
         "replaces": "videogpa_tpu/ops/attention.py:65",
         **by_path("flash_attn_fwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_fwd_wide"],
         "max_abs_err": max(headdim["wide_max_abs_err"]["float32"], wide["float32"]["max_abs_err"],
                            f32_bwd["wide_max_abs_err"]["float32"]),
         **{k: wide["float32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "shape_bnhd")},
         "registers_smem": {k: v for k, v in wide["registers_smem"].items()
                            if k.startswith("fwd_wide_f32")}},
        {"name": "flash_attn_bwd_wide_bf16", "wrapper": "flash_attn_bwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd_wide.cu",
         "replaces": "videogpa_tpu/ops/attention.py:883,908",
         **by_path("flash_attn_bwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_bwd_wide"],
         "max_abs_err": max(f32_bwd["wide_max_abs_err"]["bfloat16"],
                            headdim["wide_max_abs_err"]["bfloat16"]),
         **{k: f32_bwd["shapes"]["long row D=256 bf16"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                      "two_kernel_bound_ms")},
         "registers_smem": {k[len("registers_smem_wide_bf16_"):]: v for k, v in f32_bwd.items()
                            if k.startswith("registers_smem_wide_bf16")}},
        {"name": "flash_attn_bwd_wide_f32", "wrapper": "flash_attn_bwd_wide", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_bwd_wide_f32.cu",
         "replaces": "videogpa_tpu/ops/attention.py:883,908",
         **by_path("flash_attn_bwd_wide"),
         "launches_in_parity_phases": headdim_launches["flash_attn_bwd_wide"],
         "max_abs_err": max(f32_bwd["wide_max_abs_err"]["float32"],
                            headdim["wide_max_abs_err"]["float32"]),
         **{k: f32_bwd["shapes"]["long row D=256 f32"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "walk")},
         "registers_smem": {k[len("registers_smem_wide_f32_"):]: v for k, v in f32_bwd.items()
                            if k.startswith("registers_smem_wide_f32")}},
        {"name": "flash_attn_int8_f32", "route": "cuda",
         "source": "videogpa_torch/csrc/flash_attn_int8_f32.cu",
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
    if sys.argv[1:2] == ["--reckon"]:
        reckon_main(sys.argv[2])
    elif sys.argv[1:2] == ["--reckon-ranks"]:
        reckon_ranks_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ranks"]:
        sys.exit(ranks_main(sys.argv[2:]))
    elif sys.argv[1:2] == ["--measure-layout"]:
        measure_layout_main(*sys.argv[2:6])
    else:
        sys.exit(main())
