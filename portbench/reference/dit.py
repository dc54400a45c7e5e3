"""The CogVideoX DiT (diffusers' ``CogVideoXTransformer3DModel``) in plain
PyTorch, float32, layer by layer.

``W`` maps parameter names (the layout ``portbench.weights`` draws) to
tensors in any float dtype; each block's weights are cast to float32 as the
block runs, so the whole model is never held in float32. Attention runs
a head at a time over blocks of query rows, so no (N, N) matrix of more than
one block is alive. ``prec="fp8"`` is the control: both operands of every
matrix product are rounded to float8 e4m3 with one scale a row first.

The published model:

- tokens are [text ‖ video]; text through ``text_proj``, video patches of
  (C, p, p) (2-D patches, a Conv2d in the published weights) through
  ``patch_embed.proj``;
- the time embedding is sinusoidal (cos first) of width ``hidden``, then
  linear_1, SiLU, linear_2;
- each block: AdaLN-zero (SiLU(temb) -> 6 chunks: shift, scale, gate for
  video, then for text) around LayerNorm (eps 1e-5); joint attention with
  biases, per-head LayerNorm of q and k (eps 1e-6), interleaved 3-D RoPE on
  the video tokens (head_dim split 1/4 time, 3/8 height, 3/8 width);
  a gelu-tanh FFN of 4x width; gated residuals;
- the head: LayerNorm over [text ‖ video], AdaLN (shift, scale) over the
  video tokens, ``proj_out``, unpatchify;
- LoRA (rank r, scaling alpha / r) on to_q, to_k, to_v, to_out:
  y += scaling * (x A^T) B^T.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (the last dim), back in
    float32."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a matrix product at ``prec``; the rounding passes the
    gradient straight through."""
    if prec == "f32":
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    return x + (round_fp8(x) - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], prec: str) -> torch.Tensor:
    """x @ w^T + b; w (out, in)."""
    y = operand(x, prec) @ operand(w, prec).t()
    return y if b is None else y + b


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def rope_tables(grid: Tuple[int, int, int], head_dim: int, theta: float,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (T*H*W, head_dim): each angle repeated for its channel pair."""
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    parts = []
    for axis, (n, d) in enumerate(zip(grid, dims)):
        inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
        ang = (torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv)
        ang = ang.repeat_interleave(2, dim=-1).float()
        shape = [1, 1, 1, d]
        shape[axis] = n
        parts.append(ang.reshape(shape).expand(*grid, d))
    full = torch.cat(parts, dim=-1).reshape(-1, head_dim)
    return torch.cos(full), torch.sin(full)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, D): (x0, x1) pairs rotate to (x0 c - x1 s, x1 c + x0 s)."""
    pairs = x.reshape(x.shape[:-1] + (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


# ---------------------------------------------------------------------------
# Attention: plain softmax(Q K^T / sqrt(D)) V, a head and a block of rows at
# a time, with its gradient written out (so the backward, too, never holds
# more than one block of the (N, N) matrix)
# ---------------------------------------------------------------------------

def _row_blocks(n_rows: int, n_keys: int, budget_bytes: int = 1 << 31):
    rows = max(256, min(n_rows, budget_bytes // (4 * n_keys)))
    return [(i, min(i + rows, n_rows)) for i in range(0, n_rows, rows)]


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float, prec: str) -> torch.Tensor:
    """softmax(scale q k^T) over a block of rows; the scale (a power of two
    at the published head sizes) is applied to q, which is exact."""
    return ((operand(q, prec) * scale) @ operand(k, prec).t()).softmax(dim=-1)


def _probs_operand(p: torch.Tensor, prec: str) -> torch.Tensor:
    """P (non-negative) as an operand of P V."""
    if prec == "f32":
        return p
    scale = FP8_MAX / p.amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return p.mul(scale).to(torch.float8_e4m3fn).float().div_(scale)


def attention_forward(q, k, v, prec: str) -> torch.Tensor:
    """q, k, v (B, H, N, D) float32 -> O (B, H, N, D)."""
    B, H, N, D = q.shape
    scale = D ** -0.5
    o = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            kb, vb = k[b, h], v[b, h]
            for r0, r1 in _row_blocks(N, k.shape[2]):
                p = _probs(q[b, h, r0:r1], kb, scale, prec)
                o[b, h, r0:r1] = _probs_operand(p, prec) @ operand(vb.t(), prec).t()
    return o


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, prec):
        o = attention_forward(q, k, v, prec)
        ctx.save_for_backward(q, k, v, o)
        ctx.prec = prec
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        prec = ctx.prec
        B, H, N, D = q.shape
        scale = D ** -0.5
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (do * o).sum(dim=-1)  # (B, H, N)
        for b in range(B):
            for h in range(H):
                kb, vb = k[b, h], v[b, h]
                for r0, r1 in _row_blocks(N, k.shape[2]):
                    qr, dor = q[b, h, r0:r1], do[b, h, r0:r1]
                    p = _probs(qr, kb, scale, prec)
                    dv[b, h] += _probs_operand(p, prec).t() @ operand(dor.t(), prec).t()
                    dp = operand(dor, prec) @ operand(vb, prec).t()
                    ds = p.mul_(dp.sub_(delta[b, h, r0:r1, None]))
                    dq[b, h, r0:r1] = (operand(ds, prec) @ operand(kb.t(), prec).t()).mul_(scale)
                    dk[b, h] += (operand(ds.t(), prec) @ operand(qr.t(), prec).t()).mul_(scale)
        return dq, dk, dv, None


def attention(q, k, v, prec: str) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, prec)
    return attention_forward(q, k, v, prec)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _get(W: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return W[name].float()


def _lin(W, name: str, x, prec: str, lora: Optional[dict] = None, lora_name: str = "",
         scaling: float = 1.0):
    y = linear(x, _get(W, name + ".weight"), _get(W, name + ".bias"), prec)
    if lora is not None and lora_name in lora:
        a, b_ = lora[lora_name]
        y = y + scaling * linear(linear(x, a, None, prec), b_, None, prec)
    return y


def _ln(W, name: str, x, eps: float):
    return F.layer_norm(x, (x.shape[-1],), _get(W, name + ".weight"), _get(W, name + ".bias"),
                        eps)


def _adaln(W, name: str, temb, video, text, prec: str):
    mod = linear(F.silu(temb), _get(W, name + ".linear.weight"), _get(W, name + ".linear.bias"),
                 prec)
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
    h = _ln(W, name + ".norm", video, 1e-5) * (1 + scale[:, None]) + shift[:, None]
    e = _ln(W, name + ".norm", text, 1e-5) * (1 + e_scale[:, None]) + e_shift[:, None]
    return h, e, gate[:, None], e_gate[:, None]


def block(W, i: int, cfg: dict, video, text, temb, rope, prec: str,
          lora: Optional[dict] = None, scaling: float = 1.0):
    pre = f"blocks.{i}"
    H, D = cfg["num_heads"], cfg["head_dim"]
    n_txt = text.shape[1]
    h_n, e_n, gate, e_gate = _adaln(W, pre + ".norm1", temb, video, text, prec)
    x = torch.cat([e_n, h_n], dim=1)
    B, N, _ = x.shape
    layer = None if lora is None else {n: (ab[0][i], ab[1][i]) for n, ab in lora.items()}

    def heads(name, norm=None):
        y = _lin(W, f"{pre}.attn1.{name}", x, prec, layer, name, scaling).reshape(B, N, H, D)
        if norm is not None:
            y = _ln(W, f"{pre}.attn1.{norm}", y, 1e-6)
        return y.transpose(1, 2)  # (B, H, N, D)

    q, k, v = heads("to_q", "norm_q"), heads("to_k", "norm_k"), heads("to_v")
    cos, sin = rope
    q = torch.cat([q[:, :, :n_txt], apply_rope(q[:, :, n_txt:], cos, sin)], dim=2)
    k = torch.cat([k[:, :, :n_txt], apply_rope(k[:, :, n_txt:], cos, sin)], dim=2)
    o = attention(q, k, v, prec).transpose(1, 2).reshape(B, N, H * D)
    out = _lin(W, f"{pre}.attn1.to_out", o, prec, layer, "to_out", scaling)
    video = video + gate * out[:, n_txt:]
    text = text + e_gate * out[:, :n_txt]

    h_n, e_n, gate, e_gate = _adaln(W, pre + ".norm2", temb, video, text, prec)
    x = torch.cat([e_n, h_n], dim=1)
    ff = _lin(W, f"{pre}.ff.fc2", F.gelu(_lin(W, f"{pre}.ff.fc1", x, prec), approximate="tanh"),
              prec)
    return video + gate * ff[:, n_txt:], text + e_gate * ff[:, :n_txt]


def patchify(cfg: dict, latents: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(B, F, C, H, W) -> tokens (B, T*h*w, features) in (t, h, w) order, and
    the grid."""
    B, Fr, C, Hh, Ww = latents.shape
    p = cfg["patch_size"]
    x = latents.reshape(B, Fr, C, Hh // p, p, Ww // p, p)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)  # (B, F, h, w, C, p, p)
    return x.reshape(B, Fr * (Hh // p) * (Ww // p), C * p * p), (Fr, Hh // p, Ww // p)


def unpatchify(cfg: dict, x: torch.Tensor, shape) -> torch.Tensor:
    B, Fr, _, Hh, Ww = shape
    p, C = cfg["patch_size"], cfg["out_channels"]
    x = x.reshape(B, Fr, Hh // p, Ww // p, C, p, p).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, Fr, C, Hh, Ww)


def dit_forward(W: Dict[str, torch.Tensor], cfg: dict, latents: torch.Tensor,
                text_emb: torch.Tensor, timesteps: torch.Tensor, prec: str = "f32",
                lora: Optional[dict] = None, scaling: float = 1.0,
                remat: bool = False) -> torch.Tensor:
    """v-prediction (B, F, C_out, H, W) float32 of latents (B, F, C, H, W).

    ``lora``: {target: (A (L, r, in), B (L, out, r))}. ``remat`` keeps only
    each block's inputs for the backward (``torch.utils.checkpoint``)."""
    if (not cfg["use_rotary_positional_embeddings"] or cfg["use_learned_positional_embeddings"]
            or cfg["patch_size_t"] is not None):
        raise NotImplementedError("the reference covers the 2-D patch RoPE models only")
    latents, text_emb = latents.float(), text_emb.float()
    dim = cfg["num_heads"] * cfg["head_dim"]
    te = timestep_embedding(timesteps, dim)
    temb = _lin(W, "time_embedding.linear_2", F.silu(_lin(W, "time_embedding.linear_1", te, prec)),
                prec)
    text = _lin(W, "patch_embed.text_proj", text_emb, prec)
    patches, grid = patchify(cfg, latents)
    w = _get(W, "patch_embed.proj.weight").reshape(dim, -1)
    video = linear(patches, w, _get(W, "patch_embed.proj.bias"), prec)
    rope = rope_tables(grid, cfg["head_dim"], cfg["rope_theta"], latents.device)
    for i in range(cfg["num_layers"]):
        args = (W, i, cfg, video, text, temb, rope, prec, lora, scaling)
        if remat:
            video, text = checkpoint(block, *args, use_reentrant=False)
        else:
            video, text = block(*args)
    joint = _ln(W, "norm_final", torch.cat([text, video], dim=1), 1e-5)
    video = joint[:, text.shape[1]:]
    mod = linear(F.silu(temb), _get(W, "norm_out.linear.weight"), _get(W, "norm_out.linear.bias"),
                 prec)
    shift, scale = mod.chunk(2, dim=-1)
    video = _ln(W, "norm_out.norm", video, 1e-5) * (1 + scale[:, None]) + shift[:, None]
    out = _lin(W, "proj_out", video, prec)
    return unpatchify(cfg, out, latents.shape)
