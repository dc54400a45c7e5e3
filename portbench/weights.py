"""Weights and inputs made from ``--seed``, on the device, in a few large
draws.

The benchmark makes every tensor both sides read: the DiT's weights (one
uniform draw into one flat buffer in the served dtype, each leaf then scaled
to its bound), the LoRA tensors, prompts, latents, timesteps and noise. The
program and the reference get the same values; neither makes its own.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Tuple

import torch

# LayerNorm affines drawn around (1, 0) so that a fault in them shows
NORM_JITTER = 0.1
LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of draws of run ``seed``."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def hidden_dim(cfg: dict) -> int:
    return cfg["num_heads"] * cfg["head_dim"]


def dit_param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every DiT parameter; kind is ``linear`` (fan-in
    bound), ``norm_w`` or ``norm_b``."""
    dim, hd, te = hidden_dim(cfg), cfg["head_dim"], cfg["time_embed_dim"]
    p, pt = cfg["patch_size"], cfg["patch_size_t"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, n_out, n_in, w_shape=None):
        out.append((name + ".weight", w_shape or (n_out, n_in), "linear"))
        out.append((name + ".bias", (n_out,), "linear"))

    def norm(name, n):
        out.append((name + ".weight", (n,), "norm_w"))
        out.append((name + ".bias", (n,), "norm_b"))

    if pt is not None:
        raise NotImplementedError("2-D patches only")
    c = cfg["in_channels"]
    lin("patch_embed.proj", dim, c * p * p, (dim, c, p, p))
    lin("patch_embed.text_proj", dim, cfg["text_embed_dim"])
    lin("time_embedding.linear_1", te, dim)
    lin("time_embedding.linear_2", te, te)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        lin(b + ".norm1.linear", 6 * dim, te)
        norm(b + ".norm1.norm", dim)
        for name in LORA_TARGETS:
            lin(f"{b}.attn1.{name}", dim, dim)
        norm(b + ".attn1.norm_q", hd)
        norm(b + ".attn1.norm_k", hd)
        lin(b + ".norm2.linear", 6 * dim, te)
        norm(b + ".norm2.norm", dim)
        lin(b + ".ff.fc1", 4 * dim, dim)
        lin(b + ".ff.fc2", dim, 4 * dim)
    norm("norm_final", dim)
    lin("norm_out.linear", 2 * dim, te)
    norm("norm_out.norm", dim)
    lin("proj_out", p * p * cfg["out_channels"], dim)
    return out


def _numel(shape: Iterable[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def make_dit_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every DiT parameter as a view of one flat buffer drawn in one call:
    linear weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    LayerNorm weights 1 + U(-j, j) and biases U(-j, j), j = NORM_JITTER."""
    shapes = dit_param_shapes(cfg)
    flat = torch.empty(sum(_numel(s) for _, s, _ in shapes), dtype=dtype, device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(device, seed, "dit"))
    weights: Dict[str, torch.Tensor] = {}
    off = 0
    fan_in = {}
    for name, shape, kind in shapes:
        n = _numel(shape)
        view = flat[off:off + n].view(shape)
        off += n
        if kind == "linear":
            prefix = name.rsplit(".", 1)[0]
            if name.endswith(".weight"):
                fan_in[prefix] = n // shape[0]
            view.mul_(fan_in[prefix] ** -0.5)
        elif kind == "norm_w":
            view.mul_(NORM_JITTER).add_(1.0)
        else:
            view.mul_(NORM_JITTER)
        weights[name] = view
    return weights


@torch.no_grad()
def make_lora(cfg: dict, rank: int, b_bound: float, seed: int,
              device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The LoRA tree of a run resumed mid-training, float32, in the port's
    layout {target: {"lora_A": (L, r, dim), "lora_B": (L, dim, r)}}: A ~
    U(-sqrt(3/dim), sqrt(3/dim)) (PEFT's init), B ~ U(-b_bound, b_bound)."""
    L, dim = cfg["num_layers"], hidden_dim(cfg)
    per = L * rank * dim
    flat = torch.empty(2 * len(LORA_TARGETS) * per, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=generator(device, seed, "lora"))
    tree, off = {}, 0
    for name in LORA_TARGETS:
        a = flat[off:off + per].view(L, rank, dim).mul(3.0 ** 0.5 / dim ** 0.5)
        b = flat[off + per:off + 2 * per].view(L, dim, rank).mul(b_bound)
        off += 2 * per
        tree[name] = {"lora_A": a, "lora_B": b}
    return tree
