"""LightGlue keypoint matcher (``videogpa_tpu/models/matching/lightglue.py``).

The matcher the reference's epipolar metric runs: a learned-Fourier rotary
encoding of the normalised keypoints, ``n_layers`` layers of self and
symmetric cross attention over the two keypoint sets, and a dual-softmax
log-assignment with per-point matchability. Full depth, no adaptive pruning
or early exit, and static shapes (padded sets with validity masks), as in
the JAX package. Its masked attention is XLA code there, so it is plain
PyTorch here: masked scores, softmax, products in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.ops import layers as L

_NEG = -1e9


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    descriptor_dim: int = 256
    num_heads: int = 4
    n_layers: int = 9
    filter_threshold: float = 0.1


def _ffn(d: int, fk) -> nn.Module:
    return L.group(fc1=L.Linear(2 * d, 2 * d, **fk), ln=L.LayerNorm(2 * d, eps=1e-5, **fk),
                   fc2=L.Linear(2 * d, d, **fk))


class LightGlue(nn.Module):
    """The parameters of ``lightglue_init``'s tree under its names
    (``layers.{i}.self`` / ``.cross``)."""

    def __init__(self, cfg: LightGlueConfig = LightGlueConfig(), device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        d = cfg.descriptor_dim
        self.input_proj = L.Linear(d, d, **fk)
        self.posenc_Wr = L.Linear(2, d // cfg.num_heads // 2, bias=False, **fk)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "self": L.group(Wqkv=L.Linear(d, 3 * d, **fk), out_proj=L.Linear(d, d, **fk),
                            ffn=_ffn(d, fk)),
            "cross": L.group(to_qk=L.Linear(d, d, **fk), to_v=L.Linear(d, d, **fk),
                             to_out=L.Linear(d, d, **fk), ffn=_ffn(d, fk)),
        }) for _ in range(cfg.n_layers))
        self.final_proj = L.Linear(d, d, **fk)
        self.matchability = L.Linear(d, 1, **fk)


@torch.no_grad()
def lightglue_init(cfg: LightGlueConfig = LightGlueConfig(),
                   generator: Optional[torch.Generator] = None, device=None,
                   dtype: torch.dtype = torch.float32) -> LightGlue:
    """A random LightGlue on ``device``, kaiming-uniform linears and unit
    layer norms as the JAX initialiser draws (different numbers).
    ``generator`` lives on ``device`` (default: seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = LightGlue(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    return model.requires_grad_(False)


def _rotary_embed(model: LightGlue, kpts: torch.Tensor):
    """(B, K, 2) normalised keypoints -> interleaved cos, sin (B, 1, K, head_dim)."""
    proj = model.posenc_Wr(kpts)
    cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)[:, None]
    sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)[:, None]
    return cos, sin


def _rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    pairs = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)


def _apply_rotary(x, cos, sin):
    return x * cos + _rotate_interleaved(x) * sin


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, K, D = x.shape
    return x.reshape(B, K, H, D // H).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, K, D = x.shape
    return x.transpose(1, 2).reshape(B, K, H * D)


def _masked_attn(q, k, v, mask_k):
    """(B, H, Kq, d) attention over keys with validity mask (B, Kk)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~mask_k[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def _ffn_apply(m, x, msg):
    h = m.ln(m.fc1(torch.cat([x, msg], dim=-1)))
    return m.fc2(L.gelu_tanh(h))


def _self_block(m, desc, rot, mask, H):
    q, k, v = m.Wqkv(desc).chunk(3, dim=-1)
    cos, sin = rot
    q = _apply_rotary(_heads(q, H), cos, sin)
    k = _apply_rotary(_heads(k, H), cos, sin)
    msg = m.out_proj(_unheads(_masked_attn(q, k, _heads(v, H), mask)))
    return desc + _ffn_apply(m.ffn, desc, msg)


def _cross_block(m, desc0, desc1, mask0, mask1, H):
    qk0, qk1 = _heads(m.to_qk(desc0), H), _heads(m.to_qk(desc1), H)
    v0, v1 = _heads(m.to_v(desc0), H), _heads(m.to_v(desc1), H)
    m0 = m.to_out(_unheads(_masked_attn(qk0, qk1, v1, mask1)))
    m1 = m.to_out(_unheads(_masked_attn(qk1, qk0, v0, mask0)))
    return desc0 + _ffn_apply(m.ffn, desc0, m0), desc1 + _ffn_apply(m.ffn, desc1, m1)


def normalize_keypoints(kpts: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    H, W = hw
    size = torch.tensor([W, H], dtype=torch.float32, device=kpts.device)
    return (kpts - size / 2) / (size.max() / 2)


def log_assignment(model: LightGlue,
                   kpts0: torch.Tensor, desc0: torch.Tensor, mask0: torch.Tensor,
                   kpts1: torch.Tensor, desc1: torch.Tensor, mask1: torch.Tensor,
                   image_hw: Tuple[int, int], cfg: LightGlueConfig = LightGlueConfig()
                   ) -> torch.Tensor:
    """The (B, M, N) log-assignment of two padded keypoint sets: the layers,
    then the dual softmax with each point's matchability."""
    H = cfg.num_heads
    d0, d1 = model.input_proj(desc0), model.input_proj(desc1)
    rot0 = _rotary_embed(model, normalize_keypoints(kpts0, image_hw))
    rot1 = _rotary_embed(model, normalize_keypoints(kpts1, image_hw))
    for layer in model.layers:
        d0 = _self_block(layer["self"], d0, rot0, mask0, H)
        d1 = _self_block(layer["self"], d1, rot1, mask1, H)
        d0, d1 = _cross_block(layer["cross"], d0, d1, mask0, mask1, H)

    scale = cfg.descriptor_dim ** 0.25
    md0, md1 = model.final_proj(d0) / scale, model.final_proj(d1) / scale
    sim = torch.matmul(md0.float(), md1.float().transpose(-1, -2))
    sim = sim.masked_fill(~(mask0[:, :, None] & mask1[:, None, :]), _NEG)
    z0 = model.matchability(d0)[..., 0]
    z1 = model.matchability(d1)[..., 0]
    return (F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1)
            + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :])


def lightglue_match(model: LightGlue,
                    kpts0: torch.Tensor, desc0: torch.Tensor, mask0: torch.Tensor,
                    kpts1: torch.Tensor, desc1: torch.Tensor, mask1: torch.Tensor,
                    image_hw: Tuple[int, int], cfg: LightGlueConfig = LightGlueConfig()):
    """Match two padded keypoint sets: kpts* (B, K, 2) pixels, desc* (B, K, D),
    mask* (B, K) bool. Returns (matches0 (B, K): index into set 1 or -1,
    scores0 (B, K))."""
    scores = log_assignment(model, kpts0, desc0, mask0, kpts1, desc1, mask1, image_hw, cfg)
    # mutual nearest neighbours above the threshold; argmax takes the first max
    idx0 = torch.argmax(scores, dim=2)
    idx1 = torch.argmax(scores, dim=1)
    m_scores = torch.exp(scores.amax(dim=2))
    mutual = idx1.gather(1, idx0) == torch.arange(idx0.shape[1], device=idx0.device)[None]
    ok = mutual & (m_scores > cfg.filter_threshold) & mask0
    return torch.where(ok, idx0, -1), torch.where(ok, m_scores, 0.0)


def lightglue_config_of(tree: Mapping, cfg: LightGlueConfig = LightGlueConfig()
                        ) -> LightGlueConfig:
    """``cfg`` with the depth and width of a ``lightglue_init``-shaped tree."""
    return dataclasses.replace(cfg, n_layers=len(tree["layers"]),
                               descriptor_dim=int(np.shape(tree["input_proj"]["kernel"])[0]))


def convert_lightglue(sd: Mapping[str, np.ndarray],
                      cfg: LightGlueConfig = LightGlueConfig()) -> Dict[str, np.ndarray]:
    """``LightGlue`` state dict from the official superpoint_lightglue
    checkpoint (``videogpa_tpu/models/matching/lightglue.py::convert_lightglue``):
    the last layer's log-assignment head only."""
    out: Dict[str, np.ndarray] = {}

    def take(dst: str, src: str) -> None:
        for p in ("weight", "bias"):
            if f"{src}.{p}" in sd:
                out[f"{dst}.{p}"] = np.asarray(sd[f"{src}.{p}"])

    def ffn(dst: str, src: str) -> None:
        take(f"{dst}.fc1", f"{src}.0")
        take(f"{dst}.ln", f"{src}.1")
        take(f"{dst}.fc2", f"{src}.3")

    for i in range(cfg.n_layers):
        pfx, dst = f"transformers.{i}", f"layers.{i}"
        for name in ("Wqkv", "out_proj"):
            take(f"{dst}.self.{name}", f"{pfx}.self_attn.{name}")
        ffn(f"{dst}.self.ffn", f"{pfx}.self_attn.ffn")
        for name in ("to_qk", "to_v", "to_out"):
            take(f"{dst}.cross.{name}", f"{pfx}.cross_attn.{name}")
        ffn(f"{dst}.cross.ffn", f"{pfx}.cross_attn.ffn")
    take("input_proj", "input_proj")
    take("posenc_Wr", "posenc.Wr")
    last = f"log_assignment.{cfg.n_layers - 1}"
    take("final_proj", f"{last}.final_proj")
    take("matchability", f"{last}.matchability")
    return out
