"""DA3's Gaussian-splatting branch (``videogpa_tpu/models/da3/gaussians.py``):
the GSDPT head, the camera->world adapter and the 3DGS PLY writer.

The reference's ``model/gsdpt.py`` (a DPT branch predicting raw per-pixel
gaussian parameters and an opacity, the input images merged into the head's
features) and ``model/gs_adapter.py`` (depth-anchored means, sigmoid-bounded
scales times depth times the intrinsics' pixel size, camera->world
quaternion rotation, SH colour masking). Rendering is ``gs_render.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from videogpa_torch.geometry.rotation import mat_to_quat
from videogpa_torch.geometry.transforms import affine_inverse
from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.vit import _drawn
from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.heads import DPTHead, dpt_head_forward
from videogpa_torch.ops import layers as L


@dataclasses.dataclass
class Gaussians:
    """Reference ``specs.py::Gaussians``, flattened over the views; tensors
    or numpy arrays."""

    means: Any  # (B, N, 3)
    harmonics: Any  # (B, N, 3, d_sh)
    opacities: Any  # (B, N)
    scales: Any  # (B, N, 3)
    rotations: Any  # (B, N, 4) wxyz


def gs_raw_dim(sh_degree: int = 0, pred_offset_xy: bool = True) -> int:
    d_sh = (sh_degree + 1) ** 2
    return (2 if pred_offset_xy else 0) + 3 + 4 + 3 * d_sh


def _mat_to_quat_wxyz(R: torch.Tensor) -> torch.Tensor:
    q = mat_to_quat(R)  # xyzw
    return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)


def _quat_mul_wxyz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def gaussian_adapter(extrinsics: torch.Tensor, intrinsics: torch.Tensor, depths: torch.Tensor,
                     opacities: torch.Tensor, raw_gaussians: torch.Tensor,
                     image_shape: Tuple[int, int], sh_degree: int = 0,
                     pred_offset_xy: bool = True, gaussian_scale_min: float = 1e-5,
                     gaussian_scale_max: float = 30.0, eps: float = 1e-8) -> Gaussians:
    """extrinsics (B, V, 4, 4) world->camera, intrinsics (B, V, 3, 3) in
    pixels, depths and opacities (B, V, H, W), raw_gaussians (B, V, H, W,
    d_in) -> Gaussians of B x (V*H*W)."""
    H, W = image_shape
    B, V = raw_gaussians.shape[:2]
    d_sh = (sh_degree + 1) ** 2
    dev, dt = raw_gaussians.device, raw_gaussians.dtype

    c2w = affine_inverse(extrinsics)
    sides = torch.tensor([W, H, 1.0], dtype=intrinsics.dtype, device=dev)
    intr_normed = intrinsics / sides[:, None]  # rows 0 and 1 over W and H

    # pixel-centre grid in [0, 1]
    xs = (torch.arange(W, device=dev, dtype=dt) + 0.5) / W
    ys = (torch.arange(H, device=dev, dtype=dt) + 0.5) / H
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.stack([gx, gy], -1).expand(B, V, H, W, 2)

    pixel = torch.tensor([1.0 / W, 1.0 / H], dtype=dt, device=dev)
    if pred_offset_xy:
        xy = xy + raw_gaussians[..., :2] * pixel
        raw_gaussians = raw_gaussians[..., 2:]

    # unproject: dir_cam = K_normed^-1 (x, y, 1); world = t + R dir * depth
    Kinv = torch.linalg.inv(intr_normed)
    pix = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    dir_cam = torch.einsum("bvij,bvhwj->bvhwi", Kinv, pix)
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    dir_world = torch.einsum("bvij,bvhwj->bvhwi", R, dir_cam)
    means = t[:, :, None, None] + dir_world * depths[..., None]

    scales_raw, rot_raw, sh = torch.split(raw_gaussians, [3, 4, raw_gaussians.shape[-1] - 7],
                                          dim=-1)
    scales = gaussian_scale_min + (gaussian_scale_max - gaussian_scale_min) * torch.sigmoid(
        scales_raw)
    mult = 0.1 * torch.einsum("bvij,j->bvi", torch.linalg.inv(intr_normed[..., :2, :2]),
                              pixel).sum(-1)
    gs_scales = scales * depths[..., None] * mult[:, :, None, None, None]

    rot = rot_raw / (torch.linalg.vector_norm(rot_raw, dim=-1, keepdim=True) + eps)  # xyzw
    rot_wxyz = torch.cat([rot[..., 3:4], rot[..., :3]], dim=-1)
    q_c2w = _mat_to_quat_wxyz(R)  # (B, V, 4)
    world_rot = _quat_mul_wxyz(q_c2w[:, :, None, None].expand(rot_wxyz.shape), rot_wxyz)

    sh = sh.reshape(sh.shape[:-1] + (3, d_sh))
    if sh_degree > 0:
        mask = torch.ones((d_sh,), dtype=dt, device=dev)
        for degree in range(1, sh_degree + 1):
            mask[degree ** 2:(degree + 1) ** 2] = 0.1 * 0.25 ** degree
        sh = sh * mask

    def flat(x):
        return x.reshape((B, V * H * W) + x.shape[4:])

    return Gaussians(means=flat(means), harmonics=flat(sh), opacities=flat(opacities),
                     scales=flat(gs_scales), rotations=flat(world_rot))


# ---------------------------------------------------------------------------
# GSDPT head (the input images concatenated into the head's features)
# ---------------------------------------------------------------------------

def _gs_vcfg(cfg: DA3Config) -> VGGTConfig:
    return VGGTConfig(embed_dim=cfg.embed_dim, num_register_tokens=0,
                      dpt_features=cfg.dpt_features, dpt_out_channels=cfg.dpt_out_channels,
                      dpt_intermediate_layers=(0, 1, 2, 3), patch_size=cfg.patch_size)


class GSDPT(nn.Module):
    """The head's parameters, named as the JAX tree of ``gsdpt_init``: a
    feature-only DPT over the trunk's 2C tokens, the image merger and the
    output head; ``forward`` is :func:`gsdpt_forward`."""

    def __init__(self, cfg: DA3Config, sh_degree: int = 0, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg, self.sh_degree = cfg, sh_degree
        f = cfg.dpt_features
        self.dpt = DPTHead(_gs_vcfg(cfg), output_dim=0, feature_only=True, **fk)
        self.images_merger = L.Conv2d(f + 3, f // 2, 3, padding=1, **fk)
        self.out_a = L.Conv2d(f // 2, 32, 3, padding=1, **fk)
        self.out_b = L.Conv2d(32, gs_raw_dim(sh_degree) + 1, 1, **fk)  # + opacity

    def forward(self, feats, images: torch.Tensor):
        return gsdpt_forward(self, feats, images)


def gsdpt_init(cfg: DA3Config, sh_degree: int = 0, generator: Optional[torch.Generator] = None,
               device=None, dtype: torch.dtype = torch.float32) -> GSDPT:
    """A random GSDPT on ``device`` in ``dtype`` (``vit._drawn``)."""
    model = _drawn(lambda **fk: GSDPT(cfg, sh_degree, **fk), generator, device)[0]
    return model.to(dtype).requires_grad_(False)


def gsdpt_forward(head: GSDPT, feats, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats: the trunk's 4 (tokens (B, V, P, 2C), camera token) pairs;
    images (B, V, 3, H, W) in [0, 1]. Returns (raw gaussians (B, V, H, W,
    d_in), opacities (B, V, H, W)), in the head's dtype."""
    B, V, _, H, W = images.shape
    dt = head.out_b.weight.dtype
    layer_outputs = torch.stack([f[0].to(dt) for f in feats])  # (4, B, V, P, 2C)
    # the tokens come without the cls slot: a dummy slot keeps patch_start_idx 1
    layer_outputs = torch.cat([layer_outputs[:, :, :, :1], layer_outputs], dim=3)
    features = dpt_head_forward(head.dpt, layer_outputs, _gs_vcfg(head.cfg), (H, W),
                                compute_dtype=dt, inplace_relu=False)  # (B, V, f, H, W)
    h = torch.cat([features.reshape(B * V, -1, H, W), images.reshape(B * V, 3, H, W).to(dt)],
                  dim=1)
    h = torch.relu(head.images_merger(h))
    h = torch.relu(head.out_a(h))
    out = head.out_b(h).permute(0, 2, 3, 1).reshape(B, V, H, W, -1)
    return out[..., :-1], torch.sigmoid(out[..., -1])


# ---------------------------------------------------------------------------
# 3DGS PLY export
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_gs_ply(g: Gaussians, path: str, batch: int = 0) -> None:
    """Write gaussians in the standard 3DGS PLY layout."""
    means = _np(g.means[batch]).astype(np.float32)
    sh = _np(g.harmonics[batch]).astype(np.float32)  # (N, 3, d_sh)
    opac = _np(g.opacities[batch]).astype(np.float32)
    scales = _np(g.scales[batch]).astype(np.float32)
    rots = _np(g.rotations[batch]).astype(np.float32)
    N = means.shape[0]
    d_sh = sh.shape[-1]
    n_rest = 3 * (d_sh - 1)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(n_rest)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {N}\n"
              + "".join(f"property float {n}\n" for n in names)
              + "end_header\n")
    cols = [means, np.zeros((N, 3), np.float32), sh[:, :, 0]]
    if n_rest:
        cols.append(sh[:, :, 1:].reshape(N, n_rest))
    # inverse activations (the 3DGS convention): logit opacity, log scales
    cols.append(np.log(np.clip(opac, 1e-6, 1 - 1e-6)
                       / (1 - np.clip(opac, 1e-6, 1 - 1e-6)))[:, None])
    cols.append(np.log(np.maximum(scales, 1e-9)))
    cols.append(rots)
    data = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
