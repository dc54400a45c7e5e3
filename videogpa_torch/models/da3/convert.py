"""DA3 checkpoints <-> the port's ``DA3`` state dicts
(``videogpa_tpu/models/da3/convert.py``).

The checkpoint follows the reference module tree (``depth_anything_3/model/
da3.py``: ``backbone.pretrained`` the DINOv2 AA-ViT, ``head`` the DualDPT,
``cam_dec``, ``cam_enc``) in torch layouts already, so conversion renames
keys. The port names its modules as the JAX tree does; it differs from the
checkpoint in these places only (``_upstream_key``): the ``backbone.pretrained``
prefix and the patch projection (``patch_embed.proj``); the blocks, one list
upstream, are ``blocks_pre`` (0 .. alt_start - 1) and ``blocks_alt`` here;
the DPT's ``resize_layers``, ``scratch.layer{n}_rn``,
``scratch.refinenet{n}[_aux].resConfUnit{m}``, ``scratch.output_conv*`` (the
aux head's ``output_conv2_aux.3.{0,2,5}``: only the last level's is used);
the camera decoder's Sequentials (``backbone.{0,2}``, ``fc_fov.0``). A
checkpoint key that no port key names is not read, as in the JAX converter;
the camera encoder is converted only when the checkpoint holds it.
``convert_da3_mono`` reads the mono / metric checkpoints (the same trunk and
DPT key grammar, every block a ``blocks_pre`` one, the sky branch at
``head.scratch.sky_output_conv2.{0,2}``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch.nn as nn

from videogpa_torch.models.da3.config import DA3Config

_PRE = "backbone.pretrained."
_RULES = (
    (re.compile(r"^backbone\.patch_embed\."), _PRE + "patch_embed.proj."),
    (re.compile(r"^backbone\.blocks_pre\.(\d+)\."), _PRE + r"blocks.\1."),
    (re.compile(r"^backbone\."), _PRE),
    (re.compile(r"^head\.resize(\d)\."), r"head.resize_layers.\1."),
    (re.compile(r"^head\.layer_rn\.(\d)\."), lambda m: f"head.scratch.layer{int(m[1]) + 1}_rn."),
    (re.compile(r"^head\.(refinenet\d(?:_aux)?)\.rcu(\d)\."), r"head.scratch.\1.resConfUnit\2."),
    (re.compile(r"^head\.(refinenet\d(?:_aux)?)\.out_conv\."), r"head.scratch.\1.out_conv."),
    (re.compile(r"^head\.output_conv1\."), "head.scratch.output_conv1."),
    (re.compile(r"^head\.output_conv2a\."), "head.scratch.output_conv2.0."),
    (re.compile(r"^head\.output_conv2b\."), "head.scratch.output_conv2.2."),
    (re.compile(r"^head\.output_conv1_aux\."), "head.scratch.output_conv1_aux."),
    (re.compile(r"^head\.sky_conv2a\."), "head.scratch.sky_output_conv2.0."),
    (re.compile(r"^head\.sky_conv2b\."), "head.scratch.sky_output_conv2.2."),
    # Sequential(conv3x3, Permute, LayerNorm, Permute, ReLU, conv1x1)
    (re.compile(r"^head\.output_conv2a_aux\."), "head.scratch.output_conv2_aux.3.0."),
    (re.compile(r"^head\.output_conv2_ln_aux\."), "head.scratch.output_conv2_aux.3.2."),
    (re.compile(r"^head\.output_conv2b_aux\."), "head.scratch.output_conv2_aux.3.5."),
    (re.compile(r"^cam_dec\.backbone1\."), "cam_dec.backbone.0."),
    (re.compile(r"^cam_dec\.backbone2\."), "cam_dec.backbone.2."),
    (re.compile(r"^cam_dec\.fc_fov\."), "cam_dec.fc_fov.0."),
)
_ALT = re.compile(r"^backbone\.blocks_alt\.(\d+)\.")
_CAM_ENC_MARKER = "cam_enc.token_norm.weight"


def _upstream_key(key: str, cfg: DA3Config) -> str:
    m = _ALT.match(key)
    if m:
        return f"{_PRE}blocks.{cfg.alt_start + int(m[1])}." + key[m.end():]
    for pattern, repl in _RULES:
        new, n = pattern.subn(repl, key, count=1)
        if n:
            return new
    return key


def _port_keys(cfg: DA3Config, cam_enc: bool):
    from videogpa_torch.models.da3.model import DA3

    return list(DA3(cfg, cam_enc=cam_enc, device="meta").state_dict())


def convert_da3(sd: Mapping[str, np.ndarray], cfg: DA3Config) -> Dict[str, np.ndarray]:
    """A normalised DA3 checkpoint -> ``DA3(cfg, cam_enc=...)`` state dict
    (numpy), with ``cam_enc.*`` only where the checkpoint holds the camera
    encoder. Raises ``KeyError`` naming the first checkpoint key it lacks."""
    return {key: np.asarray(sd[_upstream_key(key, cfg)])
            for key in _port_keys(cfg, _CAM_ENC_MARKER in sd)}


def convert_da3_mono(sd: Mapping[str, np.ndarray], cfg: DA3Config) -> Dict[str, np.ndarray]:
    """A da3mono / da3metric checkpoint (reference ``configs/da3mono-large.yaml``:
    all ``cfg.depth`` blocks plain, ``model/dpt.py::DPT`` with the sky head)
    -> ``DA3Mono`` state dict (numpy). The head's input LayerNorm is read
    where the checkpoint holds ``head.norm`` (build ``DA3Mono(cfg,
    input_norm=True)`` then), as JAX's ``t_layernorm`` does. Raises
    ``KeyError`` naming the first checkpoint key it lacks."""
    from videogpa_torch.models.da3.mono import DA3Mono

    keys = DA3Mono(cfg, input_norm="head.norm.weight" in sd, device="meta").state_dict()
    return {key: np.asarray(sd[_upstream_key(key, cfg)]) for key in keys}


def _convert_part(sd: Mapping[str, np.ndarray], part: nn.Module, port_pfx: str,
                  pfx: str) -> Dict[str, np.ndarray]:
    cfg = DA3Config()
    out = {}
    for key in part.state_dict():
        up = _upstream_key(f"{port_pfx}.{key}", cfg)
        out[key] = np.asarray(sd[pfx + up[len(port_pfx):]])
    return out


def convert_camera_dec(sd: Mapping[str, np.ndarray], pfx: str = "cam_dec") -> Dict[str, np.ndarray]:
    """CameraDec (reference ``model/cam_dec.py:19-45``) -> ``CameraDec``'s
    state dict, its width read from the checkpoint."""
    from videogpa_torch.models.da3.heads import CameraDec

    dim = np.asarray(sd[f"{pfx}.backbone.0.weight"]).shape[0]
    return _convert_part(sd, CameraDec(dim, device="meta"), "cam_dec", pfx)


def convert_camera_enc(sd: Mapping[str, np.ndarray], pfx: str = "cam_enc") -> Dict[str, np.ndarray]:
    """CameraEnc (reference ``model/cam_enc.py:23-80``) -> ``CameraEnc``'s
    state dict, its width read from the checkpoint."""
    from videogpa_torch.models.da3.heads import CameraEnc

    dim = np.asarray(sd[f"{pfx}.token_norm.weight"]).shape[0]
    return _convert_part(sd, CameraEnc(dim, device="meta"), "cam_enc", pfx)


def export_da3(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_da3``: a ``DA3`` -> f32 numpy arrays under the
    checkpoint's keys (a normalised DA3 checkpoint)."""
    return {_upstream_key(k, model.cfg): v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def normalize_da3_state_dict(sd: Mapping[str, np.ndarray], is_metric: bool = False) -> dict:
    """Raw DA3 training-dump keys -> the module-tree layout
    (reference ``utils/model_loading.py::convert_general_state_dict``
    (:25-72) / ``convert_metric_state_dict`` (:75-88)), then the api
    wrapper's ``model.`` prefix stripped (``api.py:89``). HF-hub checkpoints
    are normalised already: a no-op for them."""
    if is_metric:
        sd = {"module." + k: v for k, v in sd.items()}
    renames = [
        ("module.", "model."),
        (".net.", ".backbone."),
        (".camera_token_extra", ".camera_token"),
        ("model.all_heads.camera_cond_head", "model.cam_enc"),
        ("model.all_heads.camera_head", "model.cam_dec"),
        (".more_mlps.", ".backbone."),
        (".fc_rot.", ".fc_qvec."),
        ("model.all_heads.head", "model.head"),
        ("output_conv2_additional.sky_mask", "sky_output_conv2"),
        ("_ray.", "_aux."),
        ("gaussian_param_head.", "gs_head."),
    ]
    out = dict(sd)
    for old, new in renames:
        out = {k.replace(old, new): v for k, v in out.items()}
        # the old camera_token goes AFTER the module-prefix rename and BEFORE
        # camera_token_extra takes its name (model_loading.py:39-45)
        if old == ".net.":
            out.pop("model.backbone.pretrained.camera_token", None)
    return {(k[len("model."):] if k.startswith("model.") else k): v for k, v in out.items()}
