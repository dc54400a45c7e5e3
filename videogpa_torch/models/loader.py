"""Checkpoint loading: local HF-layout directories -> the port's modules
(``videogpa_tpu/models/loader.py``).

No network access is assumed: ``resolve_model_dir`` accepts a filesystem
path or resolves a HF repo id against ``$VIDEOGPA_MODELS_DIR`` or the local
HF cache. Multi-shard safetensors (``*.safetensors.index.json``) are read
through their index; bf16 tensors widen to f32 on the host and each module
is built on the device in the dtype asked for. The DA3 loader is not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from videogpa_torch.device import resolve_device
from videogpa_torch.utils.safetensors_np import bf16_bits_to_f32, load_file


def resolve_model_dir(name_or_path: str, subfolder: Optional[str] = None) -> str:
    """A model directory: the path itself, ``$VIDEOGPA_MODELS_DIR/<name>``
    (with ``/`` as ``--``, or the base name), or the newest snapshot in the
    local huggingface hub cache."""
    candidates = [name_or_path]
    env_root = os.environ.get("VIDEOGPA_MODELS_DIR")
    if env_root:
        candidates.append(os.path.join(env_root, name_or_path.replace("/", "--")))
        candidates.append(os.path.join(env_root, os.path.basename(name_or_path)))
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    repo_cache = os.path.join(
        hf_home, "hub", f"models--{name_or_path.replace('/', '--')}", "snapshots")
    if os.path.isdir(repo_cache):
        snaps = sorted(os.listdir(repo_cache))
        if snaps:
            candidates.append(os.path.join(repo_cache, snaps[-1]))
    for c in candidates:
        d = os.path.join(c, subfolder) if subfolder else c
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(
        f"cannot resolve model '{name_or_path}'"
        + (f" (subfolder {subfolder})" if subfolder else "")
        + "; set VIDEOGPA_MODELS_DIR or pass a local path")


def load_safetensors_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """Every safetensors shard of a directory (through the index where there
    is one; else every ``*.safetensors``, else torch ``.bin``/``.pt``) as one
    numpy state dict."""
    files = os.listdir(model_dir)
    index_files = [f for f in files if f.endswith(".safetensors.index.json")]
    sd: Dict[str, np.ndarray] = {}
    if index_files:
        with open(os.path.join(model_dir, index_files[0])) as f:
            index = json.load(f)
        for shard in sorted(set(index["weight_map"].values())):
            sd.update(load_file(os.path.join(model_dir, shard)))
        return sd
    st_files = sorted(f for f in files if f.endswith(".safetensors"))
    if not st_files:
        bins = sorted(f for f in files if f.endswith(".bin") or f.endswith(".pt"))
        if not bins:
            raise FileNotFoundError(f"no weights found in {model_dir}")
        from videogpa_torch.convert import load_torch_state_dict

        for b in bins:
            sd.update(load_torch_state_dict(os.path.join(model_dir, b)))
        return sd
    for f in st_files:
        sd.update(load_file(os.path.join(model_dir, f)))
    return sd


def _to_f32(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Widen bf16 to f32: ml_dtypes bfloat16 arrays by value, and uint16
    arrays (some exporters store bf16 as raw 16-bit words) by their bits."""
    out = {}
    for k, v in sd.items():
        if v.dtype == np.dtype("uint16"):
            v = bf16_bits_to_f32(v)
        elif "bfloat16" in str(v.dtype):
            v = v.astype(np.float32)
        out[k] = v
    return out


def _module_from_state_dict(module_cls, cfg, sd: Dict[str, np.ndarray], device,
                            dtype: torch.dtype):
    """``module_cls(cfg)`` allocated on ``device`` in ``dtype`` holding ``sd``
    (strict: every key on both sides), one tensor at a time."""
    model = module_cls(cfg, device="meta", dtype=dtype).to_empty(device=device)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)
    return model.requires_grad_(False)


def load_cogvideox(model_name_or_path: str, cfg=None, dtype: torch.dtype = torch.float32,
                   device=None):
    """A diffusers-layout CogVideoX checkpoint (``transformer/``, ``vae/``)
    -> (``CogVideoXTransformer``, ``CogVideoXVAE``) on ``device`` (the card
    unless ``device="cpu"``) in ``dtype``."""
    from videogpa_torch.models.cogvideox.config import CogVideoXConfig
    from videogpa_torch.models.cogvideox.convert import convert_dit
    from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer

    cfg = cfg or CogVideoXConfig.cogvideox_5b()
    device = resolve_device(device)
    dit_sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path, "transformer")))
    dit = _module_from_state_dict(CogVideoXTransformer, cfg, convert_dit(dit_sd, cfg), device,
                                  dtype)
    del dit_sd
    return dit, load_cogvideox_vae(model_name_or_path, cfg, dtype, device)


def load_cogvideox_vae(model_name_or_path: str, cfg=None, dtype: torch.dtype = torch.float32,
                       device=None):
    """The ``vae/`` of a diffusers-layout CogVideoX checkpoint ->
    ``CogVideoXVAE`` on ``device`` in ``dtype`` (the encode CLI needs no
    DiT)."""
    from videogpa_torch.models.cogvideox.config import CogVideoXConfig
    from videogpa_torch.models.cogvideox.convert import convert_vae
    from videogpa_torch.models.cogvideox.vae import CogVideoXVAE

    cfg = cfg or CogVideoXConfig.cogvideox_5b()
    sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path, "vae")))
    return _module_from_state_dict(CogVideoXVAE, cfg, convert_vae(sd, cfg),
                                   resolve_device(device), dtype)


def load_t5(model_name_or_path: str, cfg=None, dtype: torch.dtype = torch.float32,
            device=None) -> Tuple[torch.nn.Module, object]:
    """The ``text_encoder/`` of a diffusers-layout checkpoint -> (``T5Encoder``
    on ``device`` in ``dtype``, its config)."""
    from videogpa_torch.models.t5.encoder import T5Config, T5Encoder, convert_t5_encoder

    cfg = cfg or T5Config.t5_v1_1_xxl()
    sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path, "text_encoder")))
    return _module_from_state_dict(T5Encoder, cfg, convert_t5_encoder(sd, cfg),
                                   resolve_device(device), dtype), cfg


def load_vggt(model_name_or_path: str = "facebook/VGGT-1B", cfg=None,
              dtype: torch.dtype = torch.float32, device=None):
    """A facebook/VGGT-1B-layout checkpoint directory -> (``VGGT`` on
    ``device`` (the card unless ``device="cpu"``) in ``dtype``, its config)."""
    from videogpa_torch.models.vggt.config import VGGTConfig
    from videogpa_torch.models.vggt.convert import convert_vggt
    from videogpa_torch.models.vggt.model import VGGT

    cfg = cfg or VGGTConfig()
    sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path)))
    return _module_from_state_dict(VGGT, cfg, convert_vggt(sd, cfg), resolve_device(device),
                                   dtype), cfg


def load_wan(model_name_or_path: str, cfg=None, dtype: torch.dtype = torch.float32,
             device=None):
    """The ``WanModel`` safetensors at the root of a Wan2.2 checkpoint
    directory (through ``convert_wan``) -> ``WanTransformer`` on ``device``
    in ``dtype``. The JAX package's Wan entry points do this inline."""
    from videogpa_torch.models.wan.config import WanConfig
    from videogpa_torch.models.wan.convert import convert_wan
    from videogpa_torch.models.wan.dit import WanTransformer

    cfg = cfg or WanConfig.ti2v_5b()
    sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path)))
    return _module_from_state_dict(WanTransformer, cfg, convert_wan(sd, cfg),
                                   resolve_device(device), dtype)


def load_wan_vae(model_name_or_path: str, cfg=None, dtype: torch.dtype = torch.float32,
                 device=None):
    """The Wan2.2 VAE -> ``WanVAE`` on ``device`` (the card unless
    ``device="cpu"``) in ``dtype``.

    Reads the native checkpoint the reference uses (a ``*VAE*.pth`` at the
    model root, ``wan/modules/vae2_2.py`` keys), else the ``vae/``
    safetensors. ``latents_mean`` / ``latents_std`` are not in the native
    checkpoint (the Wan repo hard-codes them): they come from a
    ``vae_stats.json`` side file or ``vae/config.json`` where present."""
    from videogpa_torch.convert import load_torch_state_dict
    from videogpa_torch.models.wan.config import WanConfig
    from videogpa_torch.models.wan.convert import convert_wan_vae
    from videogpa_torch.models.wan.vae import WanVAE

    cfg = cfg or WanConfig.ti2v_5b()
    root = resolve_model_dir(model_name_or_path)
    mean = std = None
    for stats_file in (os.path.join(root, "vae_stats.json"),
                       os.path.join(root, "vae", "config.json")):
        if os.path.isfile(stats_file):
            with open(stats_file) as f:
                j = json.load(f)
            if "latents_mean" in j and "latents_std" in j:
                mean, std = j["latents_mean"], j["latents_std"]
                break
    pths = sorted(f for f in os.listdir(root) if f.endswith(".pth") and "VAE" in f.upper())
    if pths:
        sd = _to_f32(load_torch_state_dict(os.path.join(root, pths[0])))
    else:
        sd = _to_f32(load_safetensors_dir(resolve_model_dir(model_name_or_path, "vae")))
    return _module_from_state_dict(WanVAE, cfg, convert_wan_vae(sd, cfg, mean, std),
                                   resolve_device(device), dtype)
