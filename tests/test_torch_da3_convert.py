"""The port's DA3 converters and ``load_da3`` against the JAX package's: a
state dict in the DA3 checkpoints' key layout goes through JAX's
``convert_da3`` + the bridge and through the port's ``convert_da3``, and the
two module state dicts are equal key for key. The layout is ``export_da3`` of
a port module (what ``chip_smoke.py`` writes its DA3-Large checkpoint with)
plus keys no converter reads; JAX's converter reading every exported key
ties it to the JAX package's key grammar. ``normalize_da3_state_dict`` turns
a raw training dump (``module.``, ``net.``, ``all_heads.``, ``_ray``,
``fc_rot``, ``camera_token_extra``) into that layout in both packages, and
``load_da3`` reads either from a safetensors directory. Every comparison is
exact: conversion only renames."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import videogpa_tpu.models.da3.convert as jconv
import videogpa_tpu.models.loader as jloader
from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_torch.convert import state_dict_from_jax
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.da3 import DA3, DA3Config, da3_forward, da3_init
from videogpa_torch.models.da3 import convert as tconv
from videogpa_torch.utils.safetensors_np import save_file

torch.set_num_threads(2)

# keys of the real checkpoint layout that no converter reads: the aux head's
# output_conv2 of the first three levels, DINOv2's mask token
_UNUSED = {"head.scratch.output_conv2_aux.0.0.weight": (32, 8, 3, 3),
           "head.scratch.output_conv2_aux.2.5.bias": (7,),
           "backbone.pretrained.mask_token": (1, 32)}
# the full 24-block grammar (alt_start 8, out layers 11/15/19/23) at narrow widths
FULL_DEPTH = dataclasses.replace(DA3Config.large(), img_size=56, embed_dim=32, num_heads=2,
                                 dpt_features=16, dpt_out_channels=(8, 16, 24, 40))


class _TrackingDict(dict):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def _bridged(jax_tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax(jax.tree.map(np.asarray, jax_tree)).items()}


def _assert_equal_sd(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _upstream(cfg, seed):
    model = da3_init(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    sd = tconv.export_da3(model)
    sd.update({k: np.zeros(s, np.float32) for k, s in _UNUSED.items()})
    return model, sd


def _module_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("cfg", [DA3Config.tiny(), FULL_DEPTH], ids=["tiny", "full_depth"])
def test_convert_da3_equals_jax_converter_and_bridge(cfg):
    model, sd = _upstream(cfg, seed=1)
    tracked = _TrackingDict(sd)
    want = _bridged(jconv.convert_da3(tracked, JaxDA3Config(**dataclasses.asdict(cfg))))
    got = tconv.convert_da3(sd, cfg)
    _assert_equal_sd(got, want)
    assert set(sd) - tracked.used == set(_UNUSED)
    _assert_equal_sd(got, _module_sd(model))
    # the reference's names: the list of blocks, the DPT scratch, the camera MLPs
    for key in (f"backbone.pretrained.blocks.{cfg.depth - 1}.attn.q_norm.weight",
                "backbone.pretrained.patch_embed.proj.weight",
                "head.scratch.refinenet1_aux.resConfUnit1.conv1.weight",
                "head.scratch.output_conv2_aux.3.2.weight", "head.resize_layers.3.weight",
                "cam_dec.backbone.2.weight", "cam_dec.fc_fov.0.bias",
                "cam_enc.trunk.3.ls2.gamma"):
        assert key in sd, key
    # the camera MLPs alone, as the JAX package's convert_camera_{dec,enc}
    for name, fn, jfn in (("cam_dec", tconv.convert_camera_dec, jconv.convert_camera_dec),
                          ("cam_enc", tconv.convert_camera_enc, jconv.convert_camera_enc)):
        _assert_equal_sd(fn(sd), _bridged(jfn(sd)))
        _assert_equal_sd(fn(sd), _module_sd(getattr(model, name)))


def test_convert_da3_without_a_camera_encoder():
    """A checkpoint without ``cam_enc`` gives a module without one, as the
    JAX tree leaves it out; a missing key raises, naming it."""
    cfg = DA3Config.tiny()
    _, sd = _upstream(cfg, seed=2)
    no_enc = {k: v for k, v in sd.items() if not k.startswith("cam_enc.")}
    got = tconv.convert_da3(no_enc, cfg)
    assert not any(k.startswith("cam_enc.") for k in got)
    _assert_equal_sd(got, _bridged(jconv.convert_da3(no_enc, JaxDA3Config.tiny())))
    DA3(cfg, cam_enc=False).load_state_dict({k: torch.from_numpy(v) for k, v in got.items()})
    with pytest.raises(KeyError, match="backbone.pretrained.camera_token"):
        tconv.convert_da3({k: v for k, v in sd.items()
                           if k != "backbone.pretrained.camera_token"}, cfg)


def _raw_dump(sd):
    """The training-dump names of a normalised checkpoint (the inverse of
    ``normalize_da3_state_dict``), with a stale ``camera_token`` beside the
    ``camera_token_extra`` that replaces it."""
    raw = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            k = "module.net." + k[len("backbone."):]
            k = k.replace(".camera_token", ".camera_token_extra")
        elif k.startswith("head."):
            k = "module.all_heads." + k.replace("_aux.", "_ray.")
        elif k.startswith("cam_dec."):
            k = "module.all_heads.camera_head." + k[len("cam_dec."):].replace(".fc_qvec.",
                                                                            ".fc_rot.")
        elif k.startswith("cam_enc."):
            k = "module.all_heads.camera_cond_head." + k[len("cam_enc."):]
        raw[k] = v
    raw["module.net.pretrained.camera_token"] = np.full((1, 2, 32), 7.0, np.float32)
    return raw


def test_normalize_da3_state_dict_matches_jax():
    _, sd = _upstream(DA3Config.tiny(), seed=3)
    raw = _raw_dump(sd)
    got = tconv.normalize_da3_state_dict(raw)
    _assert_equal_sd(got, jconv.normalize_da3_state_dict(raw))
    _assert_equal_sd(got, sd)
    # metric checkpoints carry no module. prefix
    bare = {k[len("module."):]: v for k, v in raw.items()}
    _assert_equal_sd(tconv.normalize_da3_state_dict(bare, is_metric=True), sd)
    # the HF-hub layout is normalised already
    _assert_equal_sd(tconv.normalize_da3_state_dict(sd), sd)


@pytest.mark.parametrize("layout", ["hub", "raw_dump"])
def test_load_da3_reads_a_checkpoint_directory_as_the_jax_loader(tmp_path, layout):
    cfg = DA3Config.tiny()
    model, sd = _upstream(cfg, seed=4)
    save_file(_raw_dump(sd) if layout == "raw_dump" else sd,
              str(tmp_path / "model.safetensors"))
    loaded, got_cfg = tloader.load_da3(str(tmp_path), cfg, device="cpu")
    assert got_cfg == cfg and isinstance(loaded, DA3) and loaded.cam_enc is not None
    assert not any(p.requires_grad for p in loaded.parameters())
    _assert_equal_sd(_module_sd(loaded), _module_sd(model))
    jparams, _ = jloader.load_da3(str(tmp_path), JaxDA3Config.tiny())
    _assert_equal_sd(_module_sd(loaded), _bridged(jparams))
    images = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    with torch.no_grad():
        want, got = da3_forward(model, images), da3_forward(loaded, images)
    for key in ("depth", "depth_conf", "extrinsics", "intrinsics"):
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


def test_convert_da3_takes_the_large_layout_at_full_width():
    """DA3-Large's names and shapes as zero-stride stand-ins (nothing is
    materialised): every module key of the port gets its tensor."""
    cfg = DA3Config.large()
    meta = DA3(cfg, device="meta").state_dict()
    sd = _TrackingDict({tconv._upstream_key(k, cfg): np.broadcast_to(np.float32(0),
                                                                     tuple(v.shape))
                        for k, v in meta.items()})
    got = tconv.convert_da3(sd, cfg)
    assert set(got) == set(meta) and len(sd.used) == len(sd)
    assert all(got[k].shape == tuple(v.shape) for k, v in meta.items())
    n = sum(int(np.prod(v.shape)) for v in meta.values())
    assert 0.3e9 < n < 0.5e9, n  # DA3-Large: ViT-L + DualDPT + camera MLPs
