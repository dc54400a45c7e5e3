"""The port's VGGT and LPIPS converters and ``load_vggt`` against the JAX
package's: a state dict in the upstream checkpoints' key layout goes through
the JAX converter + bridge and through the port's converter, and the two
module state dicts are equal key for key (``tests/test_full_layout_conversion.py``'s
``TestVGGTFullLayout``, ``tests/test_lpips_parity.py``'s ``TestLPIPSParity``
key map). The upstream VGGT layout is ``export_vggt`` of a port module (the
generator ``chip_smoke.py`` writes its VGGT-1B checkpoint with); the JAX
converter reading every one of its keys ties that layout to the JAX
package's key grammar. Every comparison is exact: conversion only renames."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import videogpa_tpu.models.loader as jloader
import videogpa_tpu.models.lpips.lpips as jlpips
import videogpa_tpu.models.vggt.convert as jconv
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_torch.convert import state_dict_from_jax
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.lpips import LPIPS, convert_lpips, lpips_distance
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward, vggt_init
from videogpa_torch.models.vggt import convert as tconv
from videogpa_torch.utils.safetensors_np import save_file
from test_lpips_parity import OracleLPIPS

torch.set_num_threads(2)

# keys of the real checkpoint that no converter reads
_UNUSED = {"aggregator.patch_embed.mask_token": (1, 32),
           "track_head.feature_extractor.norm.weight": (8,)}
# the full 24 + 24-block, 4-trunk key grammar at narrow, distinct widths
FULL_DEPTH = dataclasses.replace(
    VGGTConfig(), img_size=56, backbone_dim=24, backbone_heads=2, embed_dim=32, num_heads=2,
    dpt_features=8, dpt_out_channels=(8, 16, 24, 40))


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
    model = vggt_init(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    sd = tconv.export_vggt(model)
    sd.update({k: np.zeros(s, np.float32) for k, s in _UNUSED.items()})
    return model, sd


@pytest.mark.parametrize("cfg", [VGGTConfig.tiny(), FULL_DEPTH], ids=["tiny", "full_depth"])
def test_convert_vggt_equals_jax_converter_and_bridge(cfg):
    model, sd = _upstream(cfg, seed=1)
    tracked = _TrackingDict(sd)
    want = _bridged(jconv.convert_vggt(tracked, JaxVGGTConfig(**dataclasses.asdict(cfg))))
    got = tconv.convert_vggt(sd, cfg)
    _assert_equal_sd(got, want)
    # the JAX converter reads every key export_vggt writes, and nothing else
    assert set(sd) - tracked.used == set(_UNUSED)
    # and the conversion round-trips the module it was written from
    _assert_equal_sd(got, {k: v.numpy() for k, v in model.state_dict().items()})


def test_convert_vggt_takes_the_1b_layout_at_full_width():
    """VGGT-1B's names and shapes as zero-stride stand-ins (nothing is
    materialised): every module key of the port gets its tensor."""
    cfg = VGGTConfig()
    meta = VGGT(cfg, device="meta").state_dict()
    sd = _TrackingDict({tconv._upstream_key(k): np.broadcast_to(np.float32(0), tuple(v.shape))
                        for k, v in meta.items()})
    got = tconv.convert_vggt(sd, cfg)
    assert set(got) == set(meta) and len(sd.used) == len(sd)
    assert all(got[k].shape == tuple(v.shape) for k, v in meta.items())
    assert sum(int(np.prod(v.shape)) for v in meta.values()) > 1.1e9  # VGGT-1B, no track head
    # a head absent from the checkpoint is left out, as the JAX converter does
    no_point = {k: v for k, v in sd.items() if not k.startswith("point_head.")}
    assert not any(k.startswith("point_head.") for k in tconv.convert_vggt(no_point, cfg))
    with pytest.raises(KeyError, match="aggregator.camera_token"):
        tconv.convert_vggt({k: v for k, v in sd.items() if k != "aggregator.camera_token"}, cfg)


def test_load_vggt_reads_a_checkpoint_directory_as_the_jax_loader(tmp_path):
    cfg = VGGTConfig.tiny()
    model, sd = _upstream(cfg, seed=2)
    save_file(sd, str(tmp_path / "model.safetensors"))
    loaded, got_cfg = tloader.load_vggt(str(tmp_path), cfg, device="cpu")
    assert got_cfg == cfg and isinstance(loaded, VGGT)
    assert not any(p.requires_grad for p in loaded.parameters())
    _assert_equal_sd({k: v.numpy() for k, v in loaded.state_dict().items()},
                     {k: v.numpy() for k, v in model.state_dict().items()})
    jparams, _ = jloader.load_vggt(str(tmp_path), JaxVGGTConfig.tiny())
    _assert_equal_sd({k: v.numpy() for k, v in loaded.state_dict().items()}, _bridged(jparams))
    # the loaded module computes what the module it was written from computes
    images = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (1, 2, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    want = vggt_forward(model, images, compute_dtype=torch.float32)
    got = vggt_forward(loaded, images, compute_dtype=torch.float32)
    for key in ("pose_enc", "depth", "depth_conf", "world_points"):
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


@pytest.mark.parametrize("lin_prefix", ["lin{}", "lins.{}"])
def test_convert_lpips_equals_jax_converter_and_bridge(lin_prefix):
    torch.manual_seed(0)
    oracle = OracleLPIPS().eval()
    for lin in oracle.lins:
        lin[1].weight.data.abs_()
    vgg_sd = {f"features.{k[len('net.features.'):]}": v.numpy()
              for k, v in oracle.state_dict().items() if k.startswith("net.features.")}
    lin_sd = {f"{lin_prefix.format(i)}.model.1.weight": oracle.lins[i][1].weight.detach().numpy()
              for i in range(5)}
    got = convert_lpips(vgg_sd, lin_sd)
    _assert_equal_sd(got, _bridged(jlpips.convert_lpips(vgg_sd, lin_sd)))
    model = LPIPS()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    rng = np.random.default_rng(0)
    x, y = (rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        d = lpips_distance(model, torch.from_numpy(x), torch.from_numpy(y))
        want = oracle(torch.from_numpy(x), torch.from_numpy(y))
    torch.testing.assert_close(d, want, atol=1e-5, rtol=1e-4)
