"""The port's Wan2.2 converters and loaders (``videogpa_torch/models/wan/
convert.py``, ``models/loader.py::load_wan`` / ``load_wan_vae``) against
the JAX package's.

- Every key of the full Wan2.2-TI2V-5B DiT layout (30 layers, at scaled
  widths) and of the full VAE layout is read, and the converted state dict
  is the port's module's, key for key and shape for shape, on the ``meta``
  device (``tests/test_full_layout_conversion.py::TestWanFullLayout``).
- ``convert_wan`` and ``convert_wan_vae`` of the torch oracles' state dicts
  (``tests/test_wan_parity.py``, ``tests/test_wan_vae_parity.py``) equal the
  JAX converters' trees through the weight bridge, exactly.
- ``load_wan_vae`` reads the native ``Wan2.2_VAE.pth`` with
  ``vae_stats.json`` and the ``vae/`` safetensors with ``vae/config.json``,
  as the JAX loader does, exactly.
- ``load_wan`` of a root-layout safetensors checkpoint runs ``wan_forward``
  as JAX's ``wan_forward`` runs ``convert_wan`` of the same file (f32,
  max |delta| within 2e-5 + 1e-4 relative, ``tests/test_torch_wan.py``'s
  tolerance).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_wan_parity import WanOracle
from test_wan_vae_parity import WanVAEOracle
from videogpa_tpu.models import loader as jloader
from videogpa_tpu.models.wan import convert as jconvert
from videogpa_tpu.models.wan import dit as jdit
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_torch.convert import state_dict_from_jax
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.wan import WanConfig, WanTransformer, WanVAE, wan_forward
from videogpa_torch.models.wan.convert import convert_wan, convert_wan_vae
from videogpa_torch.utils.safetensors_np import save_file

torch.set_num_threads(2)
CFG = WanConfig.tiny()
JCFG = JaxWanConfig(**dataclasses.asdict(CFG))


class _TrackingDict(dict):
    """Records which keys a converter read."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def _zeros_sd(module):
    """A module's state dict as zero-stride numpy stand-ins (no memory)."""
    return _TrackingDict({k: np.broadcast_to(np.float32(0), tuple(v.shape))
                          for k, v in module.state_dict().items()})


def _assert_same_layout(converted, module):
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(np.shape(v)) for k, v in converted.items()} == want


def _jax_sd(params):
    return {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, params)).items()}


def _assert_equal_sd(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)


def test_convert_wan_reads_the_full_5b_layout():
    full = WanConfig.ti2v_5b()
    # the 5B key layout at distinct scaled widths (the full 5B tensors would
    # take 20 GB of zero-stride views and as much to check)
    cfg = dataclasses.replace(full, dim=48, ffn_dim=80, num_heads=2, text_dim=24, freq_dim=16)
    jcfg = JaxWanConfig(**dataclasses.asdict(cfg))
    with torch.device("meta"):
        oracle, oracle_full = WanOracle(jcfg), WanOracle(JaxWanConfig.ti2v_5b())
        module, module_full = WanTransformer(cfg), WanTransformer(full)
    assert oracle.state_dict().keys() == oracle_full.state_dict().keys()
    assert module.state_dict().keys() == module_full.state_dict().keys()
    assert tuple(module_full.blocks[29].self_attn.q.weight.shape) == (3072, 3072)
    sd = _zeros_sd(oracle)
    _assert_same_layout(convert_wan(sd, cfg), module)
    assert [k for k in sd if k not in sd.used and k != "freqs"] == []


def test_convert_wan_vae_reads_the_full_layout():
    cfg = WanConfig.ti2v_5b()
    with torch.device("meta"):
        oracle = WanVAEOracle(dim=cfg.vae_base_ch, dec_dim=cfg.vae_dec_base_ch,
                              z_dim=cfg.vae_z_dim, dim_mult=cfg.vae_dim_mult,
                              n_res=cfg.vae_num_res_blocks, t_down=cfg.vae_temporal_down)
        module = WanVAE(cfg)
    sd = _zeros_sd(oracle)
    out = convert_wan_vae(sd, cfg)
    _assert_same_layout(out, module)
    assert out["encoder.conv_in.weight"].shape == (cfg.vae_base_ch, 12, 3, 3, 3)
    assert out["decoder.scales.0.resample.time_conv.weight"].shape == (2048, 1024, 3, 1, 1)
    assert [k for k in sd if k not in sd.used] == []


def _dit_sd(seed=0):
    torch.manual_seed(seed)
    oracle = WanOracle(JCFG)
    with torch.no_grad():  # the oracle's zero-init modulations and head get values
        for name, p in oracle.named_parameters():
            if "modulation" in name or name.startswith("head.") or "norm" in name:
                p.normal_(0.0, 0.3 if "modulation" in name else 0.1).add_(
                    1.0 if "norm" in name and name.endswith("weight") else 0.0)
    return {k: v.numpy() for k, v in oracle.state_dict().items() if k != "freqs"}


def _vae_sd(seed=0):
    torch.manual_seed(seed)
    oracle = WanVAEOracle(dim=CFG.vae_base_ch, dec_dim=CFG.vae_dec_base_ch, z_dim=CFG.vae_z_dim,
                          dim_mult=CFG.vae_dim_mult, n_res=CFG.vae_num_res_blocks,
                          t_down=CFG.vae_temporal_down)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if name.endswith("gamma"):
                p.uniform_(0.5, 1.5)
    return {k: v.numpy() for k, v in oracle.state_dict().items()}


def test_convert_wan_equals_the_jax_converter_through_the_bridge():
    sd = _dit_sd()
    _assert_equal_sd(convert_wan(sd, CFG), _jax_sd(jconvert.convert_wan(sd, JCFG)))


def test_convert_wan_vae_equals_the_jax_converter_through_the_bridge():
    sd = _vae_sd()
    rng = np.random.default_rng(1)
    mean, std = rng.standard_normal(6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    want = _jax_sd(jconvert.convert_wan_vae(sd, JCFG, latents_mean=mean, latents_std=std))
    _assert_equal_sd(convert_wan_vae(sd, CFG, mean, std), want)
    # a "model." prefix is dropped; no statistics means mean 0, std 1
    plain = convert_wan_vae({f"model.{k}": v for k, v in sd.items()}, CFG)
    assert np.array_equal(plain["latents_mean"], np.zeros(6, np.float32))
    assert np.array_equal(plain["latents_std"], np.ones(6, np.float32))
    assert np.array_equal(plain["decoder.conv_in.weight"], want["decoder.conv_in.weight"])


@pytest.mark.parametrize("route", ["pth", "safetensors"])
def test_load_wan_vae_reads_both_layouts_as_the_jax_loader(tmp_path, route):
    sd = _vae_sd(seed=3)
    rng = np.random.default_rng(4)
    stats = {"latents_mean": rng.standard_normal(6).tolist(),
             "latents_std": rng.uniform(0.5, 2, 6).tolist()}
    root = tmp_path / "wan"
    if route == "pth":
        root.mkdir()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "Wan2.2_VAE.pth")
        (root / "vae_stats.json").write_text(json.dumps(stats))
    else:
        (root / "vae").mkdir(parents=True)
        save_file(sd, str(root / "vae" / "diffusion_pytorch_model.safetensors"))
        (root / "vae" / "config.json").write_text(json.dumps({"z_dim": 6, **stats}))
    vae = tloader.load_wan_vae(str(root), CFG, device="cpu")
    assert isinstance(vae, WanVAE) and not any(p.requires_grad for p in vae.parameters())
    want = _jax_sd(jloader.load_wan_vae(str(root), JCFG))
    _assert_equal_sd({k: v.numpy() for k, v in vae.state_dict().items()}, want)
    np.testing.assert_allclose(vae.latents_std.numpy(), stats["latents_std"], rtol=1e-7)
    with pytest.raises(FileNotFoundError):
        tloader.load_wan_vae(str(tmp_path / "absent"), CFG, device="cpu")


def test_load_wan_runs_wan_forward_as_jax_runs_the_same_checkpoint(tmp_path):
    sd = _dit_sd(seed=5)
    save_file(sd, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    model = tloader.load_wan(str(tmp_path), CFG, device="cpu")
    assert isinstance(model, WanTransformer) and model.cfg == CFG
    params = jconvert.convert_wan(jloader._to_f32(jloader.load_safetensors_dir(str(tmp_path))),
                                  JCFG)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, CFG.in_channels, 3, 8, 8), dtype=np.float32)
    ctx = rng.standard_normal((2, CFG.text_len, CFG.text_dim), dtype=np.float32)
    t = np.array([37.0, 850.0], np.float32)
    want = np.asarray(jdit.wan_forward(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                       JCFG, attn_impl="xla", compute_dtype=jnp.float32))
    with torch.no_grad():
        got = wan_forward(model, torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx), compute_dtype=torch.float32)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    # bf16 storage (the trainer's) holds the same tensors rounded
    half = tloader.load_wan(str(tmp_path), CFG, dtype=torch.bfloat16, device="cpu")
    assert half.blocks[0].self_attn.q.weight.dtype == torch.bfloat16
    assert torch.equal(half.blocks[1].modulation,
                       model.blocks[1].modulation.to(torch.bfloat16))
