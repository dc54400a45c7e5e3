"""The port's checkpoint converters and loaders against the JAX package's: a
synthetic state dict with the real checkpoints' key names goes through the
JAX converter + bridge and through the port's converter, and the two module
state dicts are equal key for key (``tests/test_full_layout_conversion.py``'s
``TestCogVideoXFullLayout``, ``TestT5FullLayout``, ``TestMultiShardLoader``);
``export_dit`` round-trips; ``load_cogvideox`` / ``load_t5`` read a
diffusers-layout directory, bf16 shards included."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

import videogpa_tpu.models.cogvideox.convert as jconv
import videogpa_tpu.models.loader as jloader
import videogpa_tpu.models.t5.encoder as je
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxConfig
from videogpa_torch.convert import state_dict_from_jax
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.cogvideox import CogVideoXConfig, CogVideoXTransformer
from videogpa_torch.models.cogvideox import convert as tconv
from videogpa_torch.models.cogvideox.vae import CogVideoXVAE, vae_decode
from videogpa_torch.models.t5 import encoder as te
from videogpa_torch.utils.safetensors_np import save_file
from test_cogvideox_parity import OracleDiT
from test_cogvideox_vae_parity import OracleVAE

torch.set_num_threads(2)

# the full 42-layer key grammar at distinct scaled widths (test_full_layout_
# conversion's choice: transposes surface at any width when dims differ)
DIT_CFG = dataclasses.replace(CogVideoXConfig.cogvideox_5b(), num_heads=3, head_dim=16,
                              text_embed_dim=24, time_embed_dim=40)
# CogVideoX1.5-5B's: the Linear patch embed of pt x p x p x C inputs and a
# proj_out of that width
DIT15_CFG = dataclasses.replace(CogVideoXConfig.cogvideox_1_5_5b(), num_heads=3, head_dim=16,
                                text_embed_dim=24, time_embed_dim=40)


def _np_sd(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _jcfg(cfg):
    return JaxConfig(**dataclasses.asdict(cfg))


def _assert_equal_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _bridged(jax_tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
            .items()}


@pytest.fixture(scope="module", params=[DIT_CFG, DIT15_CFG], ids=["5b", "1_5"])
def dit_case(request):
    torch.manual_seed(0)
    return request.param, _np_sd(OracleDiT(request.param))


def test_convert_dit_equals_jax_converter_and_bridge(dit_case):
    cfg, dit_sd = dit_case
    got = tconv.convert_dit(dit_sd, cfg)
    _assert_equal_sd(got, _bridged(jconv.convert_dit(dit_sd, _jcfg(cfg))))
    model = CogVideoXTransformer(cfg, device="meta")
    assert set(model.state_dict()) == set(got)
    assert all(tuple(model.state_dict()[k].shape) == v.shape for k, v in got.items())


def test_export_dit_round_trips_and_equals_jax(dit_case):
    cfg, dit_sd = dit_case
    model = CogVideoXTransformer(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           tconv.convert_dit(dit_sd, cfg).items()}, strict=True)
    out = tconv.export_dit(model, cfg)
    _assert_equal_sd(out, dit_sd)  # every checkpoint key, back where it came from
    want = jconv.export_dit(jconv.convert_dit(dit_sd, _jcfg(cfg)), _jcfg(cfg))
    _assert_equal_sd(out, want)


@pytest.mark.parametrize("cfg", [CogVideoXConfig.tiny(), CogVideoXConfig.cogvideox_5b()],
                         ids=["tiny", "5b_keys"])
def test_convert_vae_equals_jax_converter_and_bridge(cfg):
    if cfg.vae_block_out_channels[0] > 8:
        # the real 5B VAE key grammar and shapes, without materialising it
        with torch.device("meta"):
            oracle = OracleVAE(cfg)
        sd = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
              for k, v in oracle.state_dict().items()}
        got = tconv.convert_vae(sd, cfg)
        assert set(got) == set(sd_keys := CogVideoXVAE(cfg, device="meta").state_dict())
        assert all(tuple(sd_keys[k].shape) == v.shape for k, v in got.items())
        assert len(got) == len(sd)  # every checkpoint key read
        return
    torch.manual_seed(1)
    oracle = OracleVAE(cfg).eval()
    sd = _np_sd(oracle)
    got = tconv.convert_vae(sd, cfg)
    _assert_equal_sd(got, _bridged(jconv.convert_vae(sd, _jcfg(cfg))))
    # and the loaded VAE decodes as the diffusers-named oracle does
    vae = CogVideoXVAE(cfg)
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    z = torch.randn(1, cfg.vae_latent_channels, 3, 4, 4, generator=torch.Generator()
                    .manual_seed(2))  # 1 + 2k latent frames, the causal pattern
    torch.testing.assert_close(vae_decode(vae, z * cfg.vae_scaling_factor, cfg),
                               oracle.decode(z), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["t5_v1_1_xxl", "umt5_xxl"])
def test_convert_t5_full_layout_equals_jax(variant):
    full = getattr(te.T5Config, variant)()
    cfg = dataclasses.replace(full, vocab_size=128, d_model=64, d_kv=8, d_ff=40, num_heads=4)
    hf_cls, hf_cfg_cls = ((transformers.UMT5EncoderModel, transformers.UMT5Config)
                          if variant == "umt5_xxl"
                          else (transformers.T5EncoderModel, transformers.T5Config))
    torch.manual_seed(3)
    hf = hf_cls(hf_cfg_cls(vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
                           d_ff=cfg.d_ff, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                           feed_forward_proj="gated-gelu"))
    sd = _np_sd(hf)
    got = te.convert_t5_encoder(sd, cfg)
    _assert_equal_sd(got, _bridged(je.convert_t5_encoder(sd, je.T5Config(
        **dataclasses.asdict(cfg)))))
    assert set(got) == set(te.T5Encoder(cfg, device="meta").state_dict())
    n_bias = sum(k.endswith("rel_bias") for k in got)
    assert n_bias == (cfg.num_layers if variant == "umt5_xxl" else 1)


def test_sharded_safetensors_with_index(tmp_path):
    rng = np.random.default_rng(0)
    a = {"transformer_blocks.0.attn1.to_q.weight": rng.standard_normal((8, 8)).astype(np.float32)}
    b = {"transformer_blocks.1.attn1.to_q.weight": rng.standard_normal((8, 8)).astype(np.float32),
         "proj_out.weight": rng.standard_normal((4, 8)).astype(np.float32)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    index = {"weight_map": {**{k: "model-00001-of-00002.safetensors" for k in a},
                            **{k: "model-00002-of-00002.safetensors" for k in b}}}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(index))
    # a stray shard that the index does not name is not read
    save_file({"stray.weight": np.zeros(2, np.float32)}, str(tmp_path / "stray.safetensors"))
    sd = tloader.load_safetensors_dir(str(tmp_path))
    _assert_equal_sd(sd, jloader.load_safetensors_dir(str(tmp_path)))
    assert set(sd) == set(a) | set(b)


def test_to_f32_widens_bf16_by_value_and_by_bits():
    vals = torch.tensor([1.0, -2.5, 3.140625, 1e-3]).to(torch.bfloat16)
    bits = vals.view(torch.int16).numpy().view(np.uint16)
    import ml_dtypes

    out = tloader._to_f32({"raw": bits, "ml": vals.float().numpy().astype(ml_dtypes.bfloat16),
                           "f32": np.ones(2, np.float32)})
    np.testing.assert_array_equal(out["raw"], vals.float().numpy())
    np.testing.assert_array_equal(out["ml"], jloader._to_f32({"ml": out["ml"]})["ml"])
    np.testing.assert_array_equal(out["ml"], vals.float().numpy())
    assert out["f32"].dtype == np.float32


def test_resolve_model_dir_local_only(tmp_path, monkeypatch):
    (tmp_path / "org--model" / "vae").mkdir(parents=True)
    monkeypatch.setenv("VIDEOGPA_MODELS_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert tloader.resolve_model_dir("org/model", "vae") == str(tmp_path / "org--model" / "vae")
    assert tloader.resolve_model_dir(str(tmp_path)) == str(tmp_path)
    snap = tmp_path / "hf" / "hub" / "models--org--other" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    assert tloader.resolve_model_dir("org/other") == str(snap)
    with pytest.raises(FileNotFoundError, match="VIDEOGPA_MODELS_DIR"):
        tloader.resolve_model_dir("org/missing")


@pytest.mark.parametrize("cfg", [CogVideoXConfig.tiny(), dataclasses.replace(
    CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=4, vae_invert_scale_latents=True)],
    ids=["5b", "1_5"])
def test_load_cogvideox_and_t5_from_a_checkpoint_directory(tmp_path, cfg):
    """A diffusers-layout directory: the DiT as two bf16 shards with an
    index, the VAE and T5 as f32 files; the port's loaders against the JAX
    converters + bridge on the same tensors."""
    torch.manual_seed(4)
    dit = OracleDiT(cfg).state_dict()
    keys = sorted(dit)
    (tmp_path / "transformer").mkdir()
    shards = {"a.safetensors": keys[: len(keys) // 2], "b.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        safetensors.torch.save_file({k: dit[k].to(torch.bfloat16).contiguous() for k in ks},
                                    str(tmp_path / "transformer" / name))
    (tmp_path / "transformer" / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    vae_sd = _np_sd(OracleVAE(cfg))
    (tmp_path / "vae").mkdir()
    save_file(vae_sd, str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    t5_cfg = te.T5Config.tiny()
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=t5_cfg.vocab_size, d_model=t5_cfg.d_model, d_kv=t5_cfg.d_kv,
        d_ff=t5_cfg.d_ff, num_layers=t5_cfg.num_layers, num_heads=t5_cfg.num_heads,
        feed_forward_proj="gated-gelu"))
    (tmp_path / "text_encoder").mkdir()
    t5_sd = _np_sd(hf)
    save_file(t5_sd, str(tmp_path / "text_encoder" / "model.safetensors"))

    tdit, tvae = tloader.load_cogvideox(str(tmp_path), cfg, dtype=torch.bfloat16, device="cpu")
    assert next(tdit.parameters()).dtype == torch.bfloat16
    bf16_sd = {k: v.to(torch.bfloat16).float().numpy() for k, v in dit.items()}
    want = _bridged(jconv.convert_dit(bf16_sd, _jcfg(cfg)))
    _assert_equal_sd({k: v.float().numpy() for k, v in tdit.state_dict().items()}, want)
    want_vae = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                for k, v in _bridged(jconv.convert_vae(vae_sd, _jcfg(cfg))).items()}
    _assert_equal_sd({k: v.float().numpy() for k, v in tvae.state_dict().items()}, want_vae)

    t5, got_cfg = tloader.load_t5(str(tmp_path), t5_cfg, device="cpu")
    assert got_cfg == t5_cfg
    _assert_equal_sd({k: v.numpy() for k, v in t5.state_dict().items()},
                     _bridged(je.convert_t5_encoder(t5_sd, je.T5Config(
                         **dataclasses.asdict(t5_cfg)))))
