"""The port's T5 / umT5 encoder against the JAX package's on the CPU (a JAX
``t5_encoder_init``-shaped tree through the bridge, f32) and against
transformers' ``T5EncoderModel`` / ``UMT5EncoderModel`` as
``tests/test_t5_parity.py`` holds the JAX one: shared and per-layer relative
bias, with and without a padding mask, and the bucket function equal as
integers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import videogpa_tpu.models.t5.encoder as je
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.t5 import encoder as te
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)

# f32 on both sides through 2 layers: summation order only
RTOL, ATOL = 1e-4, 1e-5


def _jcfg(cfg):
    return je.T5Config(**dataclasses.asdict(cfg))


def _inputs(cfg, seed, B=2, L=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 4:] = 0  # the second prompt is padded
    return ids, mask


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(per_layer, masked):
    cfg = te.T5Config.tiny(per_layer)
    jt = random_jax_tree(je.t5_encoder_init, _jcfg(cfg))
    model = load_jax_params(te.T5Encoder(cfg), jt)
    ids, mask = _inputs(cfg, 1)
    want = je.t5_encode(jt, jnp.asarray(ids), jnp.asarray(mask) if masked else None,
                        _jcfg(cfg))
    with torch.no_grad():
        got = te.t5_encode(model, torch.from_numpy(ids),
                           torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    n_bias = sum(layer.rel_bias is not None for layer in model.layers)
    assert n_bias == (cfg.num_layers if per_layer else 1)


@pytest.mark.parametrize("cfg", [te.T5Config.t5_v1_1_xxl(), te.T5Config.tiny()],
                         ids=["xxl", "tiny"])
def test_bucket_function_equals_jax_as_integers(cfg):
    rel = np.arange(-400, 401, dtype=np.int32)
    want = np.asarray(je._relative_position_bucket(
        jnp.asarray(rel), cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance))
    got = te._relative_position_bucket(torch.from_numpy(rel).long(),
                                       cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the (1, H, q, k) bias gathered from it, at CogVideoX's 226 tokens
    table = np.random.default_rng(0).standard_normal(
        (cfg.relative_attention_num_buckets, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        te._position_bias(torch.from_numpy(table), 226, 226, cfg).numpy(),
        np.asarray(je._position_bias(jnp.asarray(table), 226, 226, _jcfg(cfg))))


def _tiny_hf(per_layer_bias):
    cfg = te.T5Config.tiny(per_layer_bias)
    kwargs = dict(vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
                  d_ff=cfg.d_ff, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                  relative_attention_num_buckets=cfg.relative_attention_num_buckets,
                  relative_attention_max_distance=cfg.relative_attention_max_distance,
                  feed_forward_proj="gated-gelu", dropout_rate=0.0,
                  is_encoder_decoder=False, use_cache=False)
    if per_layer_bias:
        model = transformers.UMT5EncoderModel(transformers.UMT5Config(**kwargs))
    else:
        model = transformers.T5EncoderModel(transformers.T5Config(**kwargs))
    return model.eval(), cfg


@pytest.mark.parametrize("per_layer", [False, True])
def test_t5_encode_matches_transformers(per_layer):
    torch.manual_seed(0)
    hf, cfg = _tiny_hf(per_layer)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    port_sd = te.convert_t5_encoder(sd, cfg)
    model = te.T5Encoder(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in port_sd.items()}, strict=True)
    # the port's converter and the JAX converter + bridge agree key for key
    bridged = load_jax_params(te.T5Encoder(cfg), je.convert_t5_encoder(sd, _jcfg(cfg)))
    assert set(bridged.state_dict()) == set(port_sd)
    for k, v in bridged.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), port_sd[k], err_msg=k)
    ids, mask = _inputs(cfg, 2)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()).last_hidden_state
        got = te.t5_encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    # the unmasked rows carry the comparison (transformers fills masked
    # logits with the dtype's minimum, the port with -1e9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_random_init_is_seeded_and_shaped():
    cfg = te.T5Config.tiny(True)
    a = te.t5_encoder_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = te.t5_encoder_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert a.layers[1].rel_bias.shape == (32, 4) and float(a.layers[1].rel_bias.std()) < 0.05
    out = te.t5_encode(a, torch.zeros(1, 5, dtype=torch.long))
    assert out.shape == (1, 5, 32) and bool(torch.isfinite(out).all())
