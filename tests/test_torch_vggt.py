"""The port's VGGT (ops, DINOv2, aggregator, heads, whole model) against the
JAX package on the CPU in f32, with the same weights carried across by the
bridge and the same inputs made with numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import aggregator as jagg
from videogpa_tpu.models.vggt import heads as jheads
from videogpa_tpu.models.vggt import model as jmodel
from videogpa_tpu.models.vggt import vit as jvit
from videogpa_tpu.ops import layers as JL
from videogpa_tpu.ops import resize as jresize
from videogpa_tpu.ops import rope as jrope
from videogpa_tpu.ops import transformer as jtf
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward, vggt_init
from videogpa_torch.models.vggt import aggregator as tagg
from videogpa_torch.models.vggt import heads as theads
from videogpa_torch.models.vggt import vit as tvit
from videogpa_torch.ops import layers as TL
from videogpa_torch.ops import resize as tresize
from videogpa_torch.ops import rope as trope
from videogpa_torch.ops import transformer as ttf
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 on both sides: every difference is summation order (XLA vs PyTorch's
# CPU kernels), a few f32 ulps per op, compounded through the layers
ATOL, RTOL = 1e-5, 1e-5
# the JAX heads, aggregator and model jitted: eager, they run op by op
_j_dpt_head = jax.jit(jheads.dpt_head_forward, static_argnums=(2, 3, 4, 5),
                      static_argnames=("chunk_size",))
_j_aggregator = jax.jit(jagg.aggregator_forward, static_argnums=(2,),
                        static_argnames=("attn_impl", "keep_layers"))
_j_vggt = jax.jit(jmodel.vggt_forward, static_argnums=(2,),
                  static_argnames=("attn_impl", "compute_dtype", "dpt_chunk"))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny():
    """The tiny config, a tree shaped as JAX's ``vggt_init`` gives it and the
    port's model with the same weights."""
    cfg = VGGTConfig.tiny()
    params = random_jax_tree(jmodel.vggt_init, JaxVGGTConfig.tiny())
    model = load_jax_params(VGGT(cfg), params).eval()
    return cfg, params, model


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (2, 3, 3, 56, 56)).astype(np.float32)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_rope_2d_matches_jax(layout):
    rng = np.random.default_rng(1)
    tokens = rng.standard_normal((2, 3, 21, 16) if layout == "bhnd" else (2, 21, 3, 16),
                                 dtype=np.float32)
    pos = rng.integers(0, 6, (2, 21, 2))
    want = jrope.rope_2d(jnp.asarray(tokens), jnp.asarray(pos), 100.0, layout=layout)
    got = trope.rope_2d(_t(tokens), _t(pos), 100.0, layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


_BLOCKS = {
    "dinov2": dict(dim=32, num_heads=2, init_values=1.0, norm_eps=1e-6),
    "aggregator": dict(dim=32, num_heads=2, qk_norm=True, init_values=0.01, rope_base=100.0),
    "camera_d128": dict(dim=256, num_heads=2, init_values=0.01),
    "swiglu": dict(dim=32, num_heads=4, ffn="swiglu", qkv_bias=False),
}


@pytest.mark.parametrize("name", list(_BLOCKS))
def test_block_matches_jax(name):
    cfg = ttf.BlockConfig(**_BLOCKS[name])
    jcfg = jtf.BlockConfig(**_BLOCKS[name])
    params = random_jax_tree(jtf.block_init, jcfg, seed=3)
    blk = load_jax_params(ttf.Block(cfg), params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 21, cfg.dim), dtype=np.float32)
    pos = rng.integers(0, 5, (2, 21, 2))
    want = jtf.block_apply(params, jnp.asarray(x), jcfg, pos=jnp.asarray(pos), attn_impl="xla")
    with torch.no_grad():
        got = ttf.block_apply(blk, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_layer_ops_match_jax():
    rng = np.random.default_rng(4)
    # transposed conv, kernel == stride (the DPT's resize0/1): HWIO (k, k, in, out)
    x = rng.standard_normal((2, 6, 5, 7), dtype=np.float32)
    w = rng.standard_normal((4, 4, 6, 3), dtype=np.float32)
    b = rng.standard_normal((3,), dtype=np.float32)
    want = JL.conv_transpose2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x), stride=4)
    got = TL.conv_transpose2d(_t(x), _t(w.transpose(2, 3, 0, 1)), _t(b), stride=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # exact-erf GELU MLP and the affine-free layer norm (the camera head's AdaLN)
    p = random_jax_tree(JL.mlp_init, 16, 40, 9, seed=5)
    m = load_jax_params(TL.group(fc1=TL.Linear(16, 40), fc2=TL.Linear(40, 9)), p)
    h = rng.standard_normal((3, 16), dtype=np.float32) * 3
    with torch.no_grad():
        np.testing.assert_allclose(TL.mlp(m, _t(h)).numpy(), np.asarray(JL.mlp(p, jnp.asarray(h))),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(TL.layernorm(_t(h), eps=1e-6).numpy(),
                               np.asarray(JL.layernorm({}, jnp.asarray(h), eps=1e-6)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("align_corners,out_hw", [(True, (29, 31)), (False, (13, 40)),
                                                  (True, (37, 37))])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    x = np.random.default_rng(6).standard_normal((2, 3, 17, 19), dtype=np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align_corners)
    got = tresize.resize_bilinear(_t(x), out_hw, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_resize_bicubic_antialias_and_pos_embed_interpolation_match_jax(tiny):
    cfg, params, model = tiny
    x = np.random.default_rng(7).standard_normal((1, 4, 37, 37), dtype=np.float32)
    for out_hw in ((18, 26), (50, 44)):
        want = jresize.resize_bicubic(jnp.asarray(x), out_hw, antialias=True)
        got = tresize.resize_bicubic(_t(x), out_hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    pe = params["aggregator"]["patch_embed"]["pos_embed"]  # a 4 x 4 grid
    want = jvit._interpolate_pos_embed(jnp.asarray(pe), 3, 6)
    got = tvit.interpolate_pos_embed(_t(pe), 3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_dinov2_matches_jax(tiny, images):
    cfg, params, model = tiny
    x = images[0]  # (3, 3, 56, 56): 3 frames
    want = jvit.dinov2_forward(params["aggregator"]["patch_embed"], jnp.asarray(x),
                               JaxVGGTConfig.tiny(), attn_impl="xla")
    with torch.no_grad():
        got = tvit.dinov2_forward(model.aggregator.patch_embed, _t(x))
    assert got.shape == (3, 16, cfg.backbone_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_slice_expand_and_flatten_matches_jax():
    tok = np.random.default_rng(8).standard_normal((1, 2, 3, 5), dtype=np.float32)
    want = jagg.slice_expand_and_flatten(jnp.asarray(tok), 2, 4)
    got = tagg.slice_expand_and_flatten(_t(tok), 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aggregator_keep_layers_matches_jax(tiny, images):
    cfg, params, model = tiny
    keep = (0, 2, 3)
    want, idx = _j_aggregator(params["aggregator"], jnp.asarray(images),
                              JaxVGGTConfig.tiny(), attn_impl="xla", keep_layers=keep)
    with torch.no_grad():
        got, tidx = tagg.aggregator_forward(model.aggregator, _t(images), keep_layers=keep)
    assert tidx == idx and got.shape == (3, 2, 3, 21, 2 * cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_camera_head_matches_jax(tiny):
    cfg, params, model = tiny
    tok = np.random.default_rng(9).standard_normal((2, 3, cfg.tokens_dim), dtype=np.float32)
    want = jheads.camera_head_forward(params["camera_head"], jnp.asarray(tok),
                                      JaxVGGTConfig.tiny(), attn_impl="xla")
    with torch.no_grad():
        got = theads.camera_head_forward(model.camera_head, _t(tok))
    assert len(got) == len(want) == cfg.camera_iterations
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("chunk_size", [8, 4, 1])
def test_dpt_head_chunked_matches_jax(tiny, chunk_size):
    """B*S = 6 frames: chunk_size 8 -> one chunk of 6, 4 -> two chunks of 3
    (the largest divisor <= 4), 1 -> six chunks; each writes its slice."""
    cfg, params, model = tiny
    tokens = np.random.default_rng(10).standard_normal((4, 2, 3, 21, cfg.tokens_dim),
                                                        dtype=np.float32)
    want = _j_dpt_head(params["depth_head"], jnp.asarray(tokens), JaxVGGTConfig.tiny(),
                       (56, 56), "exp", "expp1", chunk_size=chunk_size)
    with torch.no_grad():
        got = theads.dpt_head_forward(model.depth_head, _t(tokens), cfg, (56, 56), "exp",
                                      "expp1", chunk_size=chunk_size)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_rcu_adds_relu_of_its_input_like_jax():
    """VGGT's ResidualConvUnit: ReLU(inplace=True) rewrites the input before
    the skip-add, so the residual is relu(x), not x."""
    p = random_jax_tree(lambda key: {"conv1": JL.conv2d_init(key, 4, 4, 3),
                                     "conv2": JL.conv2d_init(key, 4, 4, 3)}, seed=11)
    m = load_jax_params(TL.group(conv1=TL.Conv2d(4, 4, 3, padding=1),
                                 conv2=TL.Conv2d(4, 4, 3, padding=1)), p)
    x = np.random.default_rng(13).standard_normal((1, 4, 6, 6), dtype=np.float32) - 0.5
    want = jheads._rcu(p, jnp.asarray(x), inplace_relu=True)
    raw_skip = jheads._rcu(p, jnp.asarray(x), inplace_relu=False)
    with torch.no_grad():
        got = theads._rcu_apply(m, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.abs(got.numpy() - np.asarray(raw_skip)).max() > 1e-2


def test_uv_pos_embed_matches_jax():
    want = jheads._uv_pos_embed(4, 6, 16, 84, 56)
    got = theads.uv_pos_embed(4, 6, 16, 84, 56)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_vggt_forward_matches_jax(tiny, images):
    cfg, params, model = tiny
    want = _j_vggt(params, jnp.asarray(images), JaxVGGTConfig.tiny(), attn_impl="xla",
                   compute_dtype=jnp.float32, dpt_chunk=4)
    with torch.no_grad():
        got = vggt_forward(model, _t(images), compute_dtype=torch.float32, dpt_chunk=4)
    for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    for g, w in zip(got["pose_enc_list"], want["pose_enc_list"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_vggt_init_draws_like_the_jax_initialisers():
    """Random port weights: LayerScale, the zero tokens and the 1e-6 special
    tokens as the JAX initialisers set them; the config is JAX's."""
    cfg = VGGTConfig.tiny()
    model = vggt_init(cfg, torch.Generator().manual_seed(0), device="cpu").requires_grad_(False)
    agg = model.aggregator
    assert float(agg.frame_blocks[0].ls1.gamma[0]) == pytest.approx(cfg.init_values)
    assert float(agg.patch_embed.blocks[0].ls1.gamma[0]) == cfg.backbone_init_values
    assert not agg.patch_embed.cls_token.any() and not model.camera_head.empty_pose_tokens.any()
    assert 0 < float(agg.camera_token.std()) < 1e-5
    assert 0.01 < float(agg.patch_embed.pos_embed.std()) < 0.03
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxVGGTConfig.tiny())
