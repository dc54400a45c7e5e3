"""The port's W8A8 inference mode (``videogpa_torch/ops/quant.py``) against
the JAX package's (``videogpa_tpu/ops/quant.py``) on the CPU in float32: the
weight quantiser, the quantised linear, the bridge for quantised trees, the
model quantisers, the three models' int8 forwards, and the slice as a whole:
the int8 denoise loop and the int8 scorer.

Where both packages quantise the same float activations, an integer can
differ by one between them when ``x / s`` lands within an ulp of a rounding
tie; such a flip moves one term of one product by ``s_x * s_w * w``, far below
the tolerances stated at each comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.metrics as jm
import videogpa_tpu.ops.attention as jattn
import videogpa_tpu.ops.quant as jquant
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxDiTConfig
from videogpa_tpu.models.cogvideox import dit_init as j_dit_init
from videogpa_tpu.models.cogvideox.dit import dit_forward as j_dit_forward
from videogpa_tpu.models.cogvideox.pipeline import SamplerSettings as JaxSettings
from videogpa_tpu.models.cogvideox.pipeline import denoise_loop as j_denoise_loop
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import vggt_forward as j_vggt_forward
from videogpa_tpu.models.vggt import vggt_init as j_vggt_init
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_tpu.models.wan.dit import wan_forward as j_wan_forward
from videogpa_tpu.models.wan.dit import wan_init as j_wan_init
from videogpa_tpu.ops import layers as JL
from videogpa_tpu.reward import VideoProcessor as JaxVideoProcessor
import videogpa_torch.metrics as tm
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.cogvideox import (
    CogVideoXConfig, CogVideoXTransformer, SamplerSettings, denoise_loop, dit_forward)
from videogpa_torch.models.da3 import DA3Config, da3_init
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward
from videogpa_torch.models.wan import WanConfig, WanTransformer, wan_forward
from videogpa_torch.ops import quant as tquant
from videogpa_torch.reward import VideoProcessor
from videogpa_torch.train.lora import merge_lora
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_mode():
    """The JAX package's Pallas kernels in interpret mode, restored after."""
    old = jattn.INTERPRET
    jattn.INTERPRET = True
    yield
    jattn.INTERPRET = old


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# quantize_linear, linear_w8a8, int8_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True], ids=["plain", "stacked"])
def test_quantize_linear_matches_jax(stacked):
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal(((3,) if stacked else ()) + (48, 24)).astype(np.float32)
    if stacked:
        kernel[1] *= 100.0  # a layer's magnitude must stay out of its neighbours' scales
    kernel[..., :, 5] = 0.0  # a dead output channel: the 1e-12 floor
    want = jquant.quantize_linear({"kernel": jnp.asarray(kernel)})
    q, scale = tquant.quantize_linear(torch.from_numpy(kernel).transpose(-1, -2))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert q.shape == kernel.shape[:-2] + (24, 48) and scale.shape == kernel.shape[:-2] + (24,)
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(want["w_int8"]), -1, -2))
    np.testing.assert_allclose(scale.numpy(), np.asarray(want["w_scale"])[..., 0, :], rtol=1e-7)


def test_quantize_linear_rounds_half_to_even_and_clips():
    w = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0]])  # scale exactly 1
    q, scale = tquant.quantize_linear(w)
    assert scale.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -127]]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_linear_w8a8_matches_jax(bias):
    """The same int8 weights and float activations through both packages,
    f32: rtol 1e-5 / atol 1e-5 (the rescale's two f32 multiplies are taken in
    another order)."""
    rng = np.random.default_rng(1)
    p = {"kernel": jnp.asarray(rng.standard_normal((64, 40)).astype(np.float32) * 0.2)}
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal(40).astype(np.float32))
    qp = jquant.quantize_linear(p)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    x[1, 4] = 0.0  # an all-zero token: the 1e-12 floor
    want = np.asarray(JL.linear(qp, jnp.asarray(x)))
    got = tquant.linear_w8a8(
        torch.from_numpy(x), torch.from_numpy(np.asarray(qp["w_int8"]).T.copy()),
        torch.from_numpy(np.array(qp["w_scale"])[0]),
        torch.from_numpy(np.array(p["bias"])) if bias else None)
    assert got.shape == (3, 17, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # near the float layer, as tests/test_quant.py::TestQuantizedLinear holds the JAX one
    exact = np.asarray(JL.linear(p, jnp.asarray(x)))
    rel = np.linalg.norm(got.numpy() - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel


def test_linear_w8a8_bf16_activations_take_f32_scales():
    """bf16 activations: the scale comes from the f32 image of the bf16
    values and the result is cast once, at the end; against JAX on the same
    bf16 input within one bf16 ulp of the largest output."""
    rng = np.random.default_rng(2)
    qp = jquant.quantize_linear({"kernel": jnp.asarray(
        rng.standard_normal((32, 16)).astype(np.float32))})
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32)).to(torch.bfloat16)
    want = np.asarray(JL.linear(qp, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = tquant.linear_w8a8(x, torch.from_numpy(np.asarray(qp["w_int8"]).T.copy()),
                             torch.from_numpy(np.array(qp["w_scale"])[0]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7 * np.abs(want).max())


def test_int8_matmul_is_exact_and_checks_its_operands():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (19, 128), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (24, 128), dtype=np.int8))
    a[0], b[0] = 127, 127  # the largest sum: 128 * 127^2
    got = tquant.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, a.int() @ b.int().T)
    assert got[0, 0].item() == 128 * 127 * 127
    with pytest.raises(TypeError):
        tquant.int8_matmul(a.float(), b)
    with pytest.raises(ValueError):
        tquant.int8_matmul(a, b[:, :64])
    with pytest.raises(ValueError):
        tquant.int8_matmul(a[None], b)


def test_quant_linear_module_holds_int8_buffers_and_drops_the_float_weight():
    lin = torch.nn.Linear(16, 8)
    q = tquant.QuantLinear.from_linear(lin)
    assert set(q.state_dict()) == {"w_int8", "w_scale", "bias"}
    assert not hasattr(q, "weight") and q.bias is lin.bias
    x = torch.randn(4, 16)
    assert torch.equal(q(x), tquant.linear_w8a8(x, q.w_int8, q.w_scale, q.bias))
    assert "bias" not in tquant.QuantLinear.from_linear(torch.nn.Linear(16, 8, bias=False)
                                                       ).state_dict()


# ---------------------------------------------------------------------------
# The three models: bridge, quantisers, forwards
# ---------------------------------------------------------------------------

# the three models' trees and the JAX quantiser's trees of them, built once a
# module (``cases`` / ``qtrees``); no test writes into them
def _dit_case():
    cfg = CogVideoXConfig.tiny()
    jcfg = JaxDiTConfig(**dataclasses.asdict(cfg))
    return cfg, jcfg, random_jax_tree(j_dit_init, jcfg, seed=11)


def _wan_case():
    return WanConfig.tiny(), JaxWanConfig.tiny(), random_jax_tree(
        j_wan_init, JaxWanConfig.tiny(), seed=12)


def _vggt_case():
    tree = random_jax_tree(j_vggt_init, JaxVGGTConfig.tiny(), seed=13)
    tree["camera_head"]["pose_branch"]["fc2"]["bias"][7:9] += 1.0  # regular cameras
    return VGGTConfig.tiny(), JaxVGGTConfig.tiny(), tree


@pytest.fixture(scope="module")
def cases():
    return {"dit": _dit_case(), "wan": _wan_case(), "vggt": _vggt_case()}


@pytest.fixture(scope="module")
def qtrees(cases):
    """Each tree through the JAX package's quantiser, as jnp arrays."""
    quantise = {"dit": jquant.quantize_dit_int8, "wan": jquant.quantize_wan_int8,
                "vggt": jquant.quantize_vggt_int8}
    return {name: quantise[name](jax.tree.map(jnp.asarray, tree))
            for name, (_, _, tree) in cases.items()}


# the JAX forwards jitted: eager, the tiny VGGT's int8 forward takes ~30 s
_j_vggt_forward = jax.jit(j_vggt_forward, static_argnums=(2,),
                          static_argnames=("attn_impl", "compute_dtype"))
_j_dit_forward = jax.jit(j_dit_forward, static_argnums=(4,),
                         static_argnames=("attn_impl", "compute_dtype", "attn_layout",
                                          "lora_scaling"))
_j_wan_forward = jax.jit(j_wan_forward, static_argnums=(4,),
                         static_argnames=("attn_impl", "compute_dtype"))


_MODELS = {
    "dit": (_dit_case, CogVideoXTransformer, jquant.quantize_dit_int8, tquant.quantize_dit_int8,
            ("blocks.0.attn1.to_q", "blocks.1.attn1.to_out", "blocks.0.ff.fc1", "blocks.1.ff.fc2"),
            ("patch_embed.text_proj", "blocks.0.norm1.linear", "proj_out", "norm_out.linear")),
    "wan": (_wan_case, WanTransformer, jquant.quantize_wan_int8, tquant.quantize_wan_int8,
            ("blocks.0.self_attn.q", "blocks.1.cross_attn.k", "blocks.0.cross_attn.o",
             "blocks.1.ffn.fc1", "blocks.0.ffn.fc2"),
            ("text_embedding.fc1", "time_projection", "head.head")),
    "vggt": (_vggt_case, VGGT, jquant.quantize_vggt_int8, tquant.quantize_vggt_int8,
             ("aggregator.frame_blocks.0.attn.qkv", "aggregator.global_blocks.3.attn.proj",
              "aggregator.frame_blocks.2.mlp.fc1", "aggregator.global_blocks.1.mlp.fc2"),
             ("aggregator.patch_embed.blocks.0.attn.qkv", "camera_head.trunk.0.attn.qkv",
              "camera_head.pose_branch.fc1")),
}


@pytest.mark.parametrize("name", list(_MODELS))
def test_bridge_loads_a_jax_quantised_tree_strictly(name, cases, qtrees):
    _, make, _, _, quantised, kept = _MODELS[name]
    cfg, _, tree = cases[name]
    qtree = _np(qtrees[name])
    model = load_jax_params(make(cfg), qtree)
    for path in quantised:
        assert isinstance(model.get_submodule(path), tquant.QuantLinear), path
    for path in kept:
        m = model.get_submodule(path)
        assert isinstance(m, torch.nn.Linear) and not isinstance(m, tquant.QuantLinear), path
    sd = model.state_dict()
    # one stacked leaf, layer by layer: (L, in, out) -> (out, in), (L, 1, out) -> (out,)
    path = quantised[0].split(".")
    at = next(i for i, p in enumerate(path) if p.isdigit())
    leaf = qtree
    for p in path[:at] + path[at + 1:]:
        leaf = leaf[p]
    layer = int(path[at])
    np.testing.assert_array_equal(sd[quantised[0] + ".w_int8"].numpy(), leaf["w_int8"][layer].T)
    np.testing.assert_array_equal(sd[quantised[0] + ".w_scale"].numpy(),
                                  leaf["w_scale"][layer][0])
    assert sd[quantised[0] + ".w_int8"].dtype == torch.int8
    # strict on both sides: a float model state does not fit, nor a partial tree
    assert set(sd) == set(state_dict_from_jax(qtree))
    with pytest.raises(RuntimeError):
        make(cfg).load_state_dict(sd, strict=True)
    partial = dict(qtree)
    partial.pop(next(iter(partial)))
    with pytest.raises(RuntimeError):
        load_jax_params(make(cfg), partial)


@pytest.mark.parametrize("name", list(_MODELS))
def test_model_quantiser_equals_the_bridge_of_the_jax_quantised_tree(name, cases, qtrees):
    """``quantize_*_int8`` on the port's module swaps exactly the linears
    the JAX function swaps and gives the same integers and scales."""
    _, make, _, t_quantize, quantised, _ = _MODELS[name]
    cfg, _, tree = cases[name]
    want = state_dict_from_jax(_np(qtrees[name]))
    model = load_jax_params(make(cfg), tree)
    n_float = sum(p.numel() for p in model.parameters())
    assert t_quantize(model) is model  # in place
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith(".w_scale"):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-7, err_msg=key)
        else:
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), w.numpy(), err_msg=key)
    # the float weights are gone: the quantised layers hold buffers only
    n_int8 = sum(b.numel() for k, b in model.named_buffers() if k.endswith(".w_int8"))
    assert n_int8 > 0 and sum(p.numel() for p in model.parameters()) == n_float - n_int8
    assert all(not hasattr(model.get_submodule(p), "weight") for p in quantised)


def test_quantize_scorer_params(cases):
    cfg, _, tree = cases["vggt"]
    model = load_jax_params(VGGT(cfg), tree)
    out, impl = tquant.quantize_scorer_params("vggt", model)
    assert out is model and impl == "flash_int8"
    assert isinstance(model.aggregator.global_blocks[0].attn.qkv, tquant.QuantLinear)
    # DA3: the AA-ViT's blocks become int8, the heads and camera MLPs stay float
    da3 = da3_init(DA3Config.tiny(), torch.Generator().manual_seed(0), device="cpu")
    out, impl = tquant.quantize_scorer_params("da3", da3)
    assert out is da3 and impl == "flash_int8"
    for blk in (*da3.backbone.blocks_pre, *da3.backbone.blocks_alt):
        assert isinstance(blk.attn.qkv, tquant.QuantLinear)
        assert isinstance(blk.mlp.fc2, tquant.QuantLinear)
    assert not any(isinstance(m, tquant.QuantLinear)
                   for part in (da3.head, da3.cam_dec, da3.cam_enc) for m in part.modules())


def _dit_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                             cfg.sample_width), dtype=np.float32)
    txt = rng.standard_normal((2, cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32)
    return x, txt, np.array([100, 900])


# int8 forwards of both packages on the same quantised weights in f32. The
# float work between the layers agrees to ~1e-6 (the exact forwards are held
# to 1e-4), so nearly every activation quantises to the same integer; 1e-3
# (absolute, and relative to the value) leaves room for a few integers that
# flip at a rounding tie.
INT8_FWD_ATOL = INT8_FWD_RTOL = 1e-3


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_int8_dit_forward_matches_jax(layout, cases, qtrees):
    """bhnd: every attention through the int8-QK forward (K8's plain version
    against ``_flash_int8`` in interpret mode); bnhd: the tiny model's 80-key
    rows are short, so both packages take the exact short-row kernel."""
    cfg, jcfg, tree = cases["dit"]
    qtree = qtrees["dit"]
    model = load_jax_params(CogVideoXTransformer(cfg), _np(qtree))
    x, txt, t = _dit_inputs(cfg, 21)
    want = _j_dit_forward(qtree, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), jcfg,
                         attn_impl="flash_int8", compute_dtype=jnp.float32, attn_layout=layout)
    with torch.no_grad():
        got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(t),
                          compute_dtype=torch.float32, attn_layout=layout,
                          attn_impl="flash_int8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_FWD_ATOL,
                               rtol=INT8_FWD_RTOL)


def test_int8_dit_forward_with_lora_on_the_float_path_matches_jax(cases, qtrees):
    """LoRA deltas read the raw activations on top of the int8 product."""
    cfg, jcfg, tree = cases["dit"]
    qtree = qtrees["dit"]
    model = load_jax_params(CogVideoXTransformer(cfg), _np(qtree))
    rng = np.random.default_rng(22)
    r, d, L = 4, cfg.hidden_dim, cfg.num_layers
    lora = {n: {"lora_A": rng.standard_normal((L, r, d), dtype=np.float32) * 0.1,
                "lora_B": rng.standard_normal((L, d, r), dtype=np.float32) * 0.1}
            for n in ("to_q", "to_k", "to_v", "to_out")}
    x, txt, t = _dit_inputs(cfg, 23)
    want = _j_dit_forward(qtree, jnp.asarray(x), jnp.asarray(txt), jnp.asarray(t), jcfg,
                          attn_impl="flash_int8", compute_dtype=jnp.float32,
                          lora=jax.tree.map(jnp.asarray, lora), lora_scaling=2.0)
    tl = {n: {k: torch.from_numpy(v) for k, v in ab.items()} for n, ab in lora.items()}
    with torch.no_grad():
        got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt), torch.from_numpy(t),
                          compute_dtype=torch.float32, lora=tl, lora_scaling=2.0,
                          attn_impl="flash_int8")
        base = dit_forward(model, torch.from_numpy(x), torch.from_numpy(txt),
                           torch.from_numpy(t), compute_dtype=torch.float32,
                           attn_impl="flash_int8")
    assert (got - base).abs().max() > 1e-3  # the adapters are live
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_FWD_ATOL,
                               rtol=INT8_FWD_RTOL)


def test_merge_lora_then_quantise_differs_from_quantising_the_base(cases):
    """The order of the generate path: merge the adapters, then quantise."""
    cfg, _, tree = cases["dit"]
    rng = np.random.default_rng(24)
    r, d, L = 2, cfg.hidden_dim, cfg.num_layers
    lora = {n: {"lora_A": torch.from_numpy(rng.standard_normal((L, r, d), dtype=np.float32)),
                "lora_B": torch.from_numpy(rng.standard_normal((L, d, r), dtype=np.float32))}
            for n in ("to_q", "to_k", "to_v", "to_out")}
    base = tquant.quantize_dit_int8(load_jax_params(CogVideoXTransformer(cfg), tree))
    merged = load_jax_params(CogVideoXTransformer(cfg), tree)
    merge_lora(merged, lora, 2, 4.0)
    tquant.quantize_dit_int8(merged)
    a, b = base.blocks[0].attn1.to_q.w_int8, merged.blocks[0].attn1.to_q.w_int8
    assert (a.int() - b.int()).abs().max() > 0
    assert torch.equal(base.blocks[0].ff.fc1.w_int8, merged.blocks[0].ff.fc1.w_int8)


def test_int8_wan_forward_matches_jax(cases, qtrees):
    """head_dim 24 < 128, bhnd: self- and cross-attention through the int8-QK
    forward in both packages (cross: 80 queries on 9 keys)."""
    cfg, jcfg, tree = cases["wan"]
    qtree = qtrees["wan"]
    model = load_jax_params(WanTransformer(cfg), _np(qtree))
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, cfg.in_channels, 5, 8, 8), dtype=np.float32)
    ctx = rng.standard_normal((2, 9, cfg.text_dim), dtype=np.float32)
    t = np.array([500.0, 20.0], np.float32)
    want = _j_wan_forward(qtree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jcfg,
                          attn_impl="flash_int8", compute_dtype=jnp.float32)
    with torch.no_grad():
        got = wan_forward(model, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                          compute_dtype=torch.float32, attn_impl="flash_int8")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_FWD_ATOL,
                               rtol=INT8_FWD_RTOL)


def test_int8_vggt_forward_matches_jax(cases, qtrees):
    """The quantised trunk with ``flash_int8``: the tiny model's rows are
    short, so attention is the exact short-row kernel in both packages."""
    cfg, jcfg, tree = cases["vggt"]
    qtree = qtrees["vggt"]
    model = load_jax_params(VGGT(cfg), _np(qtree)).eval()
    imgs = np.random.default_rng(26).uniform(0, 1, (1, 3, 3, cfg.img_size, cfg.img_size)
                                             ).astype(np.float32)
    want = _j_vggt_forward(qtree, jnp.asarray(imgs), jcfg, attn_impl="flash_int8",
                           compute_dtype=jnp.float32)
    with torch.no_grad():
        got = vggt_forward(model, torch.from_numpy(imgs), compute_dtype=torch.float32,
                           attn_impl="flash_int8")
    for key in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=INT8_FWD_ATOL,
                                   rtol=INT8_FWD_RTOL, err_msg=key)
    exact = vggt_forward(load_jax_params(VGGT(cfg), tree).eval(), torch.from_numpy(imgs),
                         compute_dtype=torch.float32)
    cos = torch.nn.functional.cosine_similarity(got["depth"].ravel(), exact["depth"].ravel(), 0)
    assert cos > 0.99, cos  # tests/test_quant.py::test_vggt_trunk_cosine's limit


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _cos_rel(a, b):
    a, b = a.ravel().double(), b.ravel().double()
    return (float(a @ b / (a.norm() * b.norm())), float((a - b).norm() / b.norm()))


def test_int8_denoise_loop_matches_jax_and_tracks_the_exact_loop(cases, qtrees):
    """The 10-step CFG DDIM loop of ``tests/test_quant.py::TestTrajectoryDrift``
    with the JAX draw injected: int8 port against int8 JAX (rel-L2 < 5e-3: ten
    steps compound the few integers that flip at a tie), and against the
    exact port with the JAX test's limits (cos > 0.9999, rel < 0.02)."""
    cfg, jcfg, tree = cases["dit"]
    rng = np.random.default_rng(31)
    emb = rng.standard_normal((1, cfg.max_text_seq_length, cfg.text_embed_dim), dtype=np.float32)
    neg = np.zeros_like(emb)
    shape = (1, cfg.sample_frames, cfg.in_channels, cfg.sample_height, cfg.sample_width)
    key = jax.random.PRNGKey(2)
    want = j_denoise_loop(
        qtrees["dit"], jnp.asarray(emb), jnp.asarray(neg), key, jcfg,
        JaxSettings(num_inference_steps=10, guidance_scale=6.0, sampler="ddim"), shape,
        attn_impl="flash_int8", compute_dtype=jnp.float32)
    init = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], shape,
                                                       jnp.float32)))
    settings = SamplerSettings(num_inference_steps=10, guidance_scale=6.0, sampler="ddim")
    args = (torch.from_numpy(emb), torch.from_numpy(neg), settings, shape)
    exact = denoise_loop(load_jax_params(CogVideoXTransformer(cfg), tree), *args,
                         init_latents=init, compute_dtype=torch.float32)
    qmodel = tquant.quantize_dit_int8(load_jax_params(CogVideoXTransformer(cfg), tree))
    got = denoise_loop(qmodel, *args, init_latents=init, compute_dtype=torch.float32,
                       attn_impl="flash_int8")
    assert torch.isfinite(got).all()
    cos, rel = _cos_rel(got, torch.from_numpy(np.array(want)))
    assert rel < 5e-3, (cos, rel)
    cos, rel = _cos_rel(got, exact)
    assert cos > 0.9999 and rel < 0.02, (cos, rel)
    assert rel > 0  # the int8 mode is on


def _blur(img, sigma=3.0):
    """Separable Gaussian blur with numpy (reflected borders)."""
    r = int(3 * sigma)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    for axis in (0, 1):
        pad = [(r, r) if a == axis else (0, 0) for a in range(img.ndim)]
        padded = np.pad(img, pad, mode="reflect")
        img = sum(w * np.take(padded, np.arange(i, i + img.shape[axis]), axis=axis)
                  for i, w in enumerate(k))
    return img


def _structured_candidates(size, frames=5):
    """The candidates of ``tests/test_quant.py::TestInt8RankAgreement``, square
    at the tiny model's size: a crop sliding over a smooth background (a
    consistent camera move) and three graded noise degradations of it."""
    rng = np.random.default_rng(0)
    bg = _blur(rng.uniform(0, 255, (160, 160, 3))).astype(np.uint8)
    clean = np.stack([bg[10 + 2 * t:10 + 2 * t + size, 10 + 3 * t:10 + 3 * t + size]
                      for t in range(frames)])
    out = [clean]
    for i, amp in enumerate((40, 80, 120)):
        noise = np.random.default_rng(300 + i).integers(-amp, amp, clean.shape)
        out.append(np.clip(clean.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return out


def test_int8_scorer_matches_jax_and_ranks_like_the_exact_scorer(cases, qtrees):
    """The tiny scorer in int8 mode (quantised trunk + ``flash_int8``) through
    ``process_frames``: against the JAX package's int8 scorer on the same
    quantised weights (MSE-only consistency score within 5 flipped z-buffer
    pixels + 1e-4 relative; motion, a function of the poses, within the int8
    forwards' 1e-3), and ranking the four structured candidates as the exact
    port scorer does."""
    cfg, jcfg, tree = cases["vggt"]
    qtree = qtrees["vggt"]
    candidates = _structured_candidates(cfg.img_size)
    S = candidates[0].shape[0]

    j_int8 = JaxVideoProcessor({"Consistency_Score": jm.ConsistencyScore(None)}, params=qtree,
                               config=jcfg, compute_dtype=jnp.float32, attn_impl="flash_int8")
    exact_vp = VideoProcessor({"Consistency_Score": tm.ConsistencyScore(None)},
                              params=load_jax_params(VGGT(cfg), tree).eval(),
                              compute_dtype=torch.float32, device="cpu")
    qmodel, impl = tquant.quantize_scorer_params("vggt", load_jax_params(VGGT(cfg), tree).eval())
    int8_vp = VideoProcessor({"Consistency_Score": tm.ConsistencyScore(None)}, params=qmodel,
                             compute_dtype=torch.float32, device="cpu", attn_impl=impl)

    def scores(vp):
        return [vp.process_frames(c, [0])[0] for c in candidates]

    want, exact, got = scores(j_int8), scores(exact_vp), scores(int8_vp)
    flip = 5.0 / (S * cfg.img_size ** 2)
    for g, w in zip(got, want):
        assert abs(g["Consistency_Score"] - w["Consistency_Score"]) <= (
            flip + 1e-4 * abs(w["Consistency_Score"])), (g, w)
        assert abs(g["motion_norm"] - w["motion_norm"]) <= INT8_FWD_ATOL, (g, w)
    e = np.array([r["Consistency_Score"] for r in exact])
    q = np.array([r["Consistency_Score"] for r in got])
    assert np.all(np.isfinite(q)) and np.any(q != e)
    np.testing.assert_array_equal(np.argsort(e), np.argsort(q),
                                  err_msg=f"exact scores {e} vs int8 scores {q}")
