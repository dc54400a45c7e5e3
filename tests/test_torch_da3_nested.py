"""The port's nested DA3 (``videogpa_torch/models/da3/nested.py``) against the
JAX package's on the CPU in f32: the alignment's pieces on the same numpy
inputs (bit for bit, ``_sample_for_quantile``'s seeded subsampling
included), ``align_to_metric``, ``nested_inference`` with a tiny anyview DA3
and a tiny metric net, and DA3-Giant's SwiGLU trunk at a tiny giant-shaped
config. Mirrors ``tests/test_da3.py``'s ``TestNestedNet`` and
``TestPresets``. Limits: 1e-5 relative norm for depths, the scale factor to
1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import model as jmodel
from videogpa_tpu.models.da3 import mono as jmono
from videogpa_tpu.models.da3 import nested as jnested
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.da3 import DA3, DA3Config, DA3Mono, DA3Prediction, da3_forward
from videogpa_torch.models.da3 import nested as tnested
from videogpa_torch.utils.timing import StageTimer
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
REL = 1e-5
MONO = dict(img_size=28, embed_dim=32, depth=4, num_heads=2, alt_start=-1,
            out_layers=(0, 1, 2, 3), dpt_features=16, dpt_out_channels=(16, 16, 16, 16))
# DA3-Giant's grammar (SwiGLU blocks) at tiny widths, as tests/test_da3.py:652
GIANT_TINY = dict(dataclasses.asdict(DA3Config.tiny()), ffn="swiglu", out_layers=(3, 5, 6, 7))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _da3_tree(jcfg, seed):
    tree = random_jax_tree(jmodel.da3_init, jcfg, seed=seed)
    tree["cam_dec"]["fc_fov"]["bias"] += 1.0  # keep the random fov off 0
    return tree


def _prediction(S, H, W, seed, cls=DA3Prediction):
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (S, 1, 1))
    extr[:, :3, 3] = rng.normal(size=(S, 3))
    return cls(depth=rng.uniform(1, 2, (S, H, W)).astype(np.float32),
               conf=rng.uniform(1, 3, (S, H, W)).astype(np.float32), extrinsics=extr,
               intrinsics=np.tile(np.diag([300.0, 320.0, 1.0]).astype(np.float32), (S, 1, 1)),
               processed_images=np.zeros((S, H, W, 3), np.float32))


def test_alignment_pieces_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(1, 5, 500), rng.uniform(1, 5, 500)
    assert tnested.least_squares_scale_scalar(a, b) == jnested.least_squares_scale_scalar(a, b)
    assert tnested.least_squares_scale_scalar(2.5 * b, b) == pytest.approx(2.5, rel=1e-12)
    depth = rng.uniform(1, 3, (2, 8, 8)).astype(np.float32)
    K = np.tile(np.diag([600.0, 500.0, 1]).astype(np.float32), (2, 1, 1))
    np.testing.assert_array_equal(tnested.apply_metric_scaling(depth, K),
                                  jnested.apply_metric_scaling(depth, K))
    big = rng.uniform(0, 1, 150_001).astype(np.float32)
    for x in (big, big[:1000]):
        np.testing.assert_array_equal(tnested._sample_for_quantile(x),
                                      jnested._sample_for_quantile(x))
    conf, metric = rng.uniform(0, 1, (2, 8, 8)), rng.uniform(-0.1, 2, (2, 8, 8))
    metric[0, 0, 0] = np.inf
    sky = rng.uniform(0, 1, (2, 8, 8)) < 0.7
    np.testing.assert_array_equal(
        tnested.compute_alignment_mask(conf, sky, depth, metric, 0.5),
        jnested.compute_alignment_mask(conf, sky, depth, metric, 0.5))


@pytest.mark.parametrize("size", [(2, 16, 16), (2, 240, 240)], ids=["small", "subsampled"])
def test_align_to_metric_matches_jax(size):
    """The same prediction, metric depth and sky map through both packages:
    the scale factor, depth, conf and extrinsics equal; above 100,000 pixels
    the quantiles come from the seeded subsample."""
    S, H, W = size
    pred = _prediction(S, H, W, seed=1)
    jpred = _prediction(S, H, W, seed=1, cls=jmodel.DA3Prediction)
    rng = np.random.default_rng(2)
    metric = (3.0 * pred.depth * rng.uniform(0.9, 1.1, pred.depth.shape)).astype(np.float32)
    sky = np.zeros((S, H, W), np.float32)
    sky[:, : H // 4] = 1.0
    got = tnested.align_to_metric(pred, metric, sky)
    want = jnested.align_to_metric(jpred, metric, sky)
    assert got.is_metric == want.is_metric == 1
    assert got.scale_factor == want.scale_factor and 2.5 < got.scale_factor < 3.5
    for k in ("depth", "conf", "extrinsics", "intrinsics"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    no_sky = tnested.align_to_metric(pred, metric, None)
    assert no_sky.scale_factor == jnested.align_to_metric(jpred, metric, None).scale_factor
    with pytest.raises(ValueError, match="non-sky"):
        tnested.align_to_metric(pred, metric, np.ones((S, H, W), np.float32))


@pytest.fixture(scope="module")
def branches():
    """(JAX trees and configs, the port's nets): a tiny anyview DA3 and a
    tiny metric net from the same trees through the bridge."""
    av_cfg, m_cfg = JaxDA3Config.tiny(), JaxDA3Config(**MONO)
    av_tree = _da3_tree(av_cfg, seed=3)
    m_tree = random_jax_tree(jmono.mono_init, m_cfg, seed=4)
    av = load_jax_params(DA3(DA3Config.tiny()), av_tree).eval()
    m = load_jax_params(DA3Mono(DA3Config(**MONO)), m_tree).eval()
    return (av_tree, av_cfg, m_tree, m_cfg), (av, m)


def test_nested_inference_matches_jax(branches):
    """Four views: the anyview branch selects a reference view."""
    (av_tree, av_cfg, m_tree, m_cfg), (av, m) = branches
    S = 4
    frames = np.random.default_rng(5).integers(0, 256, (S, 28, 28, 3), dtype=np.uint8)
    want = jnested.nested_inference(av_tree, av_cfg, m_tree, m_cfg, frames, attn_impl="xla",
                                    compute_dtype=jnp.float32)
    timer = StageTimer()
    got = tnested.nested_inference(av, m, frames, compute_dtype=torch.float32, timer=timer)
    assert set(timer.counts) == {"anyview", "metric", "align"}
    assert got.is_metric == 1 and np.isfinite(got.scale_factor) and got.scale_factor > 0
    assert got.scale_factor == pytest.approx(want.scale_factor, rel=1e-6, abs=0)
    for k in ("depth", "conf", "extrinsics", "intrinsics"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert _rel(g, w) <= REL, (k, _rel(g, w))


def test_giant_tiny_swiglu_forward_matches_jax():
    """DA3-Giant's trunk grammar (SwiGLU FFN) at a tiny giant-shaped config,
    the whole forward against JAX's."""
    jcfg = JaxDA3Config(**GIANT_TINY)
    tree = _da3_tree(jcfg, seed=6)
    model = load_jax_params(DA3(DA3Config(**GIANT_TINY)), tree).eval()
    assert hasattr(model.backbone.blocks_alt[0].mlp, "w12")
    x = np.random.default_rng(7).standard_normal((1, 4, 3, 28, 28)).astype(np.float32)
    want = jax.jit(jmodel.da3_forward, static_argnums=(2,))(tree, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = da3_forward(model, torch.from_numpy(x))
    for k in ("depth", "depth_conf", "extrinsics", "intrinsics", "ray"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= REL, (k, _rel(got[k].numpy(), want[k]))


def test_nested_preset_at_reference_scale():
    """``da3nested-giant-large`` at its real widths on the meta device: the
    giant anyview net (1.0-1.6 B parameters with its heads, SwiGLU blocks)
    and the metric-large net (24 plain blocks, the sky head)."""
    any_cfg, met_cfg = DA3Config.from_name("da3nested-giant-large")
    jany, jmet = JaxDA3Config.from_name("da3nested-giant-large")
    assert dataclasses.asdict(any_cfg) == dataclasses.asdict(jany)
    assert dataclasses.asdict(met_cfg) == dataclasses.asdict(jmet)
    anyview = DA3(any_cfg, device="meta")
    metric = DA3Mono(met_cfg, device="meta")
    assert 1.0e9 < sum(p.numel() for p in anyview.parameters()) < 1.6e9
    assert len(metric.backbone.blocks_pre) == 24 and hasattr(metric.head, "sky_conv2a")
    assert (any_cfg.embed_dim // any_cfg.num_heads, any_cfg.ffn) == (64, "swiglu")
