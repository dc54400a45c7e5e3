"""The port's VGGT track head (``models/vggt/track.py``), the DPT head's
``features`` / ``down_ratio`` options, ``vggt_forward(query_points=)``,
``convert_dinov2`` and ``visual_track`` against the JAX package on the CPU
in f32, with the same weights carried across by the bridge and the same
inputs made with numpy.

Random weights make the tracker's refinement chaotic: an f32 rounding
difference grows about 100x an iteration in both packages (a float64 run
of the port sits as far from either as they sit from each other). The
trees here damp the update former's flow head and the feature updater by
``DAMP`` so that the iterations contract, as a trained tracker's do; each iteration's
coordinates are then held to ``COORD_ATOL`` pixels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import convert as jconv
from videogpa_tpu.models.vggt import heads as jheads
from videogpa_tpu.models.vggt import model as jmodel
from videogpa_tpu.models.vggt import track as jt
from videogpa_tpu.models.vggt import visual_track as jvis
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward, vggt_init
from videogpa_torch.models.vggt import convert as tconv
from videogpa_torch.models.vggt import heads as theads
from videogpa_torch.models.vggt import track as tt
from videogpa_torch.models.vggt import visual_track as tvis
from videogpa_torch.models.vggt.vit import DinoV2, dinov2_forward
from videogpa_torch.ops import layers as TL
from videogpa_torch.ops.resize import grid_sample_bilinear
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 on both sides: summation order only, a few ulps an op
ATOL, RTOL = 1e-5, 1e-5
# tracked pixel coordinates after the damped refinement iterations, and the
# sigmoid outputs vis / conf
COORD_ATOL, PROB_ATOL = 1e-3, 1e-5
DAMP = 0.05
# the reduced tracker of tests/test_vggt.py's TestTrackHead
LATENT, HIDDEN, LEVELS, RADIUS, DEPTH = 16, 32, 3, 2, 2

# The JAX references are compiled without LLVM's costly passes: XLA's CPU
# compile is most of these files' time, and this takes a third off it. Each
# reference still runs in f32 with XLA's own fusions.
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}
_j_tracker = jax.jit(jt.tracker_forward, static_argnames=(
    "iters", "stride", "corr_levels", "corr_radius", "latent_dim", "down_ratio"),
    compiler_options=FAST_COMPILE)
_j_track_head = jax.jit(jt.track_head_forward, static_argnums=(2, 4),
                        static_argnames=("iters", "corr_levels", "corr_radius"),
                        compiler_options=FAST_COMPILE)
_j_updateformer = jax.jit(jt.updateformer_forward, static_argnames=("num_heads",),
                          compiler_options=FAST_COMPILE)
_j_dpt = jax.jit(jheads.dpt_head_forward, static_argnums=(2, 3),
                 static_argnames=("feature_only", "down_ratio", "use_pos_embed", "chunk_size",
                                  "activation", "conf_activation"),
                 compiler_options=FAST_COMPILE)
# bound here: test_torch_vggt_sfm.py patches the module's name to this jit
_jax_vggt_forward = jmodel.vggt_forward


@functools.partial(jax.jit, static_argnums=(2,), static_argnames=("track_items",),
                   compiler_options=FAST_COMPILE)
def _j_vggt(params, images, cfg, query_points, track_items=()):
    """JAX's f32 ``vggt_forward``, shared with test_torch_vggt_sfm.py: this
    file's query forward has the shapes of ``predict_tracks``' there, so a
    process running both compiles it once."""
    return _jax_vggt_forward(params, images, cfg, attn_impl="xla",
                             compute_dtype=jnp.float32, query_points=query_points,
                             track_kwargs=dict(track_items))


def _t(x):
    return torch.from_numpy(np.array(x))


def _damp(tracker_tree):
    for leaf in (tracker_tree["updateformer"]["flow_head"], tracker_tree["ffeat_updater"]):
        leaf["kernel"], leaf["bias"] = leaf["kernel"] * DAMP, leaf["bias"] * DAMP
    return tracker_tree


def reduced_track_tree(jcfg, seed=5):
    """A JAX track-head tree at the reduced widths (``features`` 16)."""
    return {"feature_extractor": random_jax_tree(jheads.dpt_head_init, jcfg, 0, jnp.float32,
                                                 LATENT, True, seed=seed),
            "tracker": _damp(random_jax_tree(jt.tracker_init, LATENT, HIDDEN, LEVELS, RADIUS,
                                             DEPTH, seed=seed + 1))}


def reduced_track_head(cfg):
    return tt.TrackHead(cfg, features=LATENT, hidden_size=HIDDEN, corr_levels=LEVELS,
                        corr_radius=RADIUS, depth=DEPTH)


@pytest.fixture(scope="module")
def tiny_track():
    """The tiny VGGT with the reduced track head: the JAX tree and the
    port's model holding the same weights."""
    cfg, jcfg = VGGTConfig.tiny(), JaxVGGTConfig.tiny()
    params = random_jax_tree(jmodel.vggt_init, jcfg)
    params["track_head"] = reduced_track_tree(jcfg)
    model = VGGT(cfg)
    model.track_head = reduced_track_head(cfg)
    return cfg, params, load_jax_params(model, params).eval()


@pytest.fixture(scope="module")
def tracker_case():
    """tests/test_vggt.py::TestTrackHead::test_tracking_smoke's sizes."""
    params = _damp(random_jax_tree(jt.tracker_init, LATENT, HIDDEN, LEVELS, RADIUS, DEPTH,
                                   seed=1))
    model = load_jax_params(tt.Tracker(LATENT, HIDDEN, LEVELS, RADIUS, DEPTH), params).eval()
    rng = np.random.default_rng(0)
    fmaps = rng.standard_normal((1, 3, LATENT, 16, 16)).astype(np.float32)
    qp = (rng.uniform(0, 1, (1, 5, 2)) * 24).astype(np.float32)
    return params, model, fmaps, qp


def _run_tracker(params, model, fmaps, qp, iters=2):
    kw = dict(iters=iters, stride=2, corr_levels=LEVELS, corr_radius=RADIUS, latent_dim=LATENT)
    want = _j_tracker(params, jnp.asarray(qp), jnp.asarray(fmaps), **kw)
    with torch.no_grad():
        got = tt.tracker_forward(model, _t(qp), _t(fmaps), **kw)
    return got, want


# ---------------------------------------------------------------------------
# Embeddings and samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,hw", [(388, (7, 9)), (16, (4, 4))])
def test_get_2d_sincos_pos_embed_matches_jax(dim, hw):
    want = jt.get_2d_sincos_pos_embed(dim, hw)
    got = tt.get_2d_sincos_pos_embed(dim, hw)
    assert got.shape == want.shape == (1, dim) + hw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cat_coords", [True, False])
def test_get_2d_embedding_matches_jax(cat_coords):
    xy = np.random.default_rng(1).uniform(-30, 30, (3, 7, 2)).astype(np.float32)
    want = jt.get_2d_embedding(jnp.asarray(xy), 64, cat_coords=cat_coords)
    got = tt.get_2d_embedding(_t(xy), 64, cat_coords=cat_coords)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=RTOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_sample_map_matches_jax_per_map(padding):
    """The port samples a batch of maps (and their channels) in one gather;
    each (H, W) map equals JAX's ``_sample_map`` of it, off the edges too."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    u = rng.uniform(-3, 14, (2, 40)).astype(np.float32)
    v = rng.uniform(-3, 12, (2, 40)).astype(np.float32)
    got = tt._sample_map(_t(img), _t(u), _t(v), padding)
    assert got.shape == (2, 3, 40)
    for b in range(2):
        for c in range(3):
            want = jt._sample_map(jnp.asarray(img[b, c]), jnp.asarray(u[b]), jnp.asarray(v[b]),
                                  padding)
            np.testing.assert_allclose(got[b, c].numpy(), np.asarray(want), atol=ATOL,
                                       rtol=RTOL)


def test_grid_sample_bilinear_batched_is_the_call_on_each_entry():
    """``grid_sample_bilinear(batched=True)``, which ``_sample_map`` calls:
    each entry's (H, W, C) image at its own (M, K) coordinates, off the
    edges too, equals the unbatched call on that entry bit for bit."""
    rng = np.random.default_rng(21)
    img = _t(rng.standard_normal((3, 9, 11, 2)).astype(np.float32))
    u = _t(rng.uniform(-3, 14, (3, 5, 4)).astype(np.float32))
    v = _t(rng.uniform(-3, 12, (3, 5, 4)).astype(np.float32))
    got = grid_sample_bilinear(img, u, v, batched=True)
    assert got.shape == (3, 5, 4, 2)
    for b in range(3):
        assert torch.equal(got[b], grid_sample_bilinear(img[b], u[b], v[b]))


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_sample_features4d_matches_jax(padding):
    rng = np.random.default_rng(3)
    fmap = rng.standard_normal((2, 5, 12, 10)).astype(np.float32)
    coords = rng.uniform(-2, 13, (2, 6, 2)).astype(np.float32)
    want = jt.sample_features4d(jnp.asarray(fmap), jnp.asarray(coords), padding)
    got = tt.sample_features4d(_t(fmap), _t(coords), padding)
    assert got.shape == want.shape == (2, 6, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_avg_pool2_floors_odd_sizes_as_jax():
    """At 518^2 the track features are 259^2 and the 7-level pyramid goes
    259 -> 129 -> 64 -> 32 -> 16 -> 8 -> 4: each odd size drops its last
    row and column, as ``F.avg_pool2d`` does (a ceil would give 130)."""
    x = np.random.default_rng(4).standard_normal((2, 3, 259, 259)).astype(np.float32)
    sizes, tx, jx = [], _t(x), jnp.asarray(x)
    for _ in range(6):
        tx, jx = tt._avg_pool2(tx), jt._avg_pool2(jx)
        sizes.append(tx.shape[-1])
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            tx.numpy(), torch.nn.functional.avg_pool2d(_t(x), 2 ** len(sizes)).numpy(),
            atol=ATOL, rtol=RTOL)
    assert sizes == [129, 64, 32, 16, 8, 4]


def test_corr_pyramid_sample_matches_jax():
    rng = np.random.default_rng(5)
    fmaps = rng.standard_normal((1, 3, 8, 19, 17)).astype(np.float32)
    targets = rng.standard_normal((1, 3, 4, 8)).astype(np.float32)
    coords = rng.uniform(-2, 20, (1, 3, 4, 2)).astype(np.float32)
    want = jt.corr_pyramid_sample(jnp.asarray(fmaps), jnp.asarray(targets),
                                  jnp.asarray(coords), 3, 2)
    got = tt.corr_pyramid_sample(_t(fmaps), _t(targets), _t(coords), 3, 2)
    assert got.shape == want.shape == (1, 3, 4, 3 * 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_corr_window_puts_the_x_offset_on_the_first_axis():
    """Correlations that equal the column index: window slot (i, j) must
    read x + d[i] (the reference's flatten order, which converted
    checkpoints expect), so the slots vary along i, not j."""
    H, W, r = 12, 14, 2
    fmaps = torch.arange(W, dtype=torch.float32).expand(1, 1, 1, H, W).clone()
    targets = torch.ones((1, 1, 1, 1))
    coords = torch.tensor([[[[6.0, 5.0]]]])
    got = tt.corr_pyramid_sample(fmaps, targets, coords, 1, r).reshape(5, 5)
    want = jt.corr_pyramid_sample(jnp.asarray(fmaps.numpy()), jnp.ones((1, 1, 1, 1)),
                                  jnp.asarray(coords.numpy()), 1, r).reshape(5, 5)
    d = torch.arange(-r, r + 1, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), (6.0 + d)[:, None].expand(5, 5).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Update former, tracker and head
# ---------------------------------------------------------------------------

def test_updateformer_matches_jax():
    p = random_jax_tree(jt.updateformer_init, 20, 32, 6, 2, 4, seed=7)
    m = load_jax_params(tt.UpdateFormer(20, 32, 6, space_depth=2, time_depth=4), p)
    x = np.random.default_rng(7).standard_normal((2, 5, 3, 20)).astype(np.float32)
    want = _j_updateformer(p, jnp.asarray(x), num_heads=4)
    with torch.no_grad():
        got = tt.updateformer_forward(m, _t(x), num_heads=4)
    assert got.shape == want.shape == (2, 5, 3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_tracker_forward_matches_jax(tracker_case):
    """tests/test_vggt.py:61's smoke, against JAX: every iteration's
    coordinates, vis and conf in [0, 1], frame 0 kept at the queries."""
    params, model, fmaps, qp = tracker_case
    (coords, vis, conf), (wc, wv, wf) = _run_tracker(params, model, fmaps, qp)
    assert len(coords) == 2 and coords[-1].shape == (1, 3, 5, 2)
    for g, w in zip(coords, wc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=COORD_ATOL)
    np.testing.assert_allclose(vis.numpy(), np.asarray(wv), atol=PROB_ATOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(wf), atol=PROB_ATOL)
    assert bool(((vis >= 0) & (vis <= 1)).all()) and bool(((conf >= 0) & (conf <= 1)).all())
    np.testing.assert_array_equal(coords[-1][:, 0].numpy(), qp)


@pytest.mark.parametrize("exact_at", [1, 2])
def test_tracker_gelus_are_tanh_where_jax_uses_its_default(exact_at, monkeypatch):
    """``track.py:326,351`` call ``jax.nn.gelu(x)``: the tanh form, first in
    the correlation MLP, then in the feature updater. One iteration of an
    undamped tracker (no chaos yet) matches JAX to f32 rounding; the exact
    GELU at either place alone moves vis and conf (both read the updated
    track features) by far more (the blocks' MLPs stay exact)."""
    params = random_jax_tree(jt.tracker_init, LATENT, HIDDEN, LEVELS, RADIUS, DEPTH, seed=2)
    # pre-activations of order 1-3, where the two GELU forms differ most
    for leaf in (params["corr_mlp"]["fc1"], params["ffeat_updater"]):
        leaf["kernel"] = leaf["kernel"] * 4
    model = load_jax_params(tt.Tracker(LATENT, HIDDEN, LEVELS, RADIUS, DEPTH), params).eval()
    rng = np.random.default_rng(3)
    fmaps = rng.standard_normal((1, 3, LATENT, 16, 16)).astype(np.float32)
    qp = (rng.uniform(0, 1, (1, 5, 2)) * 24).astype(np.float32)

    def err():
        (_, vis, conf), (_, wv, wf) = _run_tracker(params, model, fmaps, qp, iters=1)
        return max(np.abs(g.numpy() - np.asarray(w)).max() for g, w in ((vis, wv), (conf, wf)))

    tanh_err = err()
    assert tanh_err < 1e-6
    calls = []

    def gelu(x):
        calls.append(1)
        return torch.nn.functional.gelu(x, approximate="none" if len(calls) == exact_at
                                        else "tanh")

    monkeypatch.setattr(TL, "gelu_tanh", gelu)
    assert err() > 20 * max(tanh_err, 1e-7)
    assert len(calls) == 2


def test_track_head_forward_matches_jax(tiny_track):
    """The head on random layer outputs: DPT features at half resolution
    (no pos-embed), then 2 iterations of the reduced tracker."""
    cfg, params, model = tiny_track
    tokens = np.random.default_rng(8).standard_normal(
        (4, 1, 2, 21, cfg.tokens_dim)).astype(np.float32)
    qp = np.random.default_rng(9).uniform(0, 56, (1, 4, 2)).astype(np.float32)
    kw = dict(iters=2, corr_levels=LEVELS, corr_radius=RADIUS)
    wc, wv, wf = _j_track_head(params["track_head"], jnp.asarray(tokens), (56, 56),
                               jnp.asarray(qp), JaxVGGTConfig.tiny(), **kw)
    with torch.no_grad():
        gc, gv, gf = tt.track_head_forward(model.track_head, _t(tokens), (56, 56), _t(qp), cfg,
                                           **kw)
    assert len(gc) == 2 and gc[-1].shape == (1, 2, 4, 2)
    for g, w in zip(gc, wc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=COORD_ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=PROB_ATOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=PROB_ATOL)


@pytest.mark.parametrize("feature_only,down_ratio,use_pos_embed", [
    (True, 2, False), (True, 1, True), (False, 2, True)])
def test_dpt_features_and_down_ratio_match_jax(feature_only, down_ratio, use_pos_embed):
    """``DPTHead(features=)`` and ``dpt_head_forward(down_ratio=)`` against
    ``dpt_head_init(features=)`` / ``dpt_head_forward(down_ratio=)``."""
    cfg, jcfg = VGGTConfig.tiny(), JaxVGGTConfig.tiny()
    out_dim = 0 if feature_only else 2
    p = random_jax_tree(jheads.dpt_head_init, jcfg, out_dim, jnp.float32, 24, feature_only,
                        seed=11)
    head = load_jax_params(theads.DPTHead(cfg, out_dim, features=24,
                                          feature_only=feature_only), p)
    tokens = np.random.default_rng(12).standard_normal(
        (4, 1, 2, 21, cfg.tokens_dim)).astype(np.float32)
    kw = dict(feature_only=feature_only, down_ratio=down_ratio, use_pos_embed=use_pos_embed)
    want = _j_dpt(p, jnp.asarray(tokens), jcfg, (56, 56), **kw)
    with torch.no_grad():
        got = theads.dpt_head_forward(head, _t(tokens), cfg, (56, 56), down_ratio=down_ratio,
                                      use_pos_embed=use_pos_embed)
    got, want = (got,) if feature_only else got, (want,) if feature_only else want
    side = 56 // down_ratio
    assert got[0].shape[2:4] == ((24, side) if feature_only else (side, side))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_existing_callers_keep_their_outputs_bit_for_bit(tiny_track):
    """``down_ratio=1`` and ``features=None`` are the old head; a model with a
    track head draws and returns the other outputs exactly as one without."""
    cfg, _, model = tiny_track
    tokens = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (4, 1, 2, 21, cfg.tokens_dim)).astype(np.float32))
    assert model.depth_head.output_conv1.weight.shape[0] == cfg.dpt_features // 2
    with torch.no_grad():
        base = theads.dpt_head_forward(model.depth_head, tokens, cfg, (56, 56))
        same = theads.dpt_head_forward(model.depth_head, tokens, cfg, (56, 56), down_ratio=1)
    for a, b in zip(base, same):
        assert torch.equal(a, b)
    plain = vggt_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    tracked = vggt_init(cfg, torch.Generator().manual_seed(3), device="cpu", enable_track=True)
    sd = tracked.state_dict()
    for k, v in plain.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # N(0, 1), as JAX draws it
    assert float(tracked.track_head.tracker.query_ref_token.detach().std()) > 0.5
    images = torch.from_numpy(np.random.default_rng(14).uniform(0, 1, (1, 2, 3, 56, 56))
                              .astype(np.float32))
    with torch.no_grad():
        a = vggt_forward(plain, images, compute_dtype=torch.float32)
        b = vggt_forward(tracked, images, compute_dtype=torch.float32)
    assert set(a) == set(b) and "track" not in b
    for k in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf"):
        assert torch.equal(a[k], b[k]), k


def test_vggt_forward_with_query_points_matches_jax(tiny_track):
    """``vggt_forward(query_points=)`` adds track, vis and conf exactly when
    JAX does; a rank-2 query gets a batch axis (the same outputs). 3 frames
    of 128^2 and 16 queries: the shapes of ``predict_tracks``' forwards in
    test_torch_vggt_sfm.py."""
    cfg, params, model = tiny_track
    images = np.random.default_rng(15).uniform(0, 1, (1, 3, 3, 128, 128)).astype(np.float32)
    qp = np.random.default_rng(16).uniform(4, 124, (1, 16, 2)).astype(np.float32)
    items = (("corr_levels", LEVELS), ("corr_radius", RADIUS), ("iters", 2))
    want = _j_vggt(params, jnp.asarray(images), JaxVGGTConfig.tiny(), jnp.asarray(qp),
                   track_items=items)
    with torch.no_grad():
        got = vggt_forward(model, _t(images), compute_dtype=torch.float32, query_points=_t(qp),
                           track_kwargs=dict(items))
        rank2 = vggt_forward(model, _t(images), compute_dtype=torch.float32,
                             query_points=_t(qp[0]), track_kwargs=dict(items))
    assert set(got) == set(want) == set(rank2)
    assert got["track"].shape == (1, 3, 16, 2) and got["vis"].shape == (1, 3, 16)
    np.testing.assert_allclose(got["track"].numpy(), np.asarray(want["track"]), atol=COORD_ATOL)
    for k in ("vis", "conf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PROB_ATOL,
                                   err_msg=k)
    for k in ("pose_enc", "depth", "world_points"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL)
    for k in ("track", "vis", "conf"):
        assert torch.equal(rank2[k], got[k]), k
    np.testing.assert_array_equal(got["track"][:, 0].numpy(), qp)


def test_vggt_init_enable_track_tree_loads_into_the_port():
    """JAX's ``vggt_init(enable_track=True)`` tree (published track head:
    features 128, hidden 384, 7 levels, radius 4, depth 6) goes through the
    bridge into ``VGGT(cfg, enable_track=True)``, strictly, leaf for leaf."""
    jcfg = JaxVGGTConfig.tiny()
    params = random_jax_tree(jmodel.vggt_init, jcfg, jnp.float32, True, seed=17)
    model = load_jax_params(VGGT(VGGTConfig.tiny(), enable_track=True), params)
    th = params["track_head"]["tracker"]
    np.testing.assert_array_equal(model.track_head.tracker.query_ref_token.detach().numpy(),
                                  th["query_ref_token"])
    np.testing.assert_array_equal(
        model.track_head.tracker.updateformer.virtual_tracks.detach().numpy(),
        th["updateformer"]["virtual_tracks"])
    assert model.track_head.tracker.updateformer.virtual_tracks.shape == (1, 64, 1, 384)
    assert len(model.track_head.tracker.updateformer.space_virtual2point_blocks) == 6


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


_INITS = {
    "tracker": (lambda: jt.tracker_init(jax.random.PRNGKey(0)),
                lambda g: tt.tracker_init(generator=g, device="cpu")),
    "tracker_reduced": (
        lambda: jt.tracker_init(jax.random.PRNGKey(0), LATENT, HIDDEN, LEVELS, RADIUS, DEPTH),
        lambda g: tt.tracker_init(LATENT, HIDDEN, LEVELS, RADIUS, DEPTH, generator=g,
                                  device="cpu")),
    "track_head": (lambda: jt.track_head_init(jax.random.PRNGKey(0), JaxVGGTConfig.tiny()),
                   lambda g: tt.track_head_init(VGGTConfig.tiny(), generator=g, device="cpu")),
    "updateformer": (lambda: jt.updateformer_init(jax.random.PRNGKey(0), 20, 32, 6, 1, 2),
                     lambda g: tt.updateformer_init(20, 32, 6, 1, 2, generator=g,
                                                    device="cpu")),
}


@pytest.mark.parametrize("name", list(_INITS))
def test_init_functions_build_the_jax_trees(name):
    """Each ``*_init`` builds the tree JAX's initialiser does, shape for
    shape (the bridge names every leaf), its tokens drawn N(0, 1)."""
    jinit, tinit = _INITS[name]
    shapes = jax.eval_shape(jinit)
    want = _shapes(state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                    shapes)))
    module = tinit(torch.Generator().manual_seed(0))
    assert _shapes(module.state_dict()) == want
    for key, p in module.state_dict().items():
        if key.endswith(("virtual_tracks", "query_ref_token")):
            assert 0.5 < float(p.std()) < 1.5, key


# ---------------------------------------------------------------------------
# convert_dinov2, visual_track
# ---------------------------------------------------------------------------

def test_convert_dinov2_matches_jax():
    """An upstream DINOv2 state dict under a prefix: the port's converter and
    JAX's converter + bridge give the same ``DinoV2`` state dict, which runs
    as JAX's ``dinov2_forward`` on the converted tree."""
    from videogpa_tpu.models.vggt import vit as jvit

    cfg = VGGTConfig.tiny()
    model = DinoV2(cfg)
    rng = np.random.default_rng(18)
    sd = {}
    for k, v in model.state_dict().items():
        up = k.replace("patch_embed.", "patch_embed.proj.")
        sd[f"pe.{up}"] = rng.standard_normal(v.shape).astype(np.float32) * 0.1
    sd["pe.mask_token"] = np.zeros((1, cfg.backbone_dim), np.float32)  # read by neither
    got = tconv.convert_dinov2(sd, "pe", cfg.backbone_depth)
    jtree = jconv.convert_dinov2(sd, "pe", cfg.backbone_depth)
    want = {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jtree)).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    x = rng.uniform(-1, 1, (2, 3, 28, 42)).astype(np.float32)
    w = jvit.dinov2_forward(jtree, jnp.asarray(x), JaxVGGTConfig.tiny(), attn_impl="xla")
    with torch.no_grad():
        g = dinov2_forward(model, _t(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=RTOL)


def test_visual_track_writes_what_jax_writes(tmp_path):
    """tests/test_vggt.py:133's case through both packages: the same
    colours and the same PNG bytes, frame by frame and the grid."""
    S, N, H, W = 3, 5, 32, 48
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (S, 3, H, W)).astype(np.float32)
    tracks = np.stack([np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1)
                       for _ in range(S)])
    mask = np.ones((S, N), bool)
    mask[0, 0] = False
    got = tvis.visualize_tracks_on_images(images, tracks, mask, out_dir=str(tmp_path / "t"))
    want = jvis.visualize_tracks_on_images(images, tracks, mask, out_dir=str(tmp_path / "j"))
    names = [f"frame_{s:04d}.png" for s in range(S)] + ["tracks_grid.png"]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    np.testing.assert_array_equal(tvis.get_track_colors_by_position(tracks, mask, W, H),
                                  jvis.get_track_colors_by_position(tracks, mask, W, H))
    assert got.endswith("t") and want.endswith("j")
