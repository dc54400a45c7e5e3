"""The port's VGGSfM tracker (``models/vggt/vggsfm_tracker.py``) and its
loader against the JAX package on the CPU in f32: the encoders, the update
former, the coarse and fine base trackers, the patch crop, the refinement
and the whole coarse-to-fine tracker at its published widths, with the
same weights carried across by the bridge; the checkpoint converter and
``load_vggsfm_tracker`` on a synthetic state dict in the reference
checkpoint's key layout (``virual_tracks`` included).

As in ``test_torch_vggt_track.py``, random weights make the refinement
chaotic (an f32 rounding difference grows about 100x an iteration in
both packages), so the trees damp the update formers' flow heads and
the feature updaters by ``DAMP``; each iteration's coordinates are then held to ``COORD_ATOL``
pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.models.loader as jloader
from videogpa_tpu.models.vggt import vggsfm_tracker as jv
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models import loader as tloader
from videogpa_torch.models.vggt import vggsfm_tracker as tv
from test_torch_bridge import random_jax_tree
from test_torch_vggt_track import FAST_COMPILE

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-5
# the encoders' outputs pass 4-6 instance norms over small maps: a few ulps
# of the normalised values, relative to their size
ENC_ATOL = 1e-4
COORD_ATOL, PROB_ATOL = 1e-3, 1e-5
DAMP = 0.05

_j_tracker = jax.jit(jv.vggsfm_tracker_forward,
                     static_argnames=("coarse_iters", "fine_tracking", "fine_pradius"),
                     compiler_options=FAST_COMPILE)
_j_base = jax.jit(jv.base_tracker_forward, static_argnames=(
    "iters", "stride", "corr_levels", "corr_radius", "latent_dim", "fine", "down_ratio",
    "return_feat"), compiler_options=FAST_COMPILE)
_j_refine = jax.jit(jv.refine_track,
                    static_argnames=("pradius", "fine_iters"), compiler_options=FAST_COMPILE)


def _t(x):
    return torch.from_numpy(np.array(x))


def _damp(base_tree):
    for leaf in (base_tree["updateformer"]["flow_head"], base_tree["ffeat_updater"]):
        leaf["kernel"], leaf["bias"] = leaf["kernel"] * DAMP, leaf["bias"] * DAMP
    return base_tree


@pytest.fixture(scope="module")
def tracker():
    """The published tracker: JAX's tree (flow heads damped) and the port's
    ``VGGSfMTracker`` holding it."""
    params = random_jax_tree(jv.vggsfm_tracker_init, seed=3)
    _damp(params["coarse_predictor"])
    _damp(params["fine_predictor"])
    return params, load_jax_params(tv.VGGSfMTracker(), params).eval()


@pytest.fixture(scope="module")
def clip():
    """3 frames of 128^2 (five pyramid levels at stride 4 on the halved
    images) and 4 query points of frame 0."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (1, 2, 3, 128, 128)).astype(np.float32)
    qp = rng.uniform(20, 108, (1, 4, 2)).astype(np.float32)
    third = np.random.default_rng(1).uniform(0, 1, (1, 1, 3, 128, 128)).astype(np.float32)
    return np.concatenate([images, third], axis=1), qp


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def test_instance_norm_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 7, 9)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(tv._instance_norm(_t(x)).numpy(),
                               np.asarray(jv._instance_norm(jnp.asarray(x))), atol=ATOL,
                               rtol=RTOL)


def test_basic_encoder_matches_jax(tracker):
    """The published coarse encoder (output 128 at stride 4) on 64^2."""
    params, model = tracker
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = jax.jit(jv.basic_encoder_forward, static_argnames=("stride",),
                   compiler_options=FAST_COMPILE)(
        params["coarse_fnet"], jnp.asarray(x), stride=4)
    with torch.no_grad():
        got = tv.basic_encoder_forward(model.coarse_fnet, _t(x), stride=4)
    assert got.shape == want.shape == (2, 128, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL, rtol=RTOL)


def test_shallow_encoder_matches_jax(tracker):
    """The published fine encoder (output 32) on 31^2 patches."""
    params, model = tracker
    x = np.random.default_rng(3).standard_normal((4, 3, 31, 31)).astype(np.float32)
    want = jax.jit(jv.shallow_encoder_forward, static_argnames=("stride",),
                   compiler_options=FAST_COMPILE)(
        params["fine_fnet"], jnp.asarray(x), stride=1)
    with torch.no_grad():
        got = tv.shallow_encoder_forward(model.fine_fnet, _t(x), stride=1)
    assert got.shape == want.shape == (4, 32, 31, 31)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Update former and base tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space_depth", [2, 0])
def test_sfm_updateformer_matches_jax(space_depth):
    """Non-affine eps-1e-6 block norms, the affine context norm; without
    space attention (the fine predictor) no virtual tracks."""
    p = random_jax_tree(jv.sfm_updateformer_init, 20, 32, 6, space_depth, 2, seed=4)
    m = load_jax_params(tv.SfMUpdateFormer(20, 32, 6, space_depth=space_depth, time_depth=2),
                        p)
    assert hasattr(m, "virtual_tracks") == bool(space_depth)
    x = np.random.default_rng(4).standard_normal((2, 5, 3, 20)).astype(np.float32)
    want = jax.jit(jv.sfm_updateformer_forward, static_argnames=("num_heads",),
                   compiler_options=FAST_COMPILE)(
        p, jnp.asarray(x), num_heads=4)
    with torch.no_grad():
        got = tv.sfm_updateformer_forward(m, _t(x), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("levels,radius,latent,fine", [
    (5, 4, 128, False), (3, 3, 32, True), (2, 1, 8, True), (3, 2, 16, False)])
def test_transformer_dim_for_matches_jax(levels, radius, latent, fine):
    """The fine predictor pads by 4 (even) or 5 (odd), the coarse one up to
    a multiple of 4: 661 -> 664 coarse, 211 -> 216 fine."""
    want = jv.transformer_dim_for(levels, radius, latent, fine)
    got = tv.transformer_dim_for(levels, radius, latent, fine)
    assert got == want
    base = levels * (2 * radius + 1) ** 2 + 2 * latent
    assert got - base == ((4 if base % 2 == 0 else 5) if fine else (-base) % 4)


# 5 levels as published (16 -> 8 -> 4 -> 2 -> 1), radius 2, latent 16: the
# tokens are 159 wide and the coarse rule pads them by 1 to 160
_COARSE = dict(stride=4, corr_levels=5, corr_radius=2, latent_dim=16)


@pytest.fixture(scope="module")
def small_coarse():
    """A reduced coarse predictor (latent 16, hidden 32, depth 2) and its
    inputs, as tests/test_vggsfm_tracker_parity.py's."""
    params = _damp(random_jax_tree(jv.base_tracker_init, 4, 5, 2, 16, 32, True, 2, False,
                                   seed=5))
    model = load_jax_params(tv.BaseTracker(stride=4, corr_levels=5, corr_radius=2,
                                           latent_dim=16, hidden_size=32, depth=2), params)
    rng = np.random.default_rng(5)
    fmaps = rng.standard_normal((1, 3, 16, 16, 16)).astype(np.float32)
    qp = rng.uniform(4, 120, (1, 5, 2)).astype(np.float32)
    return params, model.eval(), fmaps, qp


def test_base_tracker_forward_coarse_matches_jax(small_coarse):
    params, model, fmaps, qp = small_coarse
    kw = dict(iters=3, down_ratio=2, return_feat=True, **_COARSE)
    wc, wv, wf, wq = _j_base(params, jnp.asarray(qp), jnp.asarray(fmaps), **kw)
    with torch.no_grad():
        gc, gv, gf, gq = tv.base_tracker_forward(model, _t(qp), _t(fmaps), **kw)
    assert len(gc) == 3 and gc[-1].shape == (1, 3, 5, 2)
    for g, w in zip(gc, wc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=COORD_ATOL)
    np.testing.assert_array_equal(gc[-1][:, 0].numpy(), qp)  # frame 0 kept every iteration
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=PROB_ATOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=ATOL, rtol=RTOL)


def test_base_tracker_forward_fine_has_no_vis_and_matches_jax(tracker):
    """The published fine predictor inside 31^2 patch features: no space
    attention, no vis head, transformer dim 216."""
    params, model = tracker
    rng = np.random.default_rng(6)
    fmaps = rng.standard_normal((3, 2, 32, 31, 31)).astype(np.float32)
    qp = rng.uniform(14, 16, (3, 1, 2)).astype(np.float32)
    kw = dict(iters=2, stride=1, corr_levels=3, corr_radius=3, latent_dim=32, fine=True)
    wc, wv = _j_base(params["fine_predictor"], jnp.asarray(qp), jnp.asarray(fmaps), **kw)
    with torch.no_grad():
        gc, gv = tv.base_tracker_forward(model.fine_predictor, _t(qp), _t(fmaps), **kw)
    assert gv is None and wv is None
    for g, w in zip(gc, wc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=COORD_ATOL)


# ---------------------------------------------------------------------------
# Fine refinement and the whole tracker
# ---------------------------------------------------------------------------

def test_extract_patches_matches_jax():
    rng = np.random.default_rng(7)
    images = rng.standard_normal((2, 3, 40, 40)).astype(np.float32)
    topleft = rng.integers(0, 40 - 7, (2, 5, 2)).astype(np.int32)
    want = jv.extract_patches(jnp.asarray(images), jnp.asarray(topleft), 7)
    got = tv.extract_patches(_t(images), _t(topleft).long(), 7)
    assert got.shape == want.shape == (2, 5, 3, 7, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b, n = 1, 3
    x, y = topleft[b, n]
    np.testing.assert_array_equal(got[b, n].numpy(), images[b, :, y:y + 7, x:x + 7])


def test_refine_track_matches_jax(tracker):
    """Coarse tracks near and past the borders (the top-left clamp), the
    published fine encoder and predictor, pradius 15, 6 iterations; frame
    0 comes back as the query."""
    params, model = tracker
    rng = np.random.default_rng(8)
    images = rng.uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    coarse = rng.uniform(-4, 68, (1, 2, 3, 2)).astype(np.float32)
    want = _j_refine(jnp.asarray(images), params["fine_fnet"], params["fine_predictor"],
                     jnp.asarray(coarse))
    with torch.no_grad():
        got = tv.refine_track(_t(images), model.fine_fnet, model.fine_predictor, _t(coarse))
    assert got.shape == want.shape == (1, 2, 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=COORD_ATOL)
    np.testing.assert_array_equal(got[:, 0].numpy(), coarse[:, 0])


@pytest.mark.parametrize("fine_tracking,coarse_iters", [(True, 6), (False, 2)])
def test_vggsfm_tracker_forward_matches_jax(tracker, clip, fine_tracking, coarse_iters):
    """The whole tracker at its published widths on 128^2 frames: encoder,
    6 coarse iterations and the fine stage on 2 frames, or (as
    tests/test_vggt_sfm.py:151 runs it) 2 iterations and the all-ones
    score on 3, the shapes ``predict_tracks`` gives it in
    test_torch_vggt_sfm.py (one compile where both files share a process).
    The fine stage crops at floor(coarse track): the coarse tracks lie off
    integers by more than their difference between the packages, so both
    crop the same patches."""
    params, model = tracker
    images, qp = clip
    S = 2 if fine_tracking else 3
    images = images[:, :S]
    kw = dict(fine_tracking=fine_tracking, coarse_iters=coarse_iters)
    want = _j_tracker(params, jnp.asarray(images), jnp.asarray(qp), **kw)
    with torch.no_grad():
        got = tv.vggsfm_tracker_forward(model, _t(images), _t(qp), **kw)
    fine, coarse, vis, score = got
    if fine_tracking:
        frac = coarse[:, 1:].numpy() % 1.0
        assert np.minimum(frac, 1 - frac).min() > 10 * COORD_ATOL
    assert fine.shape == coarse.shape == (1, S, 4, 2) and vis.shape == (1, S, 4)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(want[1]), atol=COORD_ATOL)
    np.testing.assert_allclose(fine.numpy(), np.asarray(want[0]), atol=COORD_ATOL)
    np.testing.assert_allclose(vis.numpy(), np.asarray(want[2]), atol=PROB_ATOL)
    if fine_tracking:
        assert score is None and want[3] is None
    else:
        assert torch.equal(score, torch.ones_like(vis)) and torch.equal(fine, coarse)
    np.testing.assert_array_equal(fine[:, 0].numpy(), qp)


def test_process_images_to_fmaps_halves_without_antialias_as_jax(tracker, clip):
    params, model = tracker
    images = clip[0][0, :2]
    want = jax.jit(jv.process_images_to_fmaps, compiler_options=FAST_COMPILE)(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = tv.process_images_to_fmaps(model, _t(images))
    assert got.shape == want.shape == (2, 128, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Initialisers, converter and loader
# ---------------------------------------------------------------------------

_INITS = {
    "vggsfm_tracker": (lambda: jv.vggsfm_tracker_init(jax.random.PRNGKey(0)),
                       lambda g: tv.vggsfm_tracker_init(g, device="cpu")),
    "basic_encoder": (lambda: jv.basic_encoder_init(jax.random.PRNGKey(0), 3, 64),
                      lambda g: tv.basic_encoder_init(3, 64, generator=g, device="cpu")),
    "shallow_encoder": (lambda: jv.shallow_encoder_init(jax.random.PRNGKey(0)),
                        lambda g: tv.shallow_encoder_init(generator=g, device="cpu")),
    "sfm_updateformer": (lambda: jv.sfm_updateformer_init(jax.random.PRNGKey(0), 20, 32, 6, 0, 2),
                         lambda g: tv.sfm_updateformer_init(20, 32, 6, 0, 2, generator=g,
                                                            device="cpu")),
    "base_tracker_fine": (
        lambda: jv.base_tracker_init(jax.random.PRNGKey(0), 1, 3, 3, 32, 256, False, 4, True),
        lambda g: tv.base_tracker_init(g, device="cpu", stride=1, corr_levels=3, corr_radius=3,
                                       latent_dim=32, hidden_size=256, use_spaceatt=False,
                                       depth=4, fine=True)),
}


@pytest.mark.parametrize("name", list(_INITS))
def test_init_functions_build_the_jax_trees(name):
    """Each ``*_init`` builds the tree JAX's initialiser does, shape for
    shape, its virtual tracks (where it has them) drawn N(0, 1); the fine
    predictor has neither virtual tracks nor a vis head."""
    jinit, tinit = _INITS[name]
    shapes = jax.eval_shape(jinit)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    model = tinit(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    for key, p in model.state_dict().items():
        if key.endswith("virtual_tracks"):
            assert 0.8 < float(p.std()) < 1.2, key
    if name == "vggsfm_tracker":
        assert not hasattr(model.fine_predictor.updateformer, "virtual_tracks")
        assert not hasattr(model.fine_predictor, "vis_predictor")


@pytest.fixture(scope="module")
def checkpoint():
    """A synthetic ``vggsfm_v2_tracker.pt`` state dict: torch tensors under
    the reference's keys (``virual_tracks``, ``downsample.0``,
    ``in_proj_weight``, ``cross_attn``, ``ffeat_updater.0``), each key read
    by the JAX converter."""
    rng = np.random.default_rng(9)
    sd = {}
    for k, v in tv.VGGSfMTracker(device="meta").state_dict().items():
        sd[tv._upstream_key(k)] = torch.from_numpy(
            rng.standard_normal(tuple(v.shape)).astype(np.float32))
    return sd


def test_convert_vggsfm_tracker_matches_jax(checkpoint):
    jtree = jv.convert_vggsfm_tracker(checkpoint)
    want = {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jtree)).items()}
    # each JAX leaf reads its own checkpoint key: every key of the layout is read
    assert len(want) == len(checkpoint)
    assert "coarse_predictor.updateformer.virual_tracks" in checkpoint
    got = tv.convert_vggsfm_tracker(checkpoint)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError, match="virual_tracks"):
        tv.convert_vggsfm_tracker({k: v for k, v in checkpoint.items()
                                   if "virual" not in k})


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_vggsfm_tracker_matches_jax(checkpoint, tmp_path, wrapped):
    """``load_vggsfm_tracker`` reads a torch file (weights only, under
    ``"state_dict"`` or bare) into the published module on the CPU, equal to
    JAX's loader + bridge."""
    path = str(tmp_path / "vggsfm_v2_tracker.pt")
    torch.save({"state_dict": checkpoint} if wrapped else checkpoint, path)
    model = tloader.load_vggsfm_tracker(path, device="cpu")
    want = state_dict_from_jax(jax.tree.map(np.asarray, jloader.load_vggsfm_tracker(path)))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert isinstance(model, tv.VGGSfMTracker) and not any(p.requires_grad
                                                           for p in model.parameters())
