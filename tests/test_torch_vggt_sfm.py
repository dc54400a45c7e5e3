"""The port's SfM pack (``models/vggt/sfm.py``) against the JAX package on
the CPU in f32: distortion, the Newton undistortion and where it stops,
projection, the COLMAP interop, the query-frame ranking, and
``predict_tracks`` on the VGGT head and on the VGGSfM tracker (mirroring
``tests/test_vggt_sfm.py``), with the same weights carried across by the
bridge and the same inputs made with numpy. The JAX references run jitted
in f32 (``predict_tracks``' inner forwards patched to them, the port's to
``compute_dtype=float32``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import model as jmodel
from videogpa_tpu.models.vggt import sfm as jsfm
from videogpa_tpu.models.vggt import vggsfm_tracker as jv
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward
from videogpa_torch.models.vggt import sfm as tsfm
from videogpa_torch.models.vggt import vggsfm_tracker as tv
from test_torch_bridge import random_jax_tree
# one compile of the tracker where both files share a process
from test_torch_vggsfm_tracker import _j_tracker
# and of the tiny VGGT's query forward
from test_torch_vggt_track import (COORD_ATOL, LEVELS, PROB_ATOL, RADIUS, _damp, _j_vggt,
                                   reduced_track_head, reduced_track_tree)

torch.set_num_threads(2)
ATOL, RTOL = 1e-6, 1e-5



def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def f32_forwards(monkeypatch):
    """Both packages' ``predict_tracks`` run their inner forwards in f32,
    the JAX ones jitted."""
    def jax_vggt(params, x, cfg, query_points=None, track_kwargs=None):
        return _j_vggt(params, x, cfg, query_points,
                       track_items=tuple(sorted((track_kwargs or {}).items())))

    def jax_tracker(params, images, query_points, **kw):
        return _j_tracker(params, images, query_points, **kw)

    monkeypatch.setattr(jmodel, "vggt_forward", jax_vggt)
    monkeypatch.setattr(jv, "vggsfm_tracker_forward", jax_tracker)
    monkeypatch.setattr(tsfm, "vggt_forward",
                        functools.partial(vggt_forward, compute_dtype=torch.float32))


# ---------------------------------------------------------------------------
# Distortion and projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_apply_distortion_matches_jax(k):
    rng = np.random.default_rng(0)
    params = rng.uniform(-0.05, 0.05, (3, k)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, (3, 50)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (3, 50)).astype(np.float32)
    wu, wv = jsfm.apply_distortion(jnp.asarray(params), jnp.asarray(u), jnp.asarray(v))
    gu, gv = tsfm.apply_distortion(_t(params), _t(u), _t(v))
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=RTOL)


def test_apply_distortion_rejects_other_parameter_counts():
    with pytest.raises(ValueError, match="3"):
        tsfm.apply_distortion(torch.zeros(1, 3), torch.zeros(1, 2), torch.zeros(1, 2))


def _count_steps(monkeypatch):
    """Count the port's Newton steps: each calls apply_distortion 5 times."""
    calls = []
    real = tsfm.apply_distortion
    monkeypatch.setattr(tsfm, "apply_distortion", lambda *a: calls.append(1) or real(*a))
    return lambda: len(calls) // 5


@pytest.mark.parametrize("k", [1, 2, 4])
def test_iterative_undistortion_matches_jax_and_inverts(k, monkeypatch):
    """tests/test_vggt_sfm.py's case (it stops well before 100 steps)."""
    rng = np.random.default_rng(1)
    params = rng.uniform(-0.05, 0.05, (2, k)).astype(np.float32)
    tracks = rng.uniform(-0.6, 0.6, (2, 40, 2)).astype(np.float32)
    steps = _count_steps(monkeypatch)
    want = jsfm.iterative_undistortion(jnp.asarray(params), jnp.asarray(tracks))
    got = tsfm.iterative_undistortion(_t(params), _t(tracks))
    assert 1 < steps() < 100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    du, dv = tsfm.apply_distortion(_t(params), got[..., 0], got[..., 1])
    np.testing.assert_allclose(du.numpy(), tracks[..., 0], atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), tracks[..., 1], atol=1e-4)


def test_iterative_undistortion_stops_on_the_global_step_as_jax(monkeypatch):
    """Strong distortion, one far track, in float64 (in f32 the numeric
    Jacobian's 1e-6 relative step is at f32's rounding, and the two packages'
    steps differ by ~1e-3 at that track): the loop runs while the *largest*
    squared step of the batch is at least ``max_step_norm``, as JAX's
    ``lax.while_loop``. Stopping after a fixed 100 steps, or stopping each
    track on its own step, lands elsewhere."""
    params = np.array([[-0.3, 0.1, 0.01, -0.02]])
    rng = np.random.default_rng(2)
    tracks = np.concatenate([rng.uniform(-0.2, 0.2, (1, 8, 2)), [[[0.9, -0.8]]]], axis=1)
    steps = _count_steps(monkeypatch)
    with jax.enable_x64(True):
        want = np.asarray(jsfm.iterative_undistortion(jnp.asarray(params), jnp.asarray(tracks),
                                                      max_step_norm=1e-8))
    assert want.dtype == np.float64
    got = tsfm.iterative_undistortion(_t(params), _t(tracks), max_step_norm=1e-8).numpy()
    n = steps()
    assert 2 < n < 100
    np.testing.assert_allclose(got, want, atol=1e-12)
    fixed = tsfm.iterative_undistortion(_t(params), _t(tracks), max_step_norm=0.0).numpy()
    assert steps() == n + 100
    assert np.abs(fixed - want).max() > 1e-6
    own = [tsfm.iterative_undistortion(_t(params), _t(tracks[:, i:i + 1]),
                                       max_step_norm=1e-8).numpy() for i in range(8)]
    assert np.abs(np.concatenate(own, axis=1) - want[:, :8]).max() > 1e-6


@pytest.mark.parametrize("distort", [True, False])
def test_projection_matches_jax(distort):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((30, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    pts[0, 2] = 0.0  # a point on the camera plane: inf -> finite, as jnp.nan_to_num
    extr = np.tile(np.eye(3, 4, dtype=np.float32)[None], (2, 1, 1))
    extr[:, :3, 3] = rng.standard_normal((2, 3)) * 0.1
    extr[:, 2, 3] = 0.0
    K = np.tile(np.diag([100.0, 100.0, 1.0]).astype(np.float32)[None], (2, 1, 1))
    K[:, 0, 2], K[:, 1, 2] = 64, 48
    extra = rng.uniform(-0.02, 0.02, (2, 1)).astype(np.float32) if distort else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    w2d, wcam = jsfm.project_3d_points(j(pts), j(extr), j(K), j(extra), default=-1.0)
    g2d, gcam = tsfm.project_3d_points(_t(pts), _t(extr), _t(K),
                                       None if extra is None else _t(extra), default=-1.0)
    np.testing.assert_allclose(gcam.numpy(), np.asarray(wcam), atol=1e-5)
    np.testing.assert_allclose(g2d.numpy(), np.asarray(w2d), atol=1e-3, rtol=1e-5)
    assert g2d.shape == (2, 30, 2)
    w_img = jsfm.img_from_cam(j(K), wcam, j(extra), default=-1.0)
    np.testing.assert_allclose(tsfm.img_from_cam(_t(K), gcam, None if extra is None else
                                                 _t(extra), default=-1.0).numpy(),
                               np.asarray(w_img), atol=1e-3, rtol=1e-5)
    none, cam = tsfm.project_3d_points(_t(pts), _t(extr), only_points_cam=True)
    assert none is None and torch.equal(cam, gcam)
    with pytest.raises(ValueError, match="intrinsics"):
        tsfm.project_3d_points(_t(pts), _t(extr))


# ---------------------------------------------------------------------------
# COLMAP interop and ranking
# ---------------------------------------------------------------------------

def _rotations(rng, B):
    q, _ = np.linalg.qr(rng.standard_normal((B, 3, 3)))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("shared_camera", [False, True])
def test_colmap_interop_matches_jax_and_round_trips(shared_camera):
    rng = np.random.default_rng(4)
    P, B = 20, 3
    pts = rng.standard_normal((P, 3)).astype(np.float32)
    extr = np.zeros((B, 3, 4), np.float32)
    extr[:, :, :3] = _rotations(rng, B)
    extr[:, :, 3] = rng.standard_normal((B, 3))
    K = np.tile(np.diag([80.0, 82.0, 1.0]).astype(np.float32)[None], (B, 1, 1))
    K[:, 0, 2], K[:, 1, 2] = 32, 24
    tracks = rng.uniform(0, 64, (B, P, 2)).astype(np.float32)
    mask = rng.uniform(size=(B, P)) > 0.3
    got = tsfm.batch_matrix_to_colmap(pts, extr, K, tracks, mask, (64, 48), shared_camera)
    want = jsfm.batch_matrix_to_colmap(pts, extr, K, tracks, mask, (64, 48), shared_camera)
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert set(gc) == set(wc) == ({1} if shared_camera else {1, 2, 3})
    for c in wc:
        assert (gc[c].model, gc[c].width, gc[c].height) == (wc[c].model, 64, 48)
        np.testing.assert_array_equal(gc[c].params, wc[c].params)
    for i in wi:
        np.testing.assert_allclose(gi[i].qvec, wi[i].qvec, atol=1e-6)
        for f in ("tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(gi[i], f), getattr(wi[i], f))
        assert (gi[i].name, gi[i].camera_id) == (wi[i].name, wi[i].camera_id)
        assert gi[i].xys.shape[0] == int(mask[i - 1].sum())
    for p in wp:
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(gp[p], f), getattr(wp[p], f))
    pts2, extr2, K2 = tsfm.colmap_to_batch_matrix(*got)
    for g, w in zip((pts2, extr2, K2), jsfm.colmap_to_batch_matrix(*want)):
        np.testing.assert_allclose(g, w, atol=1e-6)
    np.testing.assert_allclose(pts2, pts, atol=1e-5)
    np.testing.assert_allclose(extr2, extr, atol=1e-4)
    np.testing.assert_allclose(K2, K, atol=1e-4)


def test_rank_query_frames_matches_jax():
    f = np.array([[1, 0], [1, 0.1], [0, 1.0]], np.float32)
    assert tsfm.rank_query_frames(f, 2) == jsfm.rank_query_frames(f, 2)
    assert tsfm.rank_query_frames(f, 2)[0] in (0, 1)
    feats = np.random.default_rng(5).uniform(0, 1, (7, 30)).astype(np.float32)
    assert tsfm.rank_query_frames(feats, 4) == jsfm.rank_query_frames(feats, 4)


# ---------------------------------------------------------------------------
# predict_tracks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_track():
    cfg, jcfg = VGGTConfig.tiny(), JaxVGGTConfig.tiny()
    params = random_jax_tree(jmodel.vggt_init, jcfg, seed=6)
    params["track_head"] = reduced_track_tree(jcfg, seed=7)
    model = VGGT(cfg)
    model.track_head = reduced_track_head(cfg)
    return cfg, params, load_jax_params(model, params).eval()


def _assert_tracks_match(got, want, S, N, Q=2):
    assert got["query_frames"] == want["query_frames"] and len(got["query_frames"]) == Q
    assert got["tracks"].shape == (Q, S, N, 2) and got["vis"].shape == (Q, S, N)
    np.testing.assert_allclose(got["tracks"], want["tracks"], atol=COORD_ATOL)
    for k in ("vis", "conf"):
        np.testing.assert_allclose(got[k], want[k], atol=PROB_ATOL, err_msg=k)
    assert np.isfinite(got["tracks"]).all()
    assert ((got["vis"] >= 0) & (got["vis"] <= 1)).all()


@pytest.mark.parametrize("with_conf", [False, True])
def test_predict_tracks_on_the_vggt_head_matches_jax(tiny_track, f32_forwards, with_conf):
    """tests/test_vggt_sfm.py:115's smoke against JAX: the tiny VGGT on 3
    frames of 128^2 (the tracker route's size, so the two share the
    frame-signature forward's compile), 16 queries from 2 query frames (the
    top-conf pixels or a uniform grid), each query frame rolled first and
    the results rolled back; at its query frame each track stays at its
    query point."""
    cfg, params, model = tiny_track
    S, H = 3, 128
    images = np.random.default_rng(8).uniform(0, 1, (S, 3, H, H)).astype(np.float32)
    conf = (np.random.default_rng(9).uniform(0, 2, (S, H, H)).astype(np.float32)
            if with_conf else None)
    kw = dict(conf=conf, max_query_pts=16, query_frame_num=2,
              track_kwargs={"corr_levels": LEVELS, "corr_radius": RADIUS, "iters": 2})
    want = jsfm.predict_tracks(params, images, JaxVGGTConfig.tiny(), **kw)
    got = tsfm.predict_tracks(model, images, **kw)
    _assert_tracks_match(got, want, S, 16)
    for q, qf in enumerate(got["query_frames"]):
        if conf is None:
            idx = np.linspace(0, H * H - 1, 16).astype(int)
            np.testing.assert_array_equal(got["tracks"][q, qf, :, 0], (idx % H).astype(np.float32))


def test_predict_tracks_on_the_vggsfm_tracker_matches_jax(tiny_track, f32_forwards):
    """tests/test_vggt_sfm.py:151's case against JAX on the published tracker
    (its coarse stage: 2 iterations, no fine tracking, as there): 3 frames of
    128^2, 4 queries a frame from conf; the tracker's vis doubles as conf."""
    cfg, params, model = tiny_track
    tparams = random_jax_tree(jv.vggsfm_tracker_init, seed=10)
    _damp(tparams["coarse_predictor"])
    _damp(tparams["fine_predictor"])
    tracker = load_jax_params(tv.VGGSfMTracker(), tparams).eval()
    S, H, N = 3, 128, 4
    images = np.random.default_rng(11).uniform(0, 1, (S, 3, H, H)).astype(np.float32)
    conf = np.random.default_rng(12).uniform(0, 2, (S, H, H)).astype(np.float32)
    kw = dict(conf=conf, max_query_pts=N, query_frame_num=2,
              track_kwargs={"fine_tracking": False, "coarse_iters": 2})
    want = jsfm.predict_tracks(params, images, JaxVGGTConfig.tiny(), tracker_params=tparams,
                               **kw)
    got = tsfm.predict_tracks(model, images, tracker=tracker, **kw)
    _assert_tracks_match(got, want, S, N)
    np.testing.assert_array_equal(got["conf"], got["vis"])
    for q, qf in enumerate(got["query_frames"]):
        idx = np.argsort(-conf[qf].reshape(-1))[:N]
        np.testing.assert_array_equal(got["tracks"][q, qf],
                                      np.stack([idx % H, idx // H], 1).astype(np.float32))
