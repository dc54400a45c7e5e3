"""The port's Epipolar metric against the JAX package's on the CPU: the
normalised 8-point fundamental matrix (up to sign), the Sampson distance,
the whole SIFT metric on a textured panning clip, and ``build_metrics``'
keys."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.metrics as jm
from videogpa_tpu.metrics import functional as jF
from videogpa_tpu.metrics.epipolar import epipolar_error as j_epipolar_error
from videogpa_tpu.metrics.epipolar import frames_to_uint8 as j_frames_to_uint8
import videogpa_torch.metrics as tm
from videogpa_torch.metrics import functional as tF
from videogpa_torch.metrics.epipolar import epipolar_error, frames_to_uint8


def _two_views(seed, t=(0.3, 0.1, 0.0), n=60):
    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    K = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]])
    p1 = pts3d @ K.T
    p2 = (pts3d + np.asarray(t)) @ K.T
    return ((p1[:, :2] / p1[:, 2:]).astype(np.float32),
            (p2[:, :2] / p2[:, 2:]).astype(np.float32), rng)


@pytest.mark.parametrize("noise_px", [0.0, 0.5])
def test_fundamental_matches_jax_up_to_sign(noise_px):
    p1, p2, rng = _two_views(1)
    p2 = (p2 + rng.normal(0, noise_px, p2.shape)).astype(np.float32)
    want = np.asarray(jF.find_fundamental(jnp.asarray(p1), jnp.asarray(p2)))
    got = tF.find_fundamental(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    sign = np.sign(np.sum(got * want))
    # unit-norm F in f32 through two SVDs: entries agree to a few 1e-5
    np.testing.assert_allclose(sign * got, want, atol=2e-4)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5
    assert abs(np.linalg.det(got.astype(np.float64))) < 1e-6  # rank 2


@pytest.mark.parametrize("squared", [True, False])
def test_sampson_distance_matches_jax(squared):
    p1, p2, rng = _two_views(2)
    bad = (p2 + rng.normal(0, 20, p2.shape)).astype(np.float32)
    Fm = np.array(jF.find_fundamental(jnp.asarray(p1), jnp.asarray(p2)))
    for q in (p2, bad):
        want = np.asarray(jF.sampson_distance(jnp.asarray(p1), jnp.asarray(q),
                                              jnp.asarray(Fm), squared=squared))
        got = tF.sampson_distance(torch.from_numpy(p1), torch.from_numpy(q),
                                  torch.from_numpy(Fm), squared=squared).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_fundamental_satisfies_epipolar_constraint_and_flags_outliers():
    p1, p2, rng = _two_views(1)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    Fm = tF.find_fundamental(t1, t2)
    d_good = tF.sampson_distance(t1, t2, Fm, squared=False).mean()
    assert d_good < 0.1  # near-perfect correspondences -> tiny residual
    bad = torch.from_numpy((p2 + rng.normal(0, 20, p2.shape)).astype(np.float32))
    assert tF.sampson_distance(t1, bad, Fm, squared=False).mean() > 10 * d_good


def _panning_clip(frames=4, size=96, step=3, seed=0):
    """A smooth random texture panned by ``step`` pixels a frame: SIFT finds
    enough matches between neighbours."""
    import cv2

    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (size // 4, (size + step * frames) // 4 + 1, 3), dtype=np.uint8)
    tex = cv2.resize(tex, (tex.shape[1] * 4, tex.shape[0] * 4), interpolation=cv2.INTER_CUBIC)
    return np.stack([tex[:size, step * t: step * t + size] for t in range(frames)])


def test_epipolar_metric_matches_jax():
    clip = _panning_clip()
    want = jm.EpipolarMetric().compute(gt=clip, rep=None)
    got = tm.EpipolarMetric().compute(gt=clip, rep=None)
    assert want >= 0.0  # the clip yields matches: the geometry path ran
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # [-1, 1] float frames in (T, C, H, W) go through the same coercion
    sym = clip.transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(frames_to_uint8(sym), j_frames_to_uint8(sym))
    # no pair with enough matches: -1.0 in both
    flat = np.full((3, 32, 32, 3), 128, np.uint8)
    assert epipolar_error(flat) == j_epipolar_error(flat) == -1.0


def test_build_metrics_keys_equal_jax():
    assert list(tm.build_metrics(device="cpu")) == list(jm.build_metrics())
    with pytest.raises(ValueError):
        tm.EpipolarMetric(descriptor_type="orb")
