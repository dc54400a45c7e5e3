"""The port's reconstruction evaluation (``videogpa_torch/models/da3/recon.py``)
against the JAX package's on the CPU: ``_tsdf_integrate`` voxel for voxel,
``fuse_depths_tsdf``'s surface points, ``voxel_down_sample`` and
``evaluate_3d_reconstruction`` (the same numpy). Mirrors
``tests/test_da3.py``'s ``TestReconstruction`` fusion cases.

Tolerance of the fusion: JAX rotates the centres with one matrix product
and lets XLA fuse the arithmetic, the port spells each sum out; the two
round differently in the last bit, so a voxel whose projection lies within
an ulp of a pixel edge or of the truncation band can fall on the other side.
Such voxels are a few in a million here. Every other voxel's weight is
equal and its TSDF within 1e-4: the SDF is (d - z) / trunc, so a difference
of a few ulps in z or in the sampled depth d (2.4e-7 at depth 2-4) comes out
multiplied by 1 / trunc (5 here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import recon as jrecon
from videogpa_torch.models.da3 import recon as trecon

torch.set_num_threads(2)
FLIP_SHARE = 1e-4  # voxels whose weight may differ (an edge crossed by an ulp)
TSDF_ATOL = 1e-4


def _plane_scene(S=4, H=48, W=64, z0=2.0):
    """A fronto-parallel plane at depth z0 seen by translated cameras."""
    fx = fy = 60.0
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    intr = np.tile(K, (S, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    for i in range(S):
        extr[i, 0, 3] = 0.05 * i
    return np.full((S, H, W), z0, np.float32), intr, extr


def _rough_scene(S=3, H=40, W=56, seed=0):
    """A tilted, bumpy surface seen by rotated and translated cameras, one
    depth of 0 (invalid) and one beyond max_depth."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depths = np.stack([2.0 + 0.01 * xx + 0.3 * np.sin(yy / 5 + s) for s in range(S)])
    depths[0, 3, 4], depths[1, 10, 10] = 0.0, 50.0
    K = np.array([[50.0, 0, W / 2], [0, 52.0, H / 2], [0, 0, 1]], np.float32)
    E = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    for s in range(S):
        a = 0.1 * (s - 1)
        E[s, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[s, :3, 3] = rng.normal(0, 0.05, 3)
    return depths.astype(np.float32), np.tile(K, (S, 1, 1)), E


def _centers(lo, hi, n):
    ax = [np.linspace(lo[i], hi[i], n[i], dtype=np.float32) for i in range(3)]
    return np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("scene", ["plane", "rough"])
def test_tsdf_integrate_matches_jax(scene):
    depths, intr, extr = _plane_scene() if scene == "plane" else _rough_scene()
    centers = _centers([-1.2, -1.0, 0.5], [1.2, 1.0, 3.5], (48, 40, 50))
    want_t, want_w = (np.asarray(a) for a in jrecon._tsdf_integrate_j(
        jnp.asarray(centers), jnp.asarray(depths), jnp.asarray(intr), jnp.asarray(extr),
        0.2, 10.0))
    got_t, got_w = (a.numpy() for a in trecon._tsdf_integrate(
        torch.from_numpy(centers), torch.from_numpy(depths), torch.from_numpy(intr),
        torch.from_numpy(extr), 0.2, 10.0))
    assert (want_w > 0).mean() > 0.2  # the scene is seen by a good share of the grid
    same = got_w == want_w
    assert (~same).mean() <= FLIP_SHARE
    np.testing.assert_allclose(got_t[same], want_t[same], atol=TSDF_ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [1000, 4097])
def test_tsdf_chunks_change_no_voxel(monkeypatch, chunk):
    depths, intr, extr = _rough_scene(seed=1)
    args = [torch.from_numpy(a) for a in (_centers([-1, -1, 0.5], [1, 1, 3], (30, 30, 30)),
                                          depths, intr, extr)]
    whole = trecon._tsdf_integrate(*args, 0.16, 10.0)
    monkeypatch.setattr(trecon, "TSDF_CHUNK", chunk)
    parts = trecon._tsdf_integrate(*args, 0.16, 10.0)
    assert all(torch.equal(a, b) for a, b in zip(parts, whole))


def _same_cloud(got, want):
    """Equal point counts within the flip share, each point of the smaller
    set within 1e-5 of one of the other (the centres are the same f32
    numbers unless a percentile's last bit moved the grid)."""
    assert got.dtype == want.dtype == np.float32
    assert abs(len(got) - len(want)) <= max(2, FLIP_SHARE * len(want))
    small, big = (got, want) if len(got) <= len(want) else (want, got)
    d = trecon.nn_correspondance(big.astype(np.float64), small.astype(np.float64))
    assert d.max() <= 1e-5


@pytest.mark.parametrize("scene", ["plane", "rough"])
def test_fuse_depths_tsdf_matches_jax(scene):
    depths, intr, extr = _plane_scene() if scene == "plane" else _rough_scene()
    kw = dict(voxel_size=0.05)
    want = jrecon.fuse_depths_tsdf(depths, intr, extr, **kw)
    got = trecon.fuse_depths_tsdf(depths, intr, extr, device="cpu", **kw)
    assert len(want) > 100
    _same_cloud(got, want)
    # (S, 3, 4) cameras, a frame with a non-finite camera dropped, and a
    # grid capped by max_voxels (voxel_size grows)
    e34 = extr[:, :3].copy()
    bad = intr.copy()
    bad[1, 0, 0] = np.nan
    kw = dict(voxel_size=0.02, max_voxels=20_000)
    _same_cloud(trecon.fuse_depths_tsdf(depths, bad, e34, device="cpu", **kw),
                jrecon.fuse_depths_tsdf(depths, bad, e34, **kw))


def test_fuse_depths_tsdf_degenerate_inputs_match_jax():
    depths, intr, extr = _plane_scene(S=2)
    far = np.full_like(depths, 20.0)  # every depth past max_depth: the band widens
    _same_cloud(trecon.fuse_depths_tsdf(far, intr, extr, voxel_size=0.2, device="cpu"),
                jrecon.fuse_depths_tsdf(far, intr, extr, voxel_size=0.2))
    zero = np.zeros_like(depths)
    assert trecon.fuse_depths_tsdf(zero, intr, extr, device="cpu").shape == (0, 3)
    assert jrecon.fuse_depths_tsdf(zero, intr, extr).shape == (0, 3)
    nan = np.full_like(depths, np.nan)
    assert trecon.fuse_depths_tsdf(nan, intr, extr, device="cpu").shape == (0, 3)


def test_fuse_plane_recovers_surface():
    """``tests/test_da3.py::TestReconstruction::test_fuse_plane_recovers_surface``
    on the port."""
    depths, intr, extr = _plane_scene()
    pts = trecon.fuse_depths_tsdf(depths, intr, extr, voxel_size=0.05, device="cpu")
    assert len(pts) > 100
    assert np.abs(pts[:, 2] - 2.0).max() < 0.15
    gx, gy = np.meshgrid(np.linspace(pts[:, 0].min(), pts[:, 0].max(), 40),
                         np.linspace(pts[:, 1].min(), pts[:, 1].max(), 40))
    gt = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 2.0)], -1)
    m = trecon.evaluate_3d_reconstruction(pts, gt, threshold=0.1)
    assert m["fscore"] > 0.9
    assert m["acc"] < 0.1 and m["comp"] < 0.1


def test_voxel_down_sample():
    pts = np.array([[0.01, 0, 0], [0.02, 0, 0], [1.0, 0, 0]], np.float64)
    out = trecon.voxel_down_sample(pts, 0.1)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(sorted(out[:, 0]), [0.015, 1.0])
    np.testing.assert_array_equal(out, jrecon.voxel_down_sample(pts, 0.1))


@pytest.mark.parametrize("case", ["plain", "down_sampled", "empty"])
def test_evaluate_3d_reconstruction_equals_jax(case):
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 1, (400, 3)).astype(np.float32)
    gt = (pred[:300] + rng.normal(0, 0.03, (300, 3))).astype(np.float32)
    kw = {"threshold": 0.05}
    if case == "down_sampled":
        kw["down_sample"] = 0.1
    if case == "empty":
        pred = pred[:0]
    got = trecon.evaluate_3d_reconstruction(pred, gt, **kw)
    want = jrecon.evaluate_3d_reconstruction(pred, gt, **kw)
    assert got == want
    if case == "plain":
        assert 0 < got["precision"] < got["recall"] <= 1
