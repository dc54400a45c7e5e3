"""The port's scorer geometry against the JAX package on the CPU: pose
decoding, unprojection, the confidence mask, the scatter-min (K5's plain
version) and all three z-buffer lowerings, the last two bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.geometry import pose_enc as jpose
from videogpa_tpu.geometry import projection as jproj
from videogpa_tpu.geometry import transforms as jtr
from videogpa_tpu.geometry import zbuffer_kernel as jzk
from videogpa_tpu.reward import pointcloud as jpc
from videogpa_torch.geometry import pose_enc as tpose
from videogpa_torch.geometry import projection as tproj
from videogpa_torch.geometry import transforms as ttr
from videogpa_torch.geometry import zbuffer_kernel as tzk
from videogpa_torch.reward import pointcloud as tpc

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_enc(rng, shape):
    enc = rng.standard_normal(shape + (9,)).astype(np.float32)
    enc[..., 7:] = rng.uniform(0.5, 1.5, shape + (2,))  # fov in radians
    return enc


def test_pose_encoding_to_extri_intri_matches_jax():
    enc = _pose_enc(np.random.default_rng(0), (2, 5))
    we, wi = jpose.pose_encoding_to_extri_intri(jnp.asarray(enc), (56, 84))
    ge, gi = tpose.pose_encoding_to_extri_intri(_t(enc), (56, 84))
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6, rtol=1e-6)


def test_depth_unprojection_matches_jax():
    rng = np.random.default_rng(1)
    extr, intr = (np.asarray(a) for a in jpose.pose_encoding_to_extri_intri(
        jnp.asarray(_pose_enc(rng, (2, 3))), (12, 16)))
    depth = rng.uniform(0.5, 3.0, (2, 3, 12, 16)).astype(np.float32)
    want = jtr.depth_to_world_points(jnp.asarray(depth), jnp.asarray(extr), jnp.asarray(intr))
    got = ttr.depth_to_world_points(_t(depth), _t(extr), _t(intr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    c2w = jtr.closed_form_inverse_se3(jnp.asarray(extr))
    np.testing.assert_allclose(ttr.closed_form_inverse_se3(_t(extr)).numpy(), np.asarray(c2w),
                               atol=1e-6, rtol=1e-6)
    want = jtr.unproject_depth(jnp.asarray(depth[..., None]), jnp.asarray(intr), c2w)
    got = ttr.unproject_depth(_t(depth[..., None]), _t(intr), _t(c2w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("conf_thres", [0.0, 50.0, 90.0])
def test_confidence_mask_and_pointcloud_match_jax(conf_thres):
    rng = np.random.default_rng(2)
    conf = rng.uniform(0, 3, (3, 8, 9)).astype(np.float32)
    conf[0, 0, :4] = [np.nan, np.inf, 0.0, 1e-6]  # invalid confidences
    conf[1, 2, :3] = 2.0  # ties at the threshold
    preds = {"world_points_from_depth": rng.standard_normal((3, 8, 9, 3)).astype(np.float32),
             "depth_conf": conf,
             "images": rng.uniform(0, 1, (3, 3, 8, 9)).astype(np.float32)}
    want = jpc.colored_pointcloud({k: jnp.asarray(v) for k, v in preds.items()}, "depth",
                                  conf_thres)
    got = tpc.colored_pointcloud({k: _t(v) for k, v in preds.items()}, "depth", conf_thres)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- K5's function: bit for bit with the JAX Pallas kernel (interpret mode)
#     and with the XLA scatter it replaces

@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jzk, "INTERPRET", True)


@pytest.mark.parametrize("case", ["tiers", "duplicates", "sentinels"])
def test_scatter_min_matches_jax_bit_for_bit(pallas_interpret, case):
    rng = np.random.default_rng(3)
    n_slots = 9000
    if case == "tiers":  # coherent, medium and scattered chunks, ragged tail
        lin = np.concatenate([1200 + rng.integers(0, 900, 1024), 2000 + rng.integers(0, 3900, 1024),
                              rng.integers(0, n_slots, 1524)])
    elif case == "duplicates":
        lin = rng.integers(0, 32, 2048)
    else:
        lin = rng.integers(0, n_slots, 2048)
    lin = lin.astype(np.int32)
    key = rng.integers(0, 1 << 32, lin.shape[0], dtype=np.uint64).astype(np.uint32)
    key[rng.integers(0, lin.shape[0], 300)] = 0xFFFFFFFF
    if case == "sentinels":
        key[:] = 0xFFFFFFFF
    pallas = np.asarray(jzk.scatter_min_u32(jnp.asarray(lin), jnp.asarray(key), n_slots))
    xla = np.asarray(jnp.full((n_slots,), 0xFFFFFFFF, jnp.uint32)
                     .at[jnp.asarray(lin)].min(jnp.asarray(key)))
    got = tzk.scatter_min_u32(_t(lin.astype(np.int64)), _t(key.astype(np.int64)), n_slots)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), pallas.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), xla.astype(np.int64))


def test_scatter_min_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tzk.scatter_min_u32(torch.zeros(3, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        tzk.scatter_min_u32(torch.zeros(3, dtype=torch.int64), torch.zeros(3, dtype=torch.int64), 0)


# --- the three z-buffer lowerings on identical geometry whose arithmetic is
#     exact (dyadic points, signed-permutation rotations, dyadic intrinsics),
#     so the two packages project every point to the same bits

def _exact_scene(rng, n=600, T=3, H=24, W=32):
    pts = rng.integers(-64, 64, (n, 3)).astype(np.float32) / 32.0
    pts[:, 2] = rng.integers(64, 192, n).astype(np.float32) / 32.0 + 2.0  # in front
    pts[n // 2:] = pts[: n - n // 2]  # duplicates: exact depth ties
    pts[n // 2:, 2] += np.where(rng.uniform(size=n - n // 2) < 0.5, 0.0, 1.0 / 32)
    colors = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    intr, extr = [], []
    # rotations with entries in {-1, 0, 1}: identity, a swap of x and y with
    # a sign flip, and a half-turn about y
    perms = [np.eye(3), np.eye(3)[[1, 0, 2]] * [[1.0], [-1.0], [1.0]], np.diag([-1.0, 1.0, -1.0])]
    for t in range(T):
        intr.append([[8.0 + 4 * t, 0, W / 2], [0, 8.0 + 4 * t, H / 2], [0, 0, 1]])
        R = perms[t % len(perms)]
        extr.append(np.concatenate([R, [[t / 4.0], [-t / 8.0], [0.0]]], axis=1))
    valid = rng.uniform(size=n) < 0.9
    return (pts, colors, np.asarray(intr, np.float32), np.asarray(extr, np.float32),
            valid, H, W)


def _canvases(proj, impl, pts, colors, intr, extr, H, W, valid, as_array):
    """(T, H, W, 3) rendered colors of one lowering, straight from the
    z-buffer (before batch_reproject's normalisation to [-1, 1])."""
    args = [as_array(x) for x in (pts, colors, intr, extr)]
    v = None if valid is None else as_array(valid)
    if impl == "packed":
        return proj.reproject_views_packed(*args, H, W, v)
    one = proj.project_points_zbuffer_sorted if impl == "sorted" else proj.project_points_zbuffer
    views = [one(args[0], args[1], K, E, H, W, v) for K, E in zip(args[2], args[3])]
    return jnp.stack(views) if as_array is jnp.asarray else torch.stack(views)


@pytest.mark.parametrize("impl", ["scatter", "sorted", "packed"])
def test_reprojection_lowerings_match_jax_bit_for_bit(impl):
    pts, colors, intr, extr, valid, H, W = _exact_scene(np.random.default_rng(4))
    want = np.asarray(_canvases(jproj, impl, pts, colors, intr, extr, H, W, valid, jnp.asarray))
    got = _canvases(tproj, impl, pts, colors, intr, extr, H, W, valid, _t)
    assert got.shape == (3, H, W, 3) and (want.sum(-1) > 0).mean() > 0.05  # real hits
    np.testing.assert_array_equal(got.numpy(), want)
    # the frames in [-1, 1]: XLA fuses (x / 255) * 2 - 1 and may round the
    # last bit differently, so one f32 ulp near 1 apart at most
    frames_j = np.asarray(jproj.batch_reproject(
        jnp.asarray(pts), jnp.asarray(colors), jnp.asarray(intr), jnp.asarray(extr), H, W,
        valid=jnp.asarray(valid), zbuffer_impl=impl, unit_colors=False))
    frames_t = tproj.batch_reproject(_t(pts), _t(colors), _t(intr), _t(extr), H, W,
                                     valid=_t(valid), zbuffer_impl=impl, unit_colors=False)
    np.testing.assert_allclose(frames_t.numpy(), frames_j, atol=2.4e-7, rtol=0)


def test_single_view_lowerings_match_jax_and_each_other():
    pts, colors, intr, extr, valid, H, W = _exact_scene(np.random.default_rng(5))
    args_j = (jnp.asarray(pts), jnp.asarray(colors), jnp.asarray(intr[1]), jnp.asarray(extr[1]),
              H, W, jnp.asarray(valid))
    args_t = (_t(pts), _t(colors), _t(intr[1]), _t(extr[1]), H, W, _t(valid))
    exact = tproj.project_points_zbuffer(*args_t)
    np.testing.assert_array_equal(exact.numpy(),
                                  np.asarray(jproj.project_points_zbuffer(*args_j)))
    np.testing.assert_array_equal(tproj.project_points_zbuffer_sorted(*args_t).numpy(),
                                  exact.numpy())


def test_degenerate_camera_lands_where_jax_lands():
    """fov 0 gives an infinite focal length: NaN pixel coordinates, which
    XLA converts to 0 (saturating, NaN -> 0) and the port converts alike."""
    pts, colors, intr, extr, valid, H, W = _exact_scene(np.random.default_rng(6), T=1)
    intr[0, 0, 0] = np.inf
    pts[:5, 0] = 0.0  # x = 0: inf * 0 = NaN
    for impl in ("packed", "scatter"):
        want = np.asarray(_canvases(jproj, impl, pts, colors, intr, extr, H, W, None,
                                    jnp.asarray))
        got = _canvases(tproj, impl, pts, colors, intr, extr, H, W, None, _t)
        np.testing.assert_array_equal(got.numpy(), want)


def test_packed_pid_bits_widen_past_2_22_points():
    """n > 2**22 points: the id field widens to 23 bits and the depth field
    narrows to 9 (``projection.py:223``), identically in both packages."""
    n = (1 << 22) + 5
    rng = np.random.default_rng(7)
    pts = np.zeros((n, 3), np.float32)
    pts[:, 2] = 2.0 + rng.integers(0, 64, n).astype(np.float32) / 16
    pts[:, 0] = rng.integers(-8, 8, n).astype(np.float32) / 4
    colors = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    intr = np.asarray([[[4.0, 0, 4], [0, 4.0, 4], [0, 0, 1]]], np.float32)
    extr = np.asarray([np.concatenate([np.eye(3), np.zeros((3, 1))], 1)], np.float32)
    _, key, pid_bits = tproj.packed_keys(_t(pts), _t(intr), _t(extr), 8, 8)
    assert pid_bits == 23 and int(key[key != tzk.SENTINEL].max()) < (1 << 32) - (1 << 23)
    want = np.asarray(jproj.reproject_views_packed(jnp.asarray(pts), jnp.asarray(colors),
                                                   jnp.asarray(intr), jnp.asarray(extr), 8, 8))
    got = tproj.reproject_views_packed(_t(pts), _t(colors), _t(intr), _t(extr), 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_cutoff_at_2_24_points(monkeypatch):
    big = torch.zeros((1 << 24, 3))
    K = torch.eye(3)[None]
    E = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)[None]
    with pytest.raises(ValueError, match="packed z-buffer supports"):
        tproj.reproject_views_packed(big, big, K, E, 4, 4)
    del big
    # batch_reproject falls back to the exact scatter at the same cutoff
    pts, colors, intr, extr, valid, H, W = _exact_scene(np.random.default_rng(8))
    monkeypatch.setattr(tproj, "_PACKED_MAX_POINTS", len(pts))
    with pytest.warns(UserWarning, match="falling back to exact scatter"):
        got = tproj.batch_reproject(_t(pts), _t(colors), _t(intr), _t(extr), H, W,
                                    zbuffer_impl="packed", unit_colors=False)
    exact = tproj.batch_reproject(_t(pts), _t(colors), _t(intr), _t(extr), H, W,
                                  zbuffer_impl="scatter", unit_colors=False)
    torch.testing.assert_close(got, exact, atol=0, rtol=0)
