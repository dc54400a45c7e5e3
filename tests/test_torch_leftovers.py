"""Top-level names of the JAX package that DA3 brought into the port, each
against its JAX counterpart on the CPU: ``affine_inverse``, ``mat_to_quat``
and its helpers, ``extri_intri_to_pose_encoding``, the rotate-half RoPE
helpers, the non-antialiased bicubic resize with a scale override, the DPT
fusion's two residual forms, the host-side trajectory alignment, and the
timing / memory / compile-cache utilities."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.geometry.alignment as jalign
import videogpa_tpu.geometry.pose_enc as jpose
import videogpa_tpu.geometry.rotation as jrot
import videogpa_tpu.geometry.transforms as jtf
import videogpa_tpu.models.vggt.heads as jheads
import videogpa_tpu.ops.resize as jresize
import videogpa_tpu.ops.rope as jrope
import videogpa_tpu.utils.memory as jmemory
import videogpa_torch.geometry.alignment as talign
import videogpa_torch.geometry.pose_enc as tpose
import videogpa_torch.geometry.rotation as trot
import videogpa_torch.geometry.transforms as ttf
import videogpa_torch.models.vggt.heads as theads
import videogpa_torch.ops.resize as tresize
import videogpa_torch.ops.rope as trope
from videogpa_tpu.models.vggt import vggt_init as j_vggt_init
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.vggt import VGGT, VGGTConfig
from videogpa_torch.utils import StageTimer, compile_cache, memory
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 elementwise maths and 3 x 3 products: a few ulps
ATOL = RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    q[0] = [0, 0, 0, -1]  # the identity with a negative real part
    q[1] = [1, 0, 0, 0]  # a half turn: the r candidate is ill-conditioned
    return np.asarray(jrot.quat_to_mat(jnp.asarray(q, jnp.float32)))


def test_affine_inverse_matches_jax():
    rng = np.random.default_rng(0)
    A = np.concatenate([_rotations(6, 1), rng.standard_normal((6, 3, 1))], -1)
    A = A.astype(np.float32)
    A44 = np.concatenate([A, np.tile([[[0, 0, 0, 1]]], (6, 1, 1)).astype(np.float32)], 1)
    for x in (A, A44):
        want = np.asarray(jtf.affine_inverse(jnp.asarray(x)))
        got = ttf.affine_inverse(_t(x)).numpy()
        assert got.shape == x.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(A44 @ ttf.affine_inverse(_t(A44)).numpy(),
                               np.tile(np.eye(4), (6, 1, 1)), atol=1e-5)


def test_mat_to_quat_and_helpers_match_jax():
    R = _rotations(32, 2)
    want = np.asarray(jrot.mat_to_quat(jnp.asarray(R)))
    got = trot.mat_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got[:, 3] >= 0).all()
    np.testing.assert_allclose(trot.quat_to_mat(_t(got)).numpy(), R, atol=1e-5)
    q = np.random.default_rng(3).standard_normal((8, 4)).astype(np.float32)
    np.testing.assert_array_equal(trot.standardize_quaternion(_t(q)).numpy(),
                                  np.asarray(jrot.standardize_quaternion(jnp.asarray(q))))
    x = np.array([-1.0, 0.0, 0.25, 4.0], np.float32)
    np.testing.assert_array_equal(trot._sqrt_positive_part(_t(x)).numpy(),
                                  np.asarray(jrot._sqrt_positive_part(jnp.asarray(x))))


def test_extri_intri_to_pose_encoding_matches_jax_and_round_trips():
    rng = np.random.default_rng(4)
    ext = np.concatenate([_rotations(5, 5), rng.standard_normal((5, 3, 1))], -1)
    ext = ext.astype(np.float32)
    K = np.tile(np.array([[300.0, 0, 259], [0, 280.0, 259], [0, 0, 1]], np.float32), (5, 1, 1))
    want = np.asarray(jpose.extri_intri_to_pose_encoding(jnp.asarray(ext), jnp.asarray(K),
                                                         (518, 518)))
    got = tpose.extri_intri_to_pose_encoding(_t(ext), _t(K), (518, 518))
    assert got.dtype == torch.float32 and got.shape == (5, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    back, K2 = tpose.pose_encoding_to_extri_intri(got, (518, 518))
    np.testing.assert_allclose(back.numpy(), ext, atol=1e-5)
    np.testing.assert_allclose(K2[:, :2, :2].numpy(), K[:, :2, :2], rtol=1e-5)


def test_rotate_half_rope_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    ang = rng.standard_normal((5, 1, 8)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    np.testing.assert_array_equal(trope.rotate_half(_t(x)).numpy(),
                                  np.asarray(jrope.rotate_half(jnp.asarray(x))))
    np.testing.assert_allclose(trope.apply_rope_1d(_t(x), _t(ang)).numpy(),
                               np.asarray(jrope.apply_rope_1d(jnp.asarray(x), jnp.asarray(ang))),
                               atol=ATOL, rtol=RTOL)
    got = trope.apply_rope_cos_sin(_t(x).to(torch.bfloat16), _t(cos), _t(sin))
    want = jrope.apply_rope_cos_sin(jnp.asarray(x, jnp.bfloat16), jnp.asarray(cos),
                                    jnp.asarray(sin))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2,
                               rtol=1e-2)  # one bf16 ulp
    np.testing.assert_allclose(trope.apply_rope_cos_sin(_t(x), _t(cos), _t(sin)).numpy(),
                               trope.apply_rope_1d(_t(x), _t(ang)).numpy(), atol=ATOL)


@pytest.mark.parametrize("case", ["offset_up", "offset_down", "no_offset", "antialias"])
def test_resize_bicubic_branches_match_jax(case):
    """The non-antialiased branch (a = -0.75, four clamped taps) with and
    without DA3's scale override, and the default antialiased branch VGGT's
    pos-embed keeps."""
    x = np.random.default_rng(7).standard_normal((2, 3, 6, 6)).astype(np.float32)
    if case == "offset_up":
        kw = {"antialias": False, "scale_override": (6 / 9.1, 6 / 4.1)}
        out = (9, 4)
    elif case == "offset_down":
        kw = {"antialias": False, "scale_override": (6 / 3.1, 6 / 5.1)}
        out = (3, 5)
    elif case == "no_offset":
        kw = {"antialias": False}
        out = (11, 7)
    else:
        kw = {"antialias": True}
        out = (4, 9)
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(x), out, **kw))
    got = tresize.resize_bicubic(_t(x), out, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if case == "antialias":  # the default keeps VGGT's call site as it was
        np.testing.assert_array_equal(tresize.resize_bicubic(_t(x), out).numpy(), got)


@pytest.mark.parametrize("inplace_relu", [True, False], ids=["vggt_relu_x", "da3_raw_x"])
def test_fusion_residual_forms_match_jax(inplace_relu):
    tree = random_jax_tree(j_vggt_init, JaxVGGTConfig.tiny())
    model = load_jax_params(VGGT(VGGTConfig.tiny()), tree).eval()
    rng = np.random.default_rng(8)
    f = VGGTConfig.tiny().dpt_features
    x, res = (rng.standard_normal((2, f, 6, 6)).astype(np.float32) for _ in range(2))
    p = tree["depth_head"]["refinenet1"]
    want = jheads._fusion(p, jnp.asarray(x), jnp.asarray(res), inplace_relu=inplace_relu)
    with torch.no_grad():
        got = theads._fusion(model.depth_head.refinenet1, _t(x), _t(res),
                             inplace_relu=inplace_relu)
        other = theads._fusion(model.depth_head.refinenet1, _t(x), _t(res),
                               inplace_relu=not inplace_relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not torch.allclose(got, other)
    if inplace_relu:  # VGGT's default form
        with torch.no_grad():
            default = theads._fusion(model.depth_head.refinenet1, _t(x), _t(res))
        torch.testing.assert_close(default, got, atol=0, rtol=0)


@pytest.mark.parametrize("ransac", [False, True])
def test_trajectory_alignment_matches_jax(ransac):
    rng = np.random.default_rng(9)
    n = 12
    ref = np.concatenate([_rotations(n, 10), rng.standard_normal((n, 3, 1))], -1)
    est = ref.copy()
    est[:, :, 3] = 0.5 * ref[:, :, 3] + 0.01 * rng.standard_normal((n, 3))
    est[3, :, 3] += 5.0  # an outlier
    want = jalign.align_poses_umeyama(ref, est, return_aligned=True, ransac=ransac,
                                      random_state=0)
    got = talign.align_poses_umeyama(ref, est, return_aligned=True, ransac=ransac,
                                     random_state=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    src = rng.standard_normal((10, 3))
    np.testing.assert_array_equal(talign.umeyama_sim3(src, 2 * src + 1)[0],
                                  jalign.umeyama_sim3(src, 2 * src + 1)[0])


def test_timing_memory_and_compile_cache_utilities():
    calls = []
    timer = StageTimer(sync=lambda: calls.append(1))
    for _ in range(3):
        with timer.stage("forward"):
            pass
    assert len(calls) == 6 and timer.counts == {"forward": 3}
    assert set(timer.summary()["forward"]) == {"total_s", "count", "mean_ms"}
    assert timer.report().startswith("forward: ")
    # no CUDA device here: no snapshot, and the go / no-go check proceeds
    assert memory.get_device_memory_info("cpu") is None
    assert memory.check_memory_availability(1e9)[0]
    assert memory.estimate_memory_requirement(10, 518) == jmemory.estimate_memory_requirement(
        10, 518)
    memory.cleanup_device_memory()
    assert compile_cache.enable_compile_cache() is None
    assert compile_cache.enable_compile_cache(force=True) is None
