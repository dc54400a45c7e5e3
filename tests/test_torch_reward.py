"""The port's scorer against the JAX package's on the CPU: LPIPS, the metric
functions and classes, and the whole tiny VGGT scorer through
``process_frames_batch`` / ``process_frames`` with the same weights and
frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.metrics as jm
from videogpa_tpu.metrics import functional as jF
from videogpa_tpu.models.lpips import lpips_distance as j_lpips_distance
from videogpa_tpu.models.lpips import lpips_init as j_lpips_init
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import vggt_init as j_vggt_init
from videogpa_tpu.reward import VideoProcessor as JaxVideoProcessor
import videogpa_torch.metrics as tm
from videogpa_torch.convert import load_jax_params
from videogpa_torch.metrics import functional as tF
from videogpa_torch.models.da3 import DA3Config
from videogpa_torch.models.lpips import LPIPS, lpips_distance
from videogpa_torch.models.vggt import VGGT, VGGTConfig
from videogpa_torch.reward import VideoProcessor
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
S, SIZE = 3, 56  # frames per clip, the tiny config's image size


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    """VGGT and LPIPS trees shaped as JAX's initialisers give them, and the
    port's modules holding the same weights. The random camera head's fov
    outputs are shifted by +1 rad: its ReLU can emit fov 0 (infinite focal
    length, NaN pixels), where no reprojection happens at all."""
    vggt = random_jax_tree(j_vggt_init, JaxVGGTConfig.tiny())
    vggt["camera_head"]["pose_branch"]["fc2"]["bias"][7:9] += 1.0
    lp = random_jax_tree(j_lpips_init, seed=1)
    return (vggt, lp, load_jax_params(VGGT(VGGTConfig.tiny()), vggt).eval(),
            load_jax_params(LPIPS(), lp).eval())


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (S, SIZE, SIZE, 3), dtype=np.uint8)
    tex = rng.integers(0, 256, (SIZE // 4, SIZE // 4 + S, 3)).repeat(4, 0).repeat(4, 1)
    pan = np.stack([tex[:, 4 * t: 4 * t + SIZE] for t in range(S)]).astype(np.uint8)
    return [noise, pan]


def _jax_scorer(weights, zbuffer_impl):
    vggt, lp, _, _ = weights
    metrics = {"MSE": jm.MSEMetric(), "Consistency_Score": jm.ConsistencyScore(lp),
               "MVCS": jm.MVCSMetric(), "PSNR": jm.PSNRMetric(), "SSIM": jm.SSIMMetric(),
               "LPIPS": jm.LPIPSMetric(lp), "Epipolar": jm.EpipolarMetric()}
    return JaxVideoProcessor(metrics, params=vggt, config=JaxVGGTConfig.tiny(),
                             compute_dtype=jnp.float32, attn_impl="xla",
                             zbuffer_impl=zbuffer_impl)


def _port_scorer(weights, zbuffer_impl):
    _, _, model, lp = weights
    return VideoProcessor(tm.build_metrics(lp), params=model, compute_dtype=torch.float32,
                          zbuffer_impl=zbuffer_impl, device="cpu")


def _assert_scores_close(got, want):
    """Both packages in f32: the backbone outputs agree to ~1e-6, so a score
    moves only where a pixel's z-buffer winner flips between near-equal
    depths. One flipped pixel moves a clip's MSE by at most 1 / (S*H*W);
    MSE and the consistency score are held within 2 such pixels, PSNR within
    the log of that, SSIM and LPIPS (windows over the same frames) within
    1e-3 and 1e-4, motion and MVCS (no z-buffer) within 1e-5 + 1e-4 rel."""
    flip = 2.0 / (S * SIZE * SIZE)
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name in ("MSE", "Consistency_Score"):
            atol = flip + 1e-6
        elif name == "PSNR":
            atol = 10 * np.log10(1 + flip / max(want["MSE"], 1e-12)) + 1e-4
        else:
            atol = {"SSIM": 1e-3, "LPIPS": 1e-4}.get(name, 1e-5 + 1e-4 * abs(w))
        assert np.isfinite(got[name]) and abs(got[name] - w) <= atol, (name, got[name], w, atol)


@pytest.mark.parametrize("zbuffer_impl", ["packed", "scatter"])
def test_scorer_batch_matches_jax(weights, clips, zbuffer_impl):
    want = _jax_scorer(weights, zbuffer_impl).process_frames_batch(clips, [0])
    got = _port_scorer(weights, zbuffer_impl).process_frames_batch(clips, [0])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {0, "_extrinsic"}
        _assert_scores_close(g[0], w[0])
        np.testing.assert_allclose(np.asarray(g["_extrinsic"]), np.asarray(w["_extrinsic"]),
                                   atol=1e-5)


def test_process_frames_matches_jax_and_async(weights, clips):
    want = _jax_scorer(weights, "packed").process_frames(clips[1], [0, 50.0])
    vp = _port_scorer(weights, "packed")
    got = vp.process_frames(clips[1], [0, 50.0])
    assert set(got) == set(want) == {0, 50.0, "_extrinsic"}
    for th in (0, 50.0):
        _assert_scores_close(got[th], want[th])
    assert np.asarray(got["_extrinsic"]).shape == (S, 3, 4)
    pulled = vp.process_frames_async(clips[1], [0, 50.0])()
    assert pulled == got


def test_fused_schema_keys(weights, clips):
    vp = _port_scorer(weights, "packed")
    vp.metrics = {"MSE": tm.MSEMetric(), "Consistency_Score": tm.ConsistencyScore(None)}
    r = vp.process_frames_batch(clips[:1], [0])[0]
    assert list(r[0]) == ["MSE", "Consistency_Score", "motion_norm"]
    assert r[0]["Consistency_Score"] == r[0]["MSE"]  # no LPIPS network: MSE only
    assert np.asarray(r["_extrinsic"]).shape == (S, 3, 4)


def test_unported_paths_raise(weights, clips):
    # DA3 is ported: the backbone resolves and defaults to DA3-Large's config
    # (its scoring is held against JAX in test_torch_da3_scorer.py)
    assert VideoProcessor({}, backbone="da3", device="cpu").config == DA3Config()
    vp = VideoProcessor({}, model_name="depth-anything/DA3-Large", device="cpu")
    assert vp.backbone == "da3" and vp.config == DA3Config.large()
    # the LightGlue matcher is ported (held against JAX in
    # test_torch_epipolar_lightglue.py): it builds on the metric's device,
    # the card unless the caller asks for the CPU, and never falls back
    from videogpa_torch.metrics.epipolar import LightGlueMatcher

    matcher = tm.EpipolarMetric(descriptor_type="lightglue", device="cpu").matcher
    assert isinstance(matcher, LightGlueMatcher) and matcher.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.EpipolarMetric(descriptor_type="lightglue")
    # frames that are not square (host preprocessing) and the per-metric path
    # are ported: they score (held against JAX in test_torch_score_cli.py)
    vp = _port_scorer(weights, "packed")
    with pytest.warns(UserWarning, match="per-metric"):
        r = vp.process_frames_batch([clips[0][:, :, :40]], [0])  # not square
    assert np.isfinite(r[0][0]["Consistency_Score"])


def test_lpips_matches_jax(weights):
    _, lp, _, model = weights
    rng = np.random.default_rng(2)
    x, y = (rng.uniform(-1, 1, (2, 3, 48, 48)).astype(np.float32) for _ in range(2))
    want = j_lpips_distance(lp, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = lpips_distance(model, _t(x), _t(y))
    # f32, 13 convolutions deep: summation-order noise only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("size", [40, 520])  # 520: SSIM's 2x average-pool downsampling
def test_metric_functions_match_jax(size):
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    rep = np.clip(gt * 2 - 1 + rng.normal(0, 0.3, gt.shape), -1, 1).astype(np.float32)
    for fn in ("mse", "psnr", "ssim"):
        want = getattr(jF, fn)(jnp.asarray(gt), jnp.asarray(rep))
        got = getattr(tF, fn)(_t(gt), _t(rep))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, err_msg=fn)
    small = rep[:, :, : size // 2, : size // 3]  # _match_size resizes rep to gt
    np.testing.assert_allclose(tF.mse(_t(gt), _t(small)).item(),
                               float(jF.mse(jnp.asarray(gt), jnp.asarray(small))), rtol=1e-5)
    for fn in ("to_unit_range", "to_sym_range"):
        for x in (gt * 255, rep, gt):
            np.testing.assert_allclose(getattr(tF, fn)(_t(x)).numpy(),
                                       np.asarray(getattr(jF, fn)(jnp.asarray(x))), rtol=1e-6)


def test_motion_and_mvcs_match_jax():
    rng = np.random.default_rng(4)
    T, H, W = 4, 20, 24
    ang = np.linspace(0, 0.3, T)
    E = np.zeros((T, 4, 4), np.float32)
    for t, a in enumerate(ang):
        E[t, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[t, :3, 3] = [0.1 * t, 0.02 * t, 0.0]
        E[t, 3, 3] = 1
    K = np.tile(np.asarray([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32), (T, 1, 1))
    depth = (2 + rng.uniform(0, 0.5, (T, H, W))).astype(np.float32)
    np.testing.assert_allclose(tF.motion_score(_t(E[:, :3])).item(),
                               float(jF.motion_score(jnp.asarray(E[:, :3]))), rtol=1e-5)
    want = float(jF.mvcs(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(E)))
    assert 0 < want < 1
    np.testing.assert_allclose(tF.mvcs(_t(depth), _t(K), _t(E)).item(), want, rtol=1e-4)


def test_metric_classes_match_jax(weights):
    _, lp, _, model = weights
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)  # (T, H, W, C) uint8
    rep = rng.uniform(-1, 1, (3, 3, 32, 32)).astype(np.float32)  # (T, C, H, W) in [-1, 1]
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1))
    extr[:, 0, 3] = [0.0, 0.1, 0.3]
    pairs = [(jm.MSEMetric(), tm.MSEMetric()), (jm.PSNRMetric(), tm.PSNRMetric()),
             (jm.SSIMMetric(), tm.SSIMMetric()), (jm.LPIPSMetric(lp), tm.LPIPSMetric(model))]
    for j, t in pairs:
        np.testing.assert_allclose(t.compute(gt=gt, rep=rep), j.compute(gt=gt, rep=rep),
                                   rtol=1e-4, atol=1e-6, err_msg=t.name)
    got = tm.ConsistencyScore(model).compute(gt=gt, rep=rep, extrinsics=extr)
    want = jm.ConsistencyScore(lp).compute(gt=gt, rep=rep, extrinsics=extr)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert tm.LPIPSMetric(None).compute(gt=gt, rep=rep) == 0.0
    assert set(tm.build_metrics(model)) == set(jm.build_metrics(lp))
