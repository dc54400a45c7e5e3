"""The port's scorer on the DA3 backbone (``VideoProcessor(backbone="da3")``)
against the JAX package's on the CPU in f32, with the tiny DA3 holding the
same weights in both (``random_jax_tree`` + the bridge) and the same clips:
``process_frames_batch`` (fused, raw uint8 upload normalised on the device,
and float frames, which the JAX package normalises on the host and the port
uploads in [0, 1] and normalises on the device), ``process_frames`` and its
async form, the per-metric path against the fused one, ``score_groups`` from
mp4s (batched and async), and ``quantize_da3_int8`` against JAX's quantised
tree.

Tolerances, as ``tests/test_torch_reward.py`` argues them: the backbones
agree to ~1e-7 in f32, so a score moves only where a z-buffer winner flips
between near-equal depths, by 1 / (S * H * W) a pixel in MSE and the
consistency score; they are held within 2 such pixels, PSNR within the log
of that, SSIM and LPIPS within 1e-3 and 1e-4, motion and MVCS (no z-buffer)
within 1e-5 + 1e-4 relative."""

import functools
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.cli.score as jscore
import videogpa_tpu.data.video_io as jio
import videogpa_tpu.metrics as jm
import videogpa_tpu.ops.quant as jquant
from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import da3_init as j_da3_init
from videogpa_tpu.models.lpips import lpips_init as j_lpips_init
from videogpa_tpu.reward import VideoProcessor as JaxVideoProcessor
import videogpa_torch.cli.score as tscore
import videogpa_torch.data.video_io as tio
import videogpa_torch.metrics as tm
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.da3 import DA3, DA3Config
from videogpa_torch.models.lpips import LPIPS
from videogpa_torch.ops import quant as tquant
from videogpa_torch.reward import VideoProcessor
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
S, SIZE = 4, 56  # frames a clip (S >= 3: reference-view selection), the tiny size
FLIP = 2.0 / (S * SIZE * SIZE)


@pytest.fixture(scope="module")
def weights():
    """The tiny DA3 and LPIPS trees and the port's modules holding them; the
    camera decoder's fov bias is shifted by +1 rad (a random decoder can emit
    fov 0: infinite focal length, no reprojection at all)."""
    da3 = random_jax_tree(j_da3_init, JaxDA3Config.tiny())
    da3["cam_dec"]["fc_fov"]["bias"] += 1.0
    lp = random_jax_tree(j_lpips_init, seed=1)
    return (da3, lp, load_jax_params(DA3(DA3Config.tiny()), da3).eval(),
            load_jax_params(LPIPS(), lp).eval())


@pytest.fixture(scope="module")
def clips():
    """A smooth texture panning (a camera move) and one of noise."""
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.uniform(0, 255, (SIZE, SIZE + 3 * S, 3)).astype(np.uint8),
                           (0, 0), 2)
    pan = np.stack([tex[:, 3 * t: 3 * t + SIZE] for t in range(S)])
    noise = rng.integers(0, 256, (S, SIZE, SIZE, 3), dtype=np.uint8)
    return [pan, noise]


def _metrics_j(lp):
    return {"MSE": jm.MSEMetric(), "Consistency_Score": jm.ConsistencyScore(lp),
            "MVCS": jm.MVCSMetric(), "PSNR": jm.PSNRMetric(), "SSIM": jm.SSIMMetric(),
            "LPIPS": jm.LPIPSMetric(lp), "Epipolar": jm.EpipolarMetric()}


def _jax_vp(weights, metrics=None):
    da3, lp, _, _ = weights
    return JaxVideoProcessor(metrics or _metrics_j(lp), params=da3,
                             config=JaxDA3Config.tiny(), backbone="da3",
                             compute_dtype=jnp.float32, attn_impl="xla")


def _port_vp(weights, metrics=None):
    _, _, model, lp = weights
    return VideoProcessor(metrics or tm.build_metrics(lp), params=model, backbone="da3",
                          compute_dtype=torch.float32, device="cpu")


def _assert_scores_close(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name in ("MSE", "Consistency_Score"):
            atol = FLIP + 1e-6
        elif name == "PSNR":
            atol = 10 * np.log10(1 + FLIP / max(want["MSE"], 1e-12)) + 1e-4
        else:
            atol = {"SSIM": 1e-3, "LPIPS": 1e-4}.get(name, 1e-5 + 1e-4 * abs(w))
        assert np.isfinite(got[name]) and abs(got[name] - w) <= atol, (name, got[name], w, atol)


def _assert_results_close(got, want, thresholds=(0,)):
    assert set(got) == set(want) == {*thresholds, "_extrinsic"}
    for th in thresholds:
        _assert_scores_close(got[th], want[th])
    np.testing.assert_allclose(np.asarray(got["_extrinsic"]), np.asarray(want["_extrinsic"]),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_da3_scorer_batch_matches_jax(weights, clips, dtype):
    """uint8 frames go up raw (normalised on the device); float frames are
    ImageNet-normalised on the host in JAX and on the device in the port;
    both score fused in both packages."""
    frames = clips if dtype == "uint8" else [c.astype(np.float32) for c in clips]
    want = _jax_vp(weights).process_frames_batch(frames, [0])
    got = _port_vp(weights).process_frames_batch(frames, [0])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_results_close(g, w)
        assert np.asarray(g["_extrinsic"]).shape == (S, 3, 4)


def test_da3_process_frames_single_and_async_match_jax(weights, clips):
    want = _jax_vp(weights).process_frames(clips[0], [0, 50.0])
    vp = _port_vp(weights)
    got = vp.process_frames(clips[0], [0, 50.0])
    _assert_results_close(got, want, (0, 50.0))
    assert vp.process_frames_async(clips[0], [0, 50.0])() == got


def test_da3_per_metric_path_matches_fused(weights, clips, monkeypatch):
    """``VIDEOGPA_NO_FUSED_METRICS=1``: each metric on its own from the
    reprojections (gt the host's frames) gives the fused path's numbers."""
    fused = _port_vp(weights).process_frames(clips[0], [0])
    monkeypatch.setenv("VIDEOGPA_NO_FUSED_METRICS", "1")
    vp = _port_vp(weights)
    ref = vp.process_frames(clips[0], [0])
    for key in ("MSE", "Consistency_Score", "motion_norm", "MVCS", "PSNR", "SSIM", "LPIPS",
                "Epipolar"):
        np.testing.assert_allclose(fused[0][key], ref[0][key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    with pytest.raises(RuntimeError, match="fused"):
        vp.process_frames_async(clips[0], [0])
    with pytest.warns(UserWarning, match="per-metric"):
        batch = vp.process_frames_batch(clips, [0])
    np.testing.assert_allclose(batch[0][0]["Consistency_Score"],
                               ref[0]["Consistency_Score"], rtol=1e-5, atol=1e-6)


def _write_mp4(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             frames.shape[2:0:-1])
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.mark.parametrize("batch_size", [1, 2], ids=["async", "batched"])
def test_da3_score_groups_matches_jax(weights, clips, tmp_path, monkeypatch, batch_size):
    """``cli.score.score_groups`` with a DA3 scorer on mp4s, decoded at the
    tiny size by both packages' real ``sample_uniform_frames``."""
    monkeypatch.setattr(tio, "sample_uniform_frames",
                        functools.partial(tio.sample_uniform_frames, size=SIZE))
    monkeypatch.setattr(jio, "sample_uniform_frames",
                        functools.partial(jio.sample_uniform_frames, size=SIZE))
    videos = []
    for i, c in enumerate(clips + [clips[0][::-1]]):
        _write_mp4(tmp_path / f"v{i}.mp4", c)
        videos.append({"video_path": f"v{i}.mp4", "generation_id": i})
    data = {"groups": [{"group_id": "g0", "prompt": "p", "videos": videos}]}
    da3, _, model, _ = weights
    got, want = json.loads(json.dumps(data)), json.loads(json.dumps(data))
    jvp = _jax_vp(weights, {"Consistency_Score": jm.ConsistencyScore(None)})
    tvp = _port_vp(weights, {"Consistency_Score": tm.ConsistencyScore(None)})
    jscore.score_groups(jvp, want, str(tmp_path / "j.json"), base_dir=str(tmp_path),
                        num_frames=S, batch_size=batch_size)
    stats = tscore.score_groups(tvp, got, str(tmp_path / "t.json"), base_dir=str(tmp_path),
                                num_frames=S, batch_size=batch_size)
    assert stats == {"scored": 3, "failed": 0, "resumed": 0}
    for g, w in zip(got["groups"][0]["videos"], want["groups"][0]["videos"]):
        assert abs(g["consistency_score"] - w["consistency_score"]) <= FLIP + 1e-6, (g, w)
        assert abs(g["motion_norm"] - w["motion_norm"]) <= 1e-5, (g, w)


def test_quantize_da3_int8_equals_the_bridge_of_the_jax_quantised_tree(weights):
    """``quantize_da3_int8`` on the port's module gives the state the bridge
    makes of JAX's ``quantize_da3_int8`` tree: the same int8 weights, their
    scales to 1e-7; the heads, camera MLPs and patch embed stay float."""
    da3, _, _, _ = weights
    qtree = jax.tree.map(np.asarray, jquant.quantize_da3_int8(jax.tree.map(jnp.asarray, da3)))
    want = state_dict_from_jax(qtree)
    model = tquant.quantize_da3_int8(load_jax_params(DA3(DA3Config.tiny()), da3))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        if key.endswith(".w_scale"):
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-7, err_msg=key)
        else:
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), w.numpy(), err_msg=key)
    n_q = sum(k.endswith(".w_int8") for k in got)
    assert n_q == 4 * DA3Config.tiny().depth  # qkv, proj, fc1, fc2 of every trunk block
    assert not any(k.startswith(("backbone.patch_embed", "head.", "cam_")) and
                   k.endswith(".w_int8") for k in got)
    # and the loaded quantised tree scores through the int8 mode
    vp = VideoProcessor({"Consistency_Score": tm.ConsistencyScore(None)},
                        params=load_jax_params(DA3(DA3Config.tiny()), qtree).eval(),
                        backbone="da3", compute_dtype=torch.float32, device="cpu",
                        attn_impl="flash_int8")
    frames = np.random.default_rng(5).integers(0, 256, (S, SIZE, SIZE, 3), dtype=np.uint8)
    assert np.isfinite(vp.process_frames(frames, [0])[0]["Consistency_Score"])
