"""The score leg from files on the port (``videogpa_torch/cli/score.py`` and
the rest of ``reward/processor.py``) against the JAX package's, on the CPU,
with the tiny VGGT holding the same weights in both packages.

mp4s written here with OpenCV are decoded by both packages' real
``sample_uniform_frames``, at the tiny model's image size (56), so the fused
raw-upload path runs as it does at 518 with VGGT-1B. Covered: ``score_groups``
batched (one-thread decode prefetch) and async single-clip, resume, per-item
isolation of an unreadable clip, ``main(argv)`` with ``load_vggt``
monkeypatched (exact and ``--int8``; ``--backbone da3`` with ``load_da3``
monkeypatched to the tiny DA3), the fused
path against the per-metric path (``tests/test_reward.py::
test_fused_scoring_matches_per_metric``), frames of another size through the
host preprocessing, ``save_visuals`` and ``save_ply``, and the scorer half of
``tests/test_e2e.py::TestEndToEndSlice``.

Tolerances: as ``tests/test_torch_reward.py`` argues, the two packages'
backbones agree to ~1e-6 in f32, so a score moves only where a z-buffer
winner flips between near-equal depths: consistency scores within 2 flipped
pixels (2 / (S * H * W)) + 1e-6, motion within 1e-5. Fused against
per-metric on the port: the same functions on the same tensors, rtol 1e-4,
atol 1e-5 (the reference test's tolerance).
"""

import functools
import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.cli.score as jscore
import videogpa_tpu.data.video_io as jio
import videogpa_tpu.metrics as jm
from videogpa_tpu.models.lpips import lpips_init as j_lpips_init
from videogpa_tpu.models.vggt import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.vggt import vggt_init as j_vggt_init
from videogpa_tpu.reward import VideoProcessor as JaxVideoProcessor
import videogpa_torch.cli.score as tscore
import videogpa_torch.data.video_io as tio
import videogpa_torch.metrics as tm
import videogpa_torch.models.loader as tloader
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.da3 import DA3Config, da3_init
from videogpa_torch.models.lpips import LPIPS
from videogpa_torch.models.vggt import VGGT, VGGTConfig
from videogpa_torch.reward import VideoProcessor
from videogpa_torch.reward.pointcloud import save_ply
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
S, SIZE = 3, 56  # frames a clip, the tiny config's image size
FLIP = 2.0 / (S * SIZE * SIZE) + 1e-6


@pytest.fixture(scope="module")
def weights():
    """The tiny VGGT and LPIPS in both packages (fov bias +1 rad, as in
    ``tests/test_torch_reward.py``: a random camera head can emit fov 0)."""
    vggt = random_jax_tree(j_vggt_init, JaxVGGTConfig.tiny())
    vggt["camera_head"]["pose_branch"]["fc2"]["bias"][7:9] += 1.0
    lp = random_jax_tree(j_lpips_init, seed=1)
    return (vggt, lp, load_jax_params(VGGT(VGGTConfig.tiny()), vggt).eval(),
            load_jax_params(LPIPS(), lp).eval())


def _write_mp4(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             frames.shape[2:0:-1])
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """2 groups x 2 candidate videos (one smooth pan, one jittery), as
    ``tests/test_e2e.py``'s workspace."""
    base = tmp_path_factory.mktemp("score")
    rng = np.random.default_rng(0)
    groups = []
    os.makedirs(base / "videos")
    for g in range(2):
        bg = cv2.GaussianBlur(rng.uniform(0, 255, (140, 140, 3)).astype(np.uint8), (0, 0), 3)
        videos = []
        for vid, jitter in ((0, 1), (1, 12)):
            frames = []
            for t in range(6):
                dy = int(np.clip(t * 2 + rng.integers(-jitter, jitter + 1), 0, 80))
                dx = int(np.clip(t * 3 + rng.integers(-jitter, jitter + 1), 0, 80))
                frames.append(bg[dy:dy + 48, dx:dx + 64])
            path = f"videos/g{g}_v{vid}.mp4"
            _write_mp4(base / path, np.stack(frames))
            videos.append({"video_path": path, "generation_id": vid})
        groups.append({"group_id": f"g{g}", "prompt": f"scene {g}", "videos": videos})
    return base, {"groups": groups}


@pytest.fixture
def tiny_decode(monkeypatch):
    """Both packages decode at the tiny model's image size."""
    monkeypatch.setattr(tio, "sample_uniform_frames",
                        functools.partial(tio.sample_uniform_frames, size=SIZE))
    monkeypatch.setattr(jio, "sample_uniform_frames",
                        functools.partial(jio.sample_uniform_frames, size=SIZE))


def _port_vp(weights, lpips=True):
    _, _, model, lp = weights
    return VideoProcessor({"Consistency_Score": tm.ConsistencyScore(lp if lpips else None)},
                          params=model, compute_dtype=torch.float32, device="cpu")


def _jax_vp(weights, lpips=True):
    vggt, lp, _, _ = weights
    return JaxVideoProcessor({"Consistency_Score": jm.ConsistencyScore(lp if lpips else None)},
                             params=vggt, config=JaxVGGTConfig.tiny(),
                             compute_dtype=jnp.float32, attn_impl="xla")


def _scores(data):
    return {v["video_path"]: (v["consistency_score"], v["motion_norm"])
            for g in data["groups"] for v in g["videos"] if "consistency_score" in v}


def _copy(data):
    return json.loads(json.dumps(data))


@pytest.mark.parametrize("batch_size", [1, 2], ids=["async", "batched"])
def test_score_groups_matches_jax_and_resumes(weights, workspace, tiny_decode, tmp_path,
                                              batch_size):
    base, data = workspace
    got, want = _copy(data), _copy(data)
    out = str(tmp_path / "port.json")
    stats = tscore.score_groups(_port_vp(weights), got, out, base_dir=str(base), num_frames=S,
                                batch_size=batch_size)
    jstats = jscore.score_groups(_jax_vp(weights), want, str(tmp_path / "jax.json"),
                                 base_dir=str(base), num_frames=S, batch_size=batch_size)
    assert stats == jstats == {"scored": 4, "failed": 0, "resumed": 0}
    g, w = _scores(got), _scores(want)
    assert set(g) == set(w) and len(g) == 4
    for path, (cs, mn) in w.items():
        assert abs(g[path][0] - cs) <= FLIP, (path, g[path], (cs, mn))
        assert abs(g[path][1] - mn) <= 1e-5
    with open(out) as f:
        assert _scores(json.load(f)) == g  # saved atomically with every score
    # resume: a second run scores nothing new and keeps the scores
    again = _copy(data)
    stats2 = tscore.score_groups(_port_vp(weights), again, out, base_dir=str(base),
                                 num_frames=S, batch_size=batch_size)
    assert stats2 == {"scored": 0, "failed": 0, "resumed": 4} and _scores(again) == g
    assert tscore.load_resume_map(out) == {p: tuple(v) for p, v in g.items()}


@pytest.mark.parametrize("batch_size", [1, 2], ids=["async", "batched"])
def test_an_unreadable_clip_is_isolated_as_in_the_jax_package(weights, workspace, tiny_decode,
                                                              tmp_path, batch_size, capsys):
    base, data = workspace
    (base / "videos" / "broken.mp4").write_bytes(b"not a video")
    bad = _copy(data)
    bad["groups"][0]["videos"].insert(1, {"video_path": "videos/broken.mp4"})
    got, want = _copy(bad), _copy(bad)
    stats = tscore.score_groups(_port_vp(weights, lpips=False), got, str(tmp_path / "p.json"),
                                base_dir=str(base), num_frames=S, batch_size=batch_size)
    jstats = jscore.score_groups(_jax_vp(weights, lpips=False), want, str(tmp_path / "j.json"),
                                 base_dir=str(base), num_frames=S, batch_size=batch_size)
    assert stats == jstats == {"scored": 4, "failed": 1, "resumed": 0}
    assert "failed videos/broken.mp4" in capsys.readouterr().out
    assert "consistency_score" not in got["groups"][0]["videos"][1]
    for path, (cs, _) in _scores(want).items():
        assert abs(_scores(got)[path][0] - cs) <= FLIP


def main_stats(monkeypatch, argv):
    """``cli.score.main(argv)`` (which returns nothing) and the counts its
    ``score_groups`` call returned."""
    seen = []
    real = tscore.score_groups
    monkeypatch.setattr(tscore, "score_groups",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    assert tscore.main(argv) is None
    monkeypatch.setattr(tscore, "score_groups", real)
    return seen[-1]


def test_main_exits_zero_as_a_console_script(weights, workspace, tiny_decode, tmp_path,
                                             monkeypatch):
    """The ``videogpa-torch-score`` entry runs ``sys.exit(main())``: main must
    return None (a returned dict is printed to stderr with exit status 1)."""
    base, data = workspace
    _, _, model, _ = weights
    src = tmp_path / "groups.json"
    src.write_text(json.dumps(data))
    monkeypatch.setattr(tloader, "load_vggt", lambda *a, **k: (model, VGGTConfig.tiny()))
    with pytest.raises(SystemExit) as exit_info:
        sys.exit(tscore.main(["--input_json", str(src), "--output_json",
                              str(tmp_path / "o.json"), "--base_dir", str(base),
                              "--num_frames", str(S), "--device", "cpu", "--batch_size", "4"]))
    assert exit_info.value.code is None


def test_main_scores_a_group_json(weights, workspace, tiny_decode, tmp_path, monkeypatch):
    """``main(argv)`` with ``load_vggt`` monkeypatched (as
    ``tests/test_cli.py``'s scorer tests do): exact and ``--int8``; and
    ``--backbone da3`` with ``load_da3`` monkeypatched."""
    base, data = workspace
    _, _, model, _ = weights
    src = tmp_path / "groups.json"
    src.write_text(json.dumps(data))
    loads = []

    def fake_load_vggt(name, cfg=None, dtype=torch.float32, device=None):
        loads.append((name, str(device)))
        fresh = VGGT(VGGTConfig.tiny())  # --int8 quantises in place: a copy each run
        fresh.load_state_dict(model.state_dict())
        return fresh.eval(), VGGTConfig.tiny()

    monkeypatch.setattr(tloader, "load_vggt", fake_load_vggt)
    out = str(tmp_path / "scored.json")
    argv = ["--input_json", str(src), "--output_json", out, "--base_dir", str(base),
            "--num_frames", str(S), "--device", "cpu"]
    stats = main_stats(monkeypatch, argv + ["--batch_size", "2"])
    assert stats == {"scored": 4, "failed": 0, "resumed": 0}
    assert loads == [("facebook/VGGT-1B", "cpu")]
    exact = _scores(json.load(open(out)))
    stats8 = main_stats(monkeypatch,
                        argv + ["--output_json", str(tmp_path / "int8.json"), "--int8"])
    assert stats8 == {"scored": 4, "failed": 0, "resumed": 0}
    int8 = _scores(json.load(open(tmp_path / "int8.json")))
    assert set(int8) == set(exact) and all(np.isfinite(v[0]) for v in int8.values())
    # --backbone da3 loads DA3 (``load_da3`` monkeypatched: the tiny DA3)
    da3 = da3_init(DA3Config.tiny(), torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():
        da3.cam_dec.fc_fov.bias += 1.0  # a random camera decoder can emit fov 0

    def fake_load_da3(name, cfg=None, dtype=torch.float32, device=None):
        loads.append((name, str(device)))
        return da3, DA3Config.tiny()

    monkeypatch.setattr(tloader, "load_da3", fake_load_da3)
    stats_da3 = main_stats(monkeypatch, argv + ["--output_json", str(tmp_path / "da3.json"),
                                                "--backbone", "da3", "--batch_size", "2"])
    assert stats_da3 == {"scored": 4, "failed": 0, "resumed": 0}
    assert loads[-1] == ("depth-anything/DA3-Large", "cpu")
    by_da3 = _scores(json.load(open(tmp_path / "da3.json")))
    assert set(by_da3) == set(exact) and all(np.isfinite(v[0]) for v in by_da3.values())


def test_fused_scoring_matches_per_metric(weights, workspace, tiny_decode, monkeypatch):
    """``tests/test_reward.py::test_fused_scoring_matches_per_metric`` on the
    port: ``VIDEOGPA_NO_FUSED_METRICS=1`` takes the per-metric path (and
    ``process_frames_async`` refuses it), with the same numbers."""
    base, _ = workspace
    _, _, model, lp = weights
    frames = tio.sample_uniform_frames(str(base / "videos/g0_v1.mp4"), n_frames=S)
    metrics = {"MSE": tm.MSEMetric(), "Consistency_Score": tm.ConsistencyScore(lp),
               "MVCS": tm.MVCSMetric(), "PSNR": tm.PSNRMetric(), "SSIM": tm.SSIMMetric(),
               "LPIPS": tm.LPIPSMetric(lp), "Epipolar": tm.EpipolarMetric()}

    def score(fused):
        monkeypatch.setenv("VIDEOGPA_NO_FUSED_METRICS", "0" if fused else "1")
        vp = VideoProcessor(metrics, params=model, compute_dtype=torch.float32, device="cpu")
        return vp, vp.process_frames(frames, thresholds=[0])

    _, fused = score(True)
    vp, ref = score(False)
    for key in ("MSE", "Consistency_Score", "motion_norm", "MVCS", "PSNR", "SSIM", "LPIPS",
                "Epipolar"):
        np.testing.assert_allclose(fused[0][key], ref[0][key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(np.asarray(fused["_extrinsic"]), np.asarray(ref["_extrinsic"]),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError, match="fused"):
        vp.process_frames_async(frames, [0])
    batch = vp.process_frames_batch([frames, frames], [0])
    assert batch[0][0] == batch[1][0] and batch[0][0].keys() == ref[0].keys()


def test_other_frame_sizes_and_save_visuals_match_jax(weights, workspace, tmp_path):
    """Frames that are not square at the model's size go through the host's
    VGGT preprocessing (width 518) and the per-metric path, in both packages;
    ``save_visuals`` writes each threshold's reprojections as PNGs."""
    base, _ = workspace
    frames = tio.read_video_frames(str(base / "videos/g1_v0.mp4"), np.arange(S))  # 48 x 64
    want = _jax_vp(weights).process_frames(frames, [0], save_visuals=True,
                                           out_dir=str(tmp_path / "jax"))
    vp = _port_vp(weights)
    got = vp.process_frames(frames, [0], save_visuals=True, out_dir=str(tmp_path / "port"))
    flip = 2.0 / (S * 48 * 64) + 1e-6
    assert abs(got[0]["Consistency_Score"] - want[0]["Consistency_Score"]) <= flip
    assert abs(got[0]["motion_norm"] - want[0]["motion_norm"]) <= 1e-5
    np.testing.assert_allclose(np.asarray(got["_extrinsic"]), np.asarray(want["_extrinsic"]),
                               atol=1e-5)
    with pytest.warns(UserWarning, match="per-metric"):
        batch = vp.process_frames_batch([frames], [0])[0]
    assert abs(batch[0]["Consistency_Score"] - got[0]["Consistency_Score"]) <= 1e-6
    pngs = sorted(os.listdir(tmp_path / "port" / "th0" / "reprojections"))
    assert pngs == sorted(os.listdir(tmp_path / "jax" / "th0" / "reprojections"))
    assert pngs == [f"{i:03d}.png" for i in range(S)]
    for name in pngs:
        a = cv2.imread(str(tmp_path / "port" / "th0" / "reprojections" / name))
        b = cv2.imread(str(tmp_path / "jax" / "th0" / "reprojections" / name))
        assert a.shape == b.shape == (392, 518, 3)  # 48 x 64 at width 518, height / 14
        # the same reprojection up to z-buffer flips and a rounding step
        assert np.mean(np.abs(a.astype(int) - b.astype(int)) > 1) < 1e-3


def test_save_ply_writes_the_jax_package_bytes(tmp_path):
    from videogpa_tpu.reward.pointcloud import save_ply as j_save_ply

    rng = np.random.default_rng(4)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    cols = rng.uniform(-10, 300, (50, 3)).astype(np.float32)
    save_ply(torch.from_numpy(pts), torch.from_numpy(cols), str(tmp_path / "p.ply"))
    j_save_ply(pts, cols, str(tmp_path / "j.ply"))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_end_to_end_scorer_half(weights, workspace, tiny_decode, tmp_path):
    """The scoring phase of ``tests/test_e2e.py::TestEndToEndSlice`` on the
    port: MSE-only consistency (no LPIPS network), 4 clips, then a resumed
    run that scores nothing."""
    base, data = workspace
    data = _copy(data)
    vp = _port_vp(weights, lpips=False)
    out = str(tmp_path / "scored.json")
    stats = tscore.score_groups(vp, data, out, base_dir=str(base), num_frames=4)
    assert stats["scored"] == 4 and stats["failed"] == 0
    for g in data["groups"]:
        for v in g["videos"]:
            assert np.isfinite(v["consistency_score"]) and v["motion_norm"] >= 0
    stats2 = tscore.score_groups(vp, data, out, base_dir=str(base), num_frames=4)
    assert stats2["scored"] == 0 and stats2["resumed"] == 4
