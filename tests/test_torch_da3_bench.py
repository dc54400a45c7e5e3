"""The port's DA3 benchmark (``videogpa_torch/models/da3/{bench,bench_datasets}.py``)
against the JAX package's on the CPU: ``Evaluator.run`` in its three modes
on an ``npz_dir`` scene with the tiny DA3 in f32 (a tree shaped as JAX's
``da3_init`` gives it, carried across by the bridge), the pose metrics,
sharding, and every dataset loader on synthetic fixtures in its on-disk
format (``tests/test_da3_aux.py``'s). Mirrors ``tests/test_da3.py``'s
``test_evaluator_recon_modes``, ``tests/test_aux.py``'s ``TestBench`` and
``tests/test_da3_aux.py``'s ``TestBenchDatasets`` / ``TestMoreBenchDatasets``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videogpa_tpu.models.da3.model as jmodel
from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import bench as jbench
from videogpa_tpu.models.da3.bench_datasets import read_ply_xyz as j_read_ply_xyz
from videogpa_tpu.reward.pointcloud import save_ply as j_save_ply
import videogpa_torch.models.da3.bench_datasets as tbd
from videogpa_torch.convert import load_jax_params
from videogpa_torch.models.da3 import DA3, DA3Config
from videogpa_torch.models.da3 import bench as tbench
from videogpa_torch.reward.pointcloud import save_ply
from test_da3_aux import (_make_7scenes_fixture, _make_dtu64_fixture, _make_dtu_fixture,
                          _make_eth3d_fixture, _make_hiroom_fixture, _make_scannetpp_fixture)
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 on both sides: DA3's outputs agree to ~1e-5 relative; the pose errors
# are angles from them (arccos near 1 amplifies: atol in degrees); the recon
# metrics are means over nearest-neighbour distances of fused clouds that may
# differ by a voxel an edge crossed in the last bit (see test_torch_da3_recon)
POSE_ATOL_DEG, RECON_RTOL = 1e-2, 1e-3
_KEYS = ("rra5", "rta5", "auc30", "acc", "comp", "overall", "precision", "recall", "fscore")


@pytest.fixture(scope="module")
def tiny():
    tree = random_jax_tree(jmodel.da3_init, JaxDA3Config.tiny())
    tree["cam_dec"]["fc_fov"]["bias"] += 1.0  # a random decoder can emit fov 0
    return tree, load_jax_params(DA3(DA3Config.tiny()), tree).eval()


@pytest.fixture
def f32_inference(monkeypatch):
    """Both packages' ``da3_inference`` in f32, as the evaluators call it."""
    monkeypatch.setattr(jmodel, "da3_inference", functools.partial(
        jmodel.da3_inference, compute_dtype=jnp.float32))
    monkeypatch.setattr(tbench, "da3_inference", functools.partial(
        tbench.da3_inference, compute_dtype=torch.float32))


def _scene(root, name="scene_a", S=3, H=56, W=56, seed=0):
    """A slow pan over a textured plane: GT poses, intrinsics and points."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (S, H, W, 3), dtype=np.uint8)
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (S, 1, 1))
    extr[:, 0, 3] = 0.1 * np.arange(S)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    gx, gy = np.meshgrid(np.linspace(-1, 1, 30), np.linspace(-1, 1, 30))
    points = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 2.0)], -1).astype(np.float32)
    np.savez(root / f"{name}.npz", frames=frames, extrinsics=extr,
             intrinsics=np.tile(K, (S, 1, 1)), points=points)


def _close_summaries(got, want):
    assert got["mode"] == want["mode"] and got["scenes"] == want["scenes"]
    assert [r["scene"] for r in got["rows"]] == [r["scene"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w) and g["views"] == w["views"]
        for k in _KEYS:
            if k not in w:
                continue
            if k in ("rra5", "rta5", "auc30"):
                np.testing.assert_allclose(g[k], w[k], atol=POSE_ATOL_DEG / 30)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RECON_RTOL, atol=1e-6)
    assert {k for k in got if k.startswith("mean_")} == {k for k in want if k.startswith("mean_")}


@pytest.mark.parametrize("mode", ["pose", "recon_posed", "recon_unposed"])
def test_evaluator_run_matches_jax(tiny, f32_inference, tmp_path, monkeypatch, mode):
    tree, model = tiny
    _scene(tmp_path)
    _scene(tmp_path, "scene_b", seed=1)
    monkeypatch.setenv("DA3_BENCH_DIR", str(tmp_path))
    want = jbench.Evaluator(tree, JaxDA3Config.tiny(), mode=mode, voxel_size=0.1).run(
        jbench.DATASET_REGISTRY["npz_dir"](), out_json=str(tmp_path / "jax.json"))
    got = tbench.Evaluator(model, mode=mode, voxel_size=0.1).run(
        tbench.DATASET_REGISTRY["npz_dir"](), out_json=str(tmp_path / "port" / "r.json"))
    assert got["scenes"] == 2 and (tmp_path / "port" / "r.json").exists()
    _close_summaries(got, want)
    if mode == "pose":
        # the same angles that feed the rates
        ds = tbench.DATASET_REGISTRY["npz_dir"]()
        scene = ds.get_data("scene_a")
        pred = tbench.da3_inference(model, scene.frames)
        jpred = jmodel.da3_inference(tree, scene.frames, JaxDA3Config.tiny())
        for a, b in zip(tbench.relative_pose_errors(pred.extrinsics, scene.gt_extrinsics),
                        jbench.relative_pose_errors(jpred.extrinsics, scene.gt_extrinsics)):
            np.testing.assert_allclose(a, b, atol=POSE_ATOL_DEG)
    else:
        assert np.isfinite(got["mean_overall"]) and "fscore" in got["rows"][0]


def test_evaluator_shards_and_rejects_modes(tiny, f32_inference, tmp_path, monkeypatch):
    tree, model = tiny
    for i in range(3):
        _scene(tmp_path, f"s{i}", S=2, seed=i)
    monkeypatch.setenv("DA3_BENCH_DIR", str(tmp_path))
    ds = tbench.DATASET_REGISTRY["npz_dir"]()
    assert ds.scenes() == ["s0", "s1", "s2"]
    rows = [tbench.Evaluator(model, shard_id=i, total_shards=2).run(ds)["rows"]
            for i in range(2)]
    assert [r["scene"] for r in rows[0]] == ["s0", "s2"] and [r["scene"] for r in rows[1]] == [
        "s1"]
    with pytest.raises(ValueError):
        tbench.Evaluator(model, mode="depth")


def test_pose_metrics_match_jax():
    rng = np.random.default_rng(0)
    E = np.tile(np.eye(4)[:3], (4, 1, 1))
    E[:, :3, 3] = rng.standard_normal((4, 3))
    rot, trans = tbench.relative_pose_errors(E, E)
    assert rot.max() < 1e-3 and trans.max() < 1e-3
    assert tbench.auc_at(rot) > 0.99
    P = E.copy()
    P[:, :3, 3] += rng.normal(0, 0.3, (4, 3))
    for a, b in zip(tbench.relative_pose_errors(P, E), jbench.relative_pose_errors(P, E)):
        np.testing.assert_array_equal(a, b)
    errs = rng.uniform(0, 40, 50)
    assert tbench.auc_at(errs) == jbench.auc_at(errs) and tbench.auc_at(np.array([])) == 0.0


def test_print_metrics_equals_jax(capsys):
    summary = {"mode": "pose", "scenes": 2, "rows": [], "mean_auc30": 0.25, "mean_rra5": 1.0}
    tbench.print_metrics(summary)
    got = capsys.readouterr().out
    jbench.print_metrics(summary)
    assert got == capsys.readouterr().out


def _same_scene(got, want):
    assert got.name == want.name
    np.testing.assert_array_equal(got.frames, want.frames)
    for k in ("gt_extrinsics", "gt_intrinsics", "gt_points"):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,make,scene,extra", [
    ("dtu", _make_dtu_fixture, "scan1", {}),
    ("7scenes", _make_7scenes_fixture, "chess", {}),
    ("eth3d", _make_eth3d_fixture, "courtyard", {}),
    ("dtu64", _make_dtu64_fixture, "scan1", {"camera_root": "Cameras"}),
    ("hiroom", _make_hiroom_fixture, "room_a", {}),
    ("scannetpp", _make_scannetpp_fixture, "09c1414f1b", {}),
])
def test_dataset_loaders_read_as_jax(tmp_path, name, make, scene, extra):
    make(tmp_path)
    got, want = tbench.DATASET_REGISTRY[name](), jbench.DATASET_REGISTRY[name]()
    for ds in (got, want):
        ds.root = str(tmp_path)
        for k, v in extra.items():
            setattr(ds, k, str(tmp_path / v))
    assert got.scenes() == want.scenes() == [scene]
    _same_scene(got.get_data(scene), want.get_data(scene))
    assert type(got).__module__ == tbd.__name__


def test_dtu_loader_with_points_and_evaluator(tiny, f32_inference, tmp_path):
    """``TestBenchDatasets::test_dtu_loader_and_evaluator`` on the port, with
    the GT cloud DTU keeps under ``Points/stl`` and the pose mode against JAX."""
    tree, model = tiny
    _make_dtu_fixture(tmp_path, hw=(28, 28))
    (tmp_path / "Points" / "stl").mkdir(parents=True)
    pts = np.random.default_rng(2).standard_normal((40, 3)).astype(np.float32)
    save_ply(pts, np.zeros((40, 3), np.uint8), str(tmp_path / "Points" / "stl" /
                                                    "stl001_total.ply"))
    ds, jds = tbench.DATASET_REGISTRY["dtu"](), jbench.DATASET_REGISTRY["dtu"]()
    ds.root = jds.root = str(tmp_path)
    scene = ds.get_data("scan1")
    assert scene.frames.shape == (4, 28, 28, 3) and scene.gt_extrinsics.shape == (4, 3, 4)
    np.testing.assert_allclose(scene.gt_points, pts, atol=1e-6)
    _close_summaries(tbench.Evaluator(model, mode="pose").run(ds),
                     jbench.Evaluator(tree, JaxDA3Config.tiny(), mode="pose").run(jds))


@pytest.mark.parametrize("binary", [True, False])
def test_ply_reader_matches_jax(tmp_path, binary):
    pts = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    if binary:
        j_save_ply(pts, np.zeros((50, 3), np.uint8), path)
    else:
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex 50\nproperty float x\n"
                    "property float y\nproperty float z\nelement face 0\n"
                    "property list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{x} {y} {z}\n" for x, y, z in pts)
    got = tbd.read_ply_xyz(path)
    np.testing.assert_array_equal(got, j_read_ply_xyz(path))
    np.testing.assert_allclose(got, pts, atol=1e-6)
