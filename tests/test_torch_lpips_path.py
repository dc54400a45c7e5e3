"""``VIDEOGPA_LPIPS_PATH`` in both packages: with the variable naming a
converted LPIPS tree, the port's ``ConsistencyScore``, ``LPIPSMetric`` and
``build_metrics`` load the same network as the JAX package's and score the
same clip alike; with a path that names no file both score MSE only."""

import numpy as np
import pytest
import torch

import videogpa_tpu.metrics as jm
import videogpa_tpu.metrics.api as jm_api
from videogpa_tpu.checkpoint import save_pytree as j_save_pytree
from videogpa_tpu.models.lpips import lpips_init as j_lpips_init
import videogpa_torch.metrics as tm
import videogpa_torch.metrics.api as tm_api
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
LPIPS_ATOL = 1e-4  # tests/test_torch_reward.py's LPIPS tolerance


@pytest.fixture
def clean_caches():
    jm_api._LPIPS_CACHE.clear()
    tm_api._LPIPS_CACHE.clear()
    yield
    jm_api._LPIPS_CACHE.clear()
    tm_api._LPIPS_CACHE.clear()


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(7)
    gt = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)  # (T, H, W, C) uint8
    rep = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1))
    extr[:, 0, 3] = [0.0, 0.2, 0.5]
    return gt, rep, extr


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    j_save_pytree(random_jax_tree(j_lpips_init, seed=3), path)
    return path


def _scores(pkg, clip, **kw):
    gt, rep, extr = clip
    cons = pkg.ConsistencyScore(**kw).compute(gt=gt, rep=rep, extrinsics=extr)
    lp = pkg.LPIPSMetric(**kw).compute(gt=gt, rep=rep)
    built = pkg.build_metrics(**kw)["Consistency_Score"].compute(gt=gt, rep=rep,
                                                                 extrinsics=extr)
    return cons, lp, built


def test_lpips_path_loads_the_same_network(monkeypatch, clean_caches, clip, lpips_file):
    monkeypatch.setenv("VIDEOGPA_LPIPS_PATH", lpips_file)
    (j_cons, j_motion), j_lp, (j_built, _) = _scores(jm, clip)
    (t_cons, t_motion), t_lp, (t_built, _) = _scores(tm, clip, device="cpu")
    mse = tm.MSEMetric().compute(gt=clip[0], rep=clip[1])
    assert j_lp > 1e-3 and j_cons > mse + 1e-3  # the network is on: MSE + LPIPS
    np.testing.assert_allclose(t_lp, j_lp, atol=LPIPS_ATOL)
    np.testing.assert_allclose(t_cons, j_cons, atol=LPIPS_ATOL)
    np.testing.assert_allclose(t_built, j_built, atol=LPIPS_ATOL)
    np.testing.assert_allclose(t_motion, j_motion, rtol=1e-5, atol=1e-6)
    # one module per device, read once
    assert tm_api._default_lpips("cpu") is tm_api._default_lpips(torch.device("cpu"))
    assert tm.build_metrics(device="cpu")["LPIPS"].params is tm_api._default_lpips("cpu")


def test_missing_lpips_path_scores_mse_only(monkeypatch, clean_caches, clip, tmp_path):
    monkeypatch.setenv("VIDEOGPA_LPIPS_PATH", str(tmp_path / "absent.npz"))
    mse = tm.MSEMetric().compute(gt=clip[0], rep=clip[1])
    for pkg, kw in ((jm, {}), (tm, {"device": "cpu"})):
        (cons, _), lp, (built, _) = _scores(pkg, clip, **kw)
        assert lp == 0.0
        np.testing.assert_allclose([cons, built], [mse, mse], rtol=1e-5)
    assert tm_api._default_lpips() is None  # no file: no device is resolved


def test_unset_lpips_path_needs_no_device(monkeypatch, clean_caches):
    monkeypatch.delenv("VIDEOGPA_LPIPS_PATH", raising=False)
    assert tm_api._default_lpips() is None
    assert tm.LPIPSMetric().params is None and tm.ConsistencyScore().params is None
