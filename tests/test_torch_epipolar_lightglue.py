"""``EpipolarMetric("lightglue")`` on the port against the JAX package's on
the CPU: ``LightGlueMatcher`` with injected weights and with weights named by
``VIDEOGPA_SUPERPOINT_PATH`` / ``VIDEOGPA_LIGHTGLUE_PATH`` (the same
keypoints in the same order, the same matches, the same Epipolar value),
``build_metrics(descriptor_type="lightglue")``, and the replicate scorer with
``SCORE_DESCRIPTOR_TYPE=lightglue`` against the root ``replicate_scorer.py``.

Random weights match nothing: deep random ReLU convolutions give nearly
parallel descriptors, and random attention layers make the similarity rank
one, so the mutual rule keeps one match a pair. The trees here are random
trees with He-scaled SuperPoint kernels (the activations keep their scale
through the 8 ReLU layers) and a LightGlue whose layers still run but add
nothing to the residual stream (``fc2`` zero), between identity projections
(the final one scaled, so the dual softmax is sharp): the matcher then pairs
the descriptors' mutual nearest neighbours and the geometry runs."""

import copy
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import videogpa_tpu.data.video_io as jio
import videogpa_tpu.metrics.api as jm_api
import videogpa_tpu.models.loader as jloader
import videogpa_tpu.reward as jreward
import videogpa_tpu.reward.processor as jprocessor
from videogpa_tpu.checkpoint import save_pytree
from videogpa_tpu.metrics.epipolar import LightGlueMatcher as JaxMatcher
from videogpa_tpu.metrics.epipolar import epipolar_error as j_epipolar_error
from videogpa_tpu.models import matching as jmatch
from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
import videogpa_torch.data.video_io as tio
import videogpa_torch.metrics.api as tm_api
import videogpa_torch.reward as treward
from videogpa_torch.cli import replicate_scorer as trs
from videogpa_torch.convert import load_jax_params
from videogpa_torch.metrics.epipolar import LightGlueMatcher, epipolar_error
from videogpa_torch.models import loader as tloader
from videogpa_torch.models import matching as tmatch
from videogpa_torch.models.da3 import DA3Config
from test_torch_bridge import random_jax_tree
from test_torch_replicate import S, SIZE, _outputs, da3_weights  # noqa: F401

torch.set_num_threads(2)
K, LAYERS = 64, 2
# the same matches feed the same host geometry (f32 points, an f32 SVD in
# each package): the Epipolar values agree to f32 rounding
EPI_RTOL = 1e-4
_J_SP = jax.jit(jmatch.superpoint_forward, static_argnums=(2,))
_J_KP = jax.jit(jmatch.extract_keypoints, static_argnums=(2,))
_J_LG = jax.jit(jmatch.lightglue_match, static_argnums=(7, 8))


def matching_trees(seed=0, layers=LAYERS, scale=128.0):
    """(superpoint, lightglue) trees shaped as the JAX initialisers give them,
    made to match: see the module docstring."""
    sp = random_jax_tree(jmatch.superpoint_init, jmatch.SuperPointConfig(), seed=seed)
    for p in sp.values():
        p["kernel"] = p["kernel"] * 6 ** 0.5
    lg = copy.deepcopy(random_jax_tree(jmatch.lightglue_init,
                                       jmatch.LightGlueConfig(n_layers=layers), seed=seed + 1))
    d = lg["input_proj"]["kernel"].shape[0]
    eye, zero = np.eye(d, dtype=np.float32), np.zeros(d, np.float32)
    lg["input_proj"] = {"kernel": eye, "bias": zero}
    lg["final_proj"] = {"kernel": scale * eye, "bias": zero}
    lg["matchability"]["kernel"] = lg["matchability"]["kernel"] * 0
    for layer in lg["layers"]:
        for blk in ("self", "cross"):
            fc2 = layer[blk]["ffn"]["fc2"]
            fc2["kernel"], fc2["bias"] = fc2["kernel"] * 0, fc2["bias"] * 0
    return sp, lg


def textured_clip(T=4, H=64, W=96, step=8, seed=0):
    """A bicubic-upsampled random texture panned ``step`` pixels a frame: no
    flat plateaus, so no two keypoint scores tie to the last bit."""
    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.uniform(0, 255, (1, 3, H // 4 + 2, (W + step * T) // 4 + 2))
                           .astype(np.float32))
    big = F.interpolate(tex, scale_factor=4, mode="bicubic").clamp(0, 255).round()
    big = big[0].permute(1, 2, 0).numpy().astype(np.uint8)
    return np.stack([big[:H, step * t: step * t + W] for t in range(T)])


def _small_cfgs(matcher, pkg):
    matcher.sp_cfg = pkg.SuperPointConfig(max_num_keypoints=K)
    matcher.lg_cfg = pkg.LightGlueConfig(n_layers=LAYERS, filter_threshold=0.0)
    return matcher


@pytest.fixture(scope="module")
def trees():
    return matching_trees()


@pytest.fixture(autouse=True)
def jitted_jax_matcher(monkeypatch):
    """The JAX matcher calls the package's functions eagerly (a compile of
    every op at first use); jitted they give the same values sooner."""
    monkeypatch.setattr(jmatch, "superpoint_forward", _J_SP)
    monkeypatch.setattr(jmatch, "extract_keypoints", _J_KP)
    monkeypatch.setattr(jmatch, "lightglue_match", _J_LG)


def _port_matcher(sp, lg, **kw):
    return _small_cfgs(LightGlueMatcher(
        sp_params=load_jax_params(tmatch.SuperPoint(), sp).eval(),
        lg_params=load_jax_params(tmatch.LightGlue(tmatch.LightGlueConfig(n_layers=LAYERS)),
                                  lg).eval(), device="cpu", **kw), tmatch)


def _assert_same_pairs(got, want, clip):
    for i in range(len(clip) - 1):
        g, w = got.get_matched_points(clip[i], clip[i + 1]), want.get_matched_points(
            clip[i], clip[i + 1])
        assert g[2] == w[2] >= 20, (i, g[2], w[2])  # enough matches: the geometry runs
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))


def test_lightglue_matcher_matches_jax(trees):
    sp, lg = trees
    clip = textured_clip(T=3)
    want = _small_cfgs(JaxMatcher(sp_params=sp, lg_params=lg), jmatch)
    got = _port_matcher(sp, lg)
    assert got.device == torch.device("cpu") and got.min_matches == want.min_matches == 20
    _assert_same_pairs(got, want, clip)
    e_want, e_got = j_epipolar_error(clip, want), epipolar_error(clip, got)
    assert e_want >= 0.0
    np.testing.assert_allclose(e_got, e_want, rtol=EPI_RTOL)
    # the pairs mostly pair each point with itself 8 pixels on
    p1, p2, n = got.get_matched_points(clip[0], clip[1])
    assert (np.abs(p1 - p2 - [8, 0]).max(1) < 0.5).mean() > 0.5


def test_lightglue_matcher_reads_the_env_paths(trees, tmp_path, monkeypatch):
    sp, lg = trees
    save_pytree(sp, str(tmp_path / "sp.npz"))
    save_pytree(lg, str(tmp_path / "lg.npz"))
    monkeypatch.setenv("VIDEOGPA_SUPERPOINT_PATH", str(tmp_path / "sp.npz"))
    monkeypatch.setenv("VIDEOGPA_LIGHTGLUE_PATH", str(tmp_path / "lg.npz"))
    want = _small_cfgs(jm_api.EpipolarMetric(descriptor_type="lightglue").matcher, jmatch)
    got = _small_cfgs(tm_api.EpipolarMetric(descriptor_type="lightglue", device="cpu").matcher,
                      tmatch)
    assert isinstance(got, LightGlueMatcher) and len(got.lg_params.layers) == LAYERS
    clip = textured_clip(T=3, seed=1)
    _assert_same_pairs(got, want, clip)
    np.testing.assert_allclose(epipolar_error(clip, got), j_epipolar_error(clip, want),
                               rtol=EPI_RTOL)


def test_build_metrics_builds_the_matcher_on_its_device(monkeypatch):
    """Without weights each net is drawn from a generator seeded with 0, on
    the metric set's device; two builds hold the same weights."""
    monkeypatch.delenv("VIDEOGPA_SUPERPOINT_PATH", raising=False)
    monkeypatch.delenv("VIDEOGPA_LIGHTGLUE_PATH", raising=False)
    monkeypatch.delenv("VIDEOGPA_LPIPS_PATH", raising=False)
    monkeypatch.setattr(tm_api, "_LPIPS_CACHE", {})
    a = tm_api.build_metrics(device="cpu", descriptor_type="lightglue")["Epipolar"].matcher
    b = tm_api.EpipolarMetric(descriptor_type="lightglue", device="cpu").matcher
    assert isinstance(a, LightGlueMatcher)
    assert a.sp_cfg == tmatch.SuperPointConfig() and a.lg_cfg == tmatch.LightGlueConfig()
    for m, n in ((a.sp_params, b.sp_params), (a.lg_params, b.lg_params)):
        sd_a, sd_b = m.state_dict(), n.state_dict()
        assert all(v.device.type == "cpu" for v in sd_a.values())
        assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert len(a.lg_params.layers) == 9
    if not torch.cuda.is_available():  # the card by default: no quiet fall-back
        with pytest.raises(RuntimeError, match="CUDA"):
            LightGlueMatcher()


def test_replicate_scorer_with_lightglue_matches_the_root_scorer(da3_weights, trees, tmp_path,
                                                                 monkeypatch):
    """``SCORE_DESCRIPTOR_TYPE=lightglue`` through both scorers (the harness
    of ``test_torch_replicate.py``): each builds its matcher on the scorer's
    device; the injected trees and small configs replace the defaults on both
    sides."""
    tree, model = da3_weights
    sp, lg = trees
    base = tmp_path / "gen"
    _outputs(base)
    monkeypatch.setattr(tio, "sample_uniform_frames",
                        functools.partial(tio.sample_uniform_frames, size=SIZE))
    monkeypatch.setattr(jio, "sample_uniform_frames",
                        functools.partial(jio.sample_uniform_frames, size=SIZE))
    monkeypatch.setattr(jprocessor, "sample_uniform_frames", jio.sample_uniform_frames)
    monkeypatch.delenv("VIDEOGPA_LPIPS_PATH", raising=False)
    monkeypatch.setattr(jm_api, "_LPIPS_CACHE", {})
    monkeypatch.setattr(tm_api, "_LPIPS_CACHE", {})
    monkeypatch.setattr(jloader, "load_da3", lambda name: (tree, JaxDA3Config.tiny()))
    monkeypatch.setattr(tloader, "load_da3", lambda name, device=None: (model, DA3Config.tiny()))
    monkeypatch.setattr(jreward, "VideoProcessor", functools.partial(
        jreward.VideoProcessor, compute_dtype=jnp.float32))
    monkeypatch.setattr(treward, "VideoProcessor", functools.partial(
        treward.VideoProcessor, compute_dtype=torch.float32))
    built = []

    def jax_matcher(min_matches=20):
        return _small_cfgs(JaxMatcher(min_matches=8, sp_params=sp, lg_params=lg), jmatch)

    def port_matcher(min_matches=20, device=None):
        built.append(device)
        m = _port_matcher(sp, lg, min_matches=8)
        m.device = torch.device(device)
        return m

    monkeypatch.setattr(jm_api, "LightGlueMatcher", jax_matcher)
    monkeypatch.setattr(tm_api, "LightGlueMatcher", port_matcher)
    env = {"SCORE_BASE_DIR": str(base), "SCORE_NUM_FRAMES": str(S), "SCORE_BATCH": "2",
           "SCORE_SEED_FILTER": "456", "SCORE_DESCRIPTOR_TYPE": "lightglue"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("SCORE_OUTPUT_CSV", str(tmp_path / "jax" / "scores.csv"))
    import replicate_scorer as jrs

    importlib.reload(jrs)
    jrs.main()
    cfg = trs.build_score_config({**env, "SCORE_OUTPUT_CSV": str(tmp_path / "t" / "scores.csv")})
    assert cfg["descriptor_type"] == "lightglue" == jrs.SCORE_CONFIG["descriptor_type"]
    trs.main(cfg, device="cpu")
    assert built == ["cpu"]
    with open(tmp_path / "jax" / "scores.json") as f:
        want = {r["relative_path"]: r for r in json.load(f)["rows"]}
    with open(tmp_path / "t" / "scores.json") as f:
        got = {r["relative_path"]: r for r in json.load(f)["rows"]}
    assert set(got) == set(want)
    ran = 0
    for path, w in want.items():
        g = got[path]
        assert bool(g.get("error")) == bool(w.get("error")), path
        if w.get("error"):
            continue
        ran += w["epipolar"] >= 0
        np.testing.assert_allclose(g["epipolar"], w["epipolar"], rtol=EPI_RTOL, atol=1e-6)
    assert ran >= 1  # at least one clip's pairs reached the geometry
