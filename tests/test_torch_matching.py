"""The port's SuperPoint and LightGlue (``videogpa_torch/models/matching``)
against the JAX package's on the CPU in f32: ``superpoint_forward``,
``extract_keypoints`` (the same keypoints in the same order, on score maps
full of exact zeros and equal plateaus), ``lightglue_match`` (the same
``matches0``), the two converters key for key on synthetic checkpoints in the
official layouts, and the initialisers' trees. Weights: trees shaped as the
JAX initialisers give them (``random_jax_tree``) carried across by the
bridge. Mirrors ``tests/test_metrics.py``'s ``TestMatching``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models import matching as jmatch
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models import matching as tmatch
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 on both sides, convolutions and products in another summation order:
# ~1e-7 relative a layer; limits on the rel-norm of a whole output
FWD_REL = 1e-5
_j_sp = jax.jit(jmatch.superpoint_forward, static_argnums=(2,))
_j_kp = jax.jit(jmatch.extract_keypoints, static_argnums=(2,))
_j_lg = jax.jit(jmatch.lightglue_match, static_argnums=(7, 8))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def superpoint():
    tree = random_jax_tree(jmatch.superpoint_init, jmatch.SuperPointConfig())
    return tree, load_jax_params(tmatch.SuperPoint(), tree).eval()


@pytest.fixture(scope="module")
def lightglue():
    jcfg = jmatch.LightGlueConfig(n_layers=2, filter_threshold=0.0)
    tree = random_jax_tree(jmatch.lightglue_init, jcfg, seed=3)
    cfg = tmatch.LightGlueConfig(n_layers=2, filter_threshold=0.0)
    return tree, load_jax_params(tmatch.LightGlue(cfg), tree).eval(), jcfg, cfg


# --- TestMatching (tests/test_metrics.py:198) on the port --------------------

def test_superpoint_shapes():
    cfg = tmatch.SuperPointConfig(max_num_keypoints=64)
    model = tmatch.superpoint_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    img = torch.rand((2, 1, 64, 80), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        scores, desc = tmatch.superpoint_forward(model, img, cfg)
        assert scores.shape == (2, 64, 80)
        assert desc.shape == (2, 256, 8, 10)
        kpts, ks, d, valid = tmatch.extract_keypoints(scores, desc, cfg)
    assert kpts.shape == (2, 64, 2) and ks.shape == valid.shape == (2, 64)
    assert d.shape == (2, 64, 256)
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(), 1.0, atol=1e-4)


def test_lightglue_self_match_identity():
    """A keypoint set matched against itself gives the identity map."""
    cfg = tmatch.LightGlueConfig(n_layers=2, filter_threshold=0.0)
    model = tmatch.lightglue_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    K = 16
    kpts = _t(rng.uniform(0, 64, (1, K, 2)).astype(np.float32))
    desc = _t(rng.standard_normal((1, K, 256)).astype(np.float32))
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    mask = torch.ones((1, K), dtype=torch.bool)
    with torch.no_grad():
        matches, _ = tmatch.lightglue_match(model, kpts, desc, mask, kpts, desc, mask,
                                            (64, 64), cfg)
    assert (matches[0].numpy() == np.arange(K)).mean() > 0.9


def test_lightglue_respects_mask():
    cfg = tmatch.LightGlueConfig(n_layers=1, filter_threshold=0.0)
    model = tmatch.lightglue_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    K = 8
    kpts = _t(rng.uniform(0, 32, (1, K, 2)).astype(np.float32))
    desc = _t(rng.standard_normal((1, K, 256)).astype(np.float32))
    mask0 = torch.ones((1, K), dtype=torch.bool)
    mask0[0, 4:] = False
    mask1 = torch.ones((1, K), dtype=torch.bool)
    with torch.no_grad():
        matches, scores = tmatch.lightglue_match(model, kpts, desc, mask0, kpts, desc, mask1,
                                                 (32, 32), cfg)
    assert (matches[0].numpy()[4:] == -1).all() and (scores[0].numpy()[4:] == 0).all()


# --- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("name", ["superpoint", "lightglue"])
def test_initialisers_build_the_jax_trees(name):
    if name == "superpoint":
        want = state_dict_from_jax(random_jax_tree(jmatch.superpoint_init,
                                                   jmatch.SuperPointConfig()))
        model = tmatch.superpoint_init(generator=torch.Generator().manual_seed(1), device="cpu")
    else:
        want = state_dict_from_jax(random_jax_tree(jmatch.lightglue_init,
                                                   jmatch.LightGlueConfig()))
        model = tmatch.lightglue_init(generator=torch.Generator().manual_seed(1), device="cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("hw", [(64, 80), (48, 48)])
def test_superpoint_forward_matches_jax(superpoint, hw):
    tree, model = superpoint
    img = np.random.default_rng(4).uniform(0, 1, (2, 1) + hw).astype(np.float32)
    want_s, want_d = _j_sp(tree, jnp.asarray(img), jmatch.SuperPointConfig())
    with torch.no_grad():
        got_s, got_d = tmatch.superpoint_forward(model, _t(img))
    assert got_s.shape == want_s.shape and got_d.shape == want_d.shape
    assert _rel(got_s.numpy(), want_s) <= FWD_REL
    assert _rel(got_d.numpy(), want_d) <= FWD_REL


def _plateau_scores(B, H, W, seed):
    """Scores drawn from a few levels, most of them exactly 0: NMS keeps
    whole plateaus of equal maxima and top-k meets long runs of ties."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.0, 0.0, 0.0, 0.0, 0.25, 0.5, 0.5, 0.75], np.float32), (B, H, W))
    s[:, 8:12, 8:12] = 0.75  # a 4 x 4 plateau of the top level
    s[1] = 0.0
    s[1, 20, 30] = s[1, 3, 3] = 0.001  # above the detection threshold
    s[1, 5, 60] = 1e-4  # a kept maximum below it
    return s


@pytest.mark.parametrize("k", [16, 64, 600])
def test_extract_keypoints_matches_jax_on_ties(k):
    B, H, W = 2, 32, 64
    s = _plateau_scores(B, H, W, seed=k)
    d = np.random.default_rng(5).standard_normal((B, 24, H // 8, W // 8)).astype(np.float32)
    jcfg = jmatch.SuperPointConfig(max_num_keypoints=k)
    cfg = tmatch.SuperPointConfig(max_num_keypoints=k)
    want = _j_kp(jnp.asarray(s), jnp.asarray(d), jcfg)
    got = tmatch.extract_keypoints(_t(s), _t(d), cfg)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):  # kpts, scores, valid
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    # ties went lowest index first: zeros in raster order after the maxima
    zeros = got[1][0].numpy() == 0
    idx = (got[0][0, :, 1] * W + got[0][0, :, 0]).numpy()[zeros]
    assert (np.diff(idx) > 0).all()


def test_extract_keypoints_matches_jax_on_superpoint_scores(superpoint):
    tree, model = superpoint
    img = np.random.default_rng(6).uniform(0, 1, (2, 1, 64, 80)).astype(np.float32)
    scores, desc = _j_sp(tree, jnp.asarray(img), jmatch.SuperPointConfig())
    cfg = jmatch.SuperPointConfig(max_num_keypoints=256)
    want = _j_kp(scores, desc, cfg)
    got = tmatch.extract_keypoints(_t(scores), _t(desc),
                                   tmatch.SuperPointConfig(max_num_keypoints=256))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_lightglue_match_matches_jax(lightglue, masked):
    tree, model, jcfg, cfg = lightglue
    rng = np.random.default_rng(7)
    K = 48
    kpts0 = rng.uniform(0, 80, (2, K, 2)).astype(np.float32)
    kpts1 = (kpts0 + rng.normal(0, 2, kpts0.shape)).astype(np.float32)
    desc0 = rng.standard_normal((2, K, 256)).astype(np.float32)
    desc1 = (desc0 + 0.3 * rng.standard_normal(desc0.shape)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    m0, m1 = np.ones((2, K), bool), np.ones((2, K), bool)
    if masked:
        m0[0, 40:] = m1[1, 30:] = False
    want_m, want_s = _j_lg(tree, *map(jnp.asarray, (kpts0, desc0, m0, kpts1, desc1, m1)),
                           (64, 80), jcfg)
    with torch.no_grad():
        got_m, got_s = tmatch.lightglue_match(model, *map(_t, (kpts0, desc0, m0, kpts1,
                                                               desc1, m1)), (64, 80), cfg)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert (got_m.numpy() >= 0).sum() > K // 2  # the mutual rule kept real matches
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-7)
    # the threshold filters as in JAX
    hi = dataclasses.replace(cfg, filter_threshold=float(np.median(np.asarray(want_s)[
        np.asarray(want_m) >= 0])))
    with torch.no_grad():
        got_hi, _ = tmatch.lightglue_match(model, *map(_t, (kpts0, desc0, m0, kpts1, desc1,
                                                            m1)), (64, 80), hi)
    assert 0 < (got_hi.numpy() >= 0).sum() < (got_m.numpy() >= 0).sum()


def _magicleap_sd(rng):
    """superpoint_v1's keys and shapes (torch conv layout)."""
    chans = [(1, 64), (64, 64), (64, 64), (64, 64), (64, 128), (128, 128), (128, 128),
             (128, 128)]
    names = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
    sd = {}
    for n, (i, o) in zip(names, chans):
        sd[f"{n}.weight"] = rng.standard_normal((o, i, 3, 3)).astype(np.float32)
        sd[f"{n}.bias"] = rng.standard_normal(o).astype(np.float32)
    for n, (i, o, k) in {"convPa": (128, 256, 3), "convPb": (256, 65, 1),
                         "convDa": (128, 256, 3), "convDb": (256, 256, 1)}.items():
        sd[f"{n}.weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32)
        sd[f"{n}.bias"] = rng.standard_normal(o).astype(np.float32)
    return sd


def _lightglue_sd(rng, n_layers, d=256, heads=4):
    """The official superpoint_lightglue keys and shapes: every layer's
    log-assignment and token-confidence heads (the converter takes the
    last assignment only)."""
    def lin(sd, name, i, o, bias=True):
        sd[f"{name}.weight"] = rng.standard_normal((o, i)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32)

    sd = {}
    lin(sd, "input_proj", d, d)
    lin(sd, "posenc.Wr", 2, d // heads // 2, bias=False)
    for i in range(n_layers):
        p = f"transformers.{i}"
        lin(sd, f"{p}.self_attn.Wqkv", d, 3 * d)
        lin(sd, f"{p}.self_attn.out_proj", d, d)
        for blk in ("self_attn", "cross_attn"):
            lin(sd, f"{p}.{blk}.ffn.0", 2 * d, 2 * d)
            sd[f"{p}.{blk}.ffn.1.weight"] = rng.standard_normal(2 * d).astype(np.float32)
            sd[f"{p}.{blk}.ffn.1.bias"] = rng.standard_normal(2 * d).astype(np.float32)
            lin(sd, f"{p}.{blk}.ffn.3", 2 * d, d)
        for name in ("to_qk", "to_v", "to_out"):
            lin(sd, f"{p}.cross_attn.{name}", d, d)
        lin(sd, f"log_assignment.{i}.matchability", d, 1)
        lin(sd, f"log_assignment.{i}.final_proj", d, d)
        lin(sd, f"token_confidence.{i}.token.0", d, 1)
    return sd


def test_convert_superpoint_matches_jax_key_for_key():
    sd = _magicleap_sd(np.random.default_rng(8))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmatch.convert_superpoint(sd)))
    got = tmatch.convert_superpoint(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    model = tmatch.SuperPoint()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)


@pytest.mark.parametrize("n_layers", [2, 9])
def test_convert_lightglue_matches_jax_key_for_key(n_layers):
    sd = _lightglue_sd(np.random.default_rng(9), n_layers)
    jcfg = jmatch.LightGlueConfig(n_layers=n_layers)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jmatch.convert_lightglue(sd, jcfg)))
    cfg = tmatch.LightGlueConfig(n_layers=n_layers)
    got = tmatch.convert_lightglue(sd, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    np.testing.assert_array_equal(got["matchability.weight"],
                                  sd[f"log_assignment.{n_layers - 1}.matchability.weight"])
    model = tmatch.LightGlue(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
