"""The port's DA3 (``videogpa_torch/models/da3``) against the JAX package's on
the CPU in f32: reference-view selection, the view reorder, the pos-embed
interpolation, the AA-ViT, DualDPT, the camera encoder and decoder, the
whole forward with and without GT cameras, and ``da3_inference`` with GT
alignment. Weights: a tree shaped as JAX's ``da3_init`` gives it
(``random_jax_tree``), carried into the port by the bridge; inputs made with
numpy. Mirrors ``tests/test_da3.py`` and ``tests/test_da3_parity.py``'s
AA-ViT cases (S = 4 with selection, S = 2 without, a user camera token, the
middle strategy, a non-square grid)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import heads as jheads
from videogpa_tpu.models.da3 import model as jmodel
from videogpa_tpu.models.da3 import vit as jvit
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.da3 import DA3, DA3Config, da3_forward, da3_inference, da3_init
from videogpa_torch.models.da3 import heads as theads
from videogpa_torch.models.da3 import vit as tvit
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
# f32 on both sides: summation-order noise, ~1e-7 relative a layer; the
# heads' exp() doubles relative errors. Rel-norm limits: 1e-5 for a part,
# 1e-4 for the whole forward (the acceptance limit of the port's DA3)
PART_REL, FWD_REL = 1e-5, 1e-4
# the JAX functions jitted: a compile takes ~2 s, the first eager call ~10
_j_aavit = jax.jit(jvit.aavit_forward, static_argnums=(2,), static_argnames=("attn_impl",))
_j_dualdpt = jax.jit(jheads.dualdpt_forward, static_argnums=(2, 3))
_j_cam_enc = jax.jit(jheads.camera_enc_forward, static_argnums=(3,),
                     static_argnames=("attn_impl",))
_j_da3 = jax.jit(jmodel.da3_forward, static_argnums=(2,),
                 static_argnames=("attn_impl", "return_features"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _tree(cfg: JaxDA3Config, seed=0):
    """A ``da3_init`` tree with the camera decoder's fov bias shifted by +1 rad:
    its ReLU can emit fov 0 (infinite focal length) on random weights."""
    tree = random_jax_tree(jmodel.da3_init, cfg, seed=seed)
    tree["cam_dec"]["fc_fov"]["bias"] += 1.0
    return tree


@pytest.fixture(scope="module")
def tiny():
    tree = _tree(JaxDA3Config.tiny())
    return tree, load_jax_params(DA3(DA3Config.tiny()), tree).eval()


@pytest.mark.parametrize("name", ["aavit", "dualdpt", "camera_dec", "camera_enc", "da3"])
def test_initialisers_build_the_jax_trees(name):
    """Each ``*_init`` gives a module whose state names and shapes are the
    bridge's image of the JAX initialiser's tree; ``da3_init`` keeps the
    heads f32 under a bf16 backbone."""
    jcfg, cfg = JaxDA3Config.tiny(), DA3Config.tiny()
    jinit, jargs, init, args = {
        "aavit": (jvit.aavit_init, (jcfg,), tvit.aavit_init, (cfg,)),
        "dualdpt": (jheads.dualdpt_init, (jcfg,), theads.dualdpt_init, (cfg,)),
        "camera_dec": (jheads.camera_dec_init, (64,), theads.camera_dec_init, (64,)),
        "camera_enc": (jheads.camera_enc_init, (32,), theads.camera_enc_init, (32,)),
        "da3": (jmodel.da3_init, (jcfg,), da3_init, (cfg,)),
    }[name]
    want = state_dict_from_jax(random_jax_tree(jinit, *jargs))
    model = init(*args, generator=torch.Generator().manual_seed(1), device="cpu",
                 dtype=torch.bfloat16)
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert not any(p.requires_grad for p in model.parameters())
    if name == "da3":
        assert model.backbone.pos_embed.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for part in (model.head, model.cam_dec,
                                                         model.cam_enc)
                   for p in part.parameters())


@pytest.mark.parametrize("strategy", ["first", "middle", "saddle_balanced",
                                      "saddle_sim_range"])
def test_select_reference_view_matches_jax(strategy):
    x = np.random.default_rng(0).standard_normal((3, 5, 7, 16)).astype(np.float32)
    want = np.asarray(jvit.select_reference_view(jnp.asarray(x), strategy))
    got = tvit.select_reference_view(_t(x), strategy).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown ref_view_strategy"):
        tvit.select_reference_view(_t(x), "best")


def test_reorder_perm_matches_jax():
    idx = np.array([2, 0, 4])
    want = np.asarray(jvit._reorder_perm(jnp.asarray(idx), 5))
    got = tvit._reorder_perm(_t(idx), 5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [2, 0, 1, 3, 4])
    inv = torch.argsort(_t(got), dim=1).numpy()
    np.testing.assert_array_equal(np.take_along_axis(got, inv, 1), np.tile(np.arange(5), (3, 1)))


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (6, 2)])
def test_interp_pos_matches_jax(grid):
    """The non-antialiased bicubic with DA3's (g + 0.1) / M scale, at grids
    other than the checkpoint's 4 x 4 (4 x 4 is the identity)."""
    pe = np.random.default_rng(1).standard_normal((1, 17, 8)).astype(np.float32)
    want = jvit._interp_pos(jnp.asarray(pe), *grid)
    got = tvit._interp_pos(_t(pe), *grid)
    assert got.shape == (1, 1 + grid[0] * grid[1], 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _compare_aavit(jcfg, tree_bb, S, H, W, cam_token=None, seed=2):
    cfg = DA3Config(**dataclasses.asdict(jcfg))
    model = load_jax_params(tvit.AAViT(cfg), tree_bb).eval()
    x = np.random.default_rng(seed).standard_normal((2, S, 3, H, W)).astype(np.float32)
    ct = None if cam_token is None else jnp.asarray(cam_token)
    want = _j_aavit(tree_bb, jnp.asarray(x), jcfg, cam_token=ct, attn_impl="xla")
    with torch.no_grad():
        got = tvit.aavit_forward(model, _t(x),
                                 cam_token=None if cam_token is None else _t(cam_token))
    assert len(got) == len(want) == len(cfg.out_layers)
    for (tok_g, cam_g), (tok_w, cam_w) in zip(got, want):
        assert tok_g.shape == tok_w.shape and cam_g.shape == cam_w.shape
        assert _rel(tok_g.numpy(), tok_w) <= PART_REL
        assert _rel(cam_g.numpy(), cam_w) <= PART_REL


@pytest.mark.parametrize("case", ["S4_selection", "S2_no_selection", "user_cam_token",
                                  "middle_non_square"])
def test_aavit_forward_matches_jax(tiny, case):
    tree, _ = tiny
    jcfg = JaxDA3Config.tiny()
    if case == "S4_selection":
        _compare_aavit(jcfg, tree["backbone"], S=4, H=56, W=56)
    elif case == "S2_no_selection":
        _compare_aavit(jcfg, tree["backbone"], S=2, H=56, W=56)
    elif case == "user_cam_token":
        ct = np.random.default_rng(7).standard_normal((2, 5, 32)).astype(np.float32)
        _compare_aavit(jcfg, tree["backbone"], S=5, H=56, W=56, cam_token=ct)
    else:  # a deterministic non-zero reference at a grid of its own
        jcfg = dataclasses.replace(jcfg, ref_view_strategy="middle")
        _compare_aavit(jcfg, tree["backbone"], S=4, H=42, W=70)


def test_heads_match_jax(tiny):
    """DualDPT (raw-x residual fusion, exp / 1 + exp, the aux LayerNorm),
    CameraDec and CameraEnc on the same inputs."""
    tree, model = tiny
    cfg = JaxDA3Config.tiny()
    rng = np.random.default_rng(3)
    B, S, P = 1, 3, (cfg.img_size // cfg.patch_size) ** 2
    feats = [(rng.standard_normal((B, S, P, cfg.tokens_dim)).astype(np.float32),
              rng.standard_normal((B, S, cfg.tokens_dim)).astype(np.float32))
             for _ in range(4)]
    want = _j_dualdpt(tree["head"], [tuple(map(jnp.asarray, f)) for f in feats], cfg,
                      (56, 56))
    with torch.no_grad():
        got = theads.dualdpt_forward(model.head, [tuple(map(_t, f)) for f in feats], (56, 56))
    for k in ("depth", "depth_conf", "ray", "ray_conf"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= PART_REL, k

    want_dec = jheads.camera_dec_forward(tree["cam_dec"], jnp.asarray(feats[-1][1]))
    with torch.no_grad():
        got_dec = theads.camera_dec_forward(model.cam_dec, _t(feats[-1][1]))
    assert _rel(got_dec.numpy(), want_dec) <= PART_REL

    ext, ixt = _gt_cameras(S, seed=4)
    want_enc = _j_cam_enc(tree["cam_enc"], jnp.asarray(ext[None]), jnp.asarray(ixt[None]),
                          (56, 56), attn_impl="xla")
    with torch.no_grad():
        got_enc = theads.camera_enc_forward(model.cam_enc, _t(ext[None]), _t(ixt[None]),
                                            (56, 56))
    assert got_enc.shape == (1, S, cfg.embed_dim)
    assert _rel(got_enc.numpy(), want_enc) <= PART_REL


def _gt_cameras(S, seed):
    """S world->camera (3, 4) extrinsics (rotations about a random axis, a
    translation) and pinhole intrinsics at 56^2."""
    rng = np.random.default_rng(seed)
    ext = np.zeros((S, 3, 4), np.float32)
    for s in range(S):
        a = rng.normal(size=3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) * 0.3
        ext[s, :, :3] = np.eye(3) + np.sin(1.0) * K + (1 - np.cos(1.0)) * K @ K
        ext[s, :, :3] = np.linalg.qr(ext[s, :, :3])[0]
        ext[s, :, 3] = rng.normal(size=3)
    ixt = np.tile(np.array([[50.0, 0, 28], [0, 50.0, 28], [0, 0, 1]], np.float32), (S, 1, 1))
    return ext, ixt


@pytest.mark.parametrize("gt_cameras", [False, True], ids=["learned_token", "gt_cameras"])
def test_da3_forward_matches_jax(tiny, gt_cameras):
    tree, model = tiny
    S = 4
    x = np.random.default_rng(5).standard_normal((2, S, 3, 56, 56)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if gt_cameras:
        ext, ixt = _gt_cameras(S, seed=6)
        ext, ixt = np.stack([ext, ext[::-1]]), np.stack([ixt, ixt])
        kw_j = {"gt_extrinsics": jnp.asarray(ext), "gt_intrinsics": jnp.asarray(ixt)}
        kw_t = {"gt_extrinsics": _t(ext), "gt_intrinsics": _t(ixt)}
    want = _j_da3(tree, jnp.asarray(x), JaxDA3Config.tiny(), attn_impl="xla",
                  return_features=True, **kw_j)
    with torch.no_grad():
        got = da3_forward(model, _t(x), return_features=True, **kw_t)
    assert set(got) == set(want)
    for k in ("depth", "depth_conf", "ray", "ray_conf", "extrinsics", "intrinsics",
              "pose_enc", "features"):
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k].numpy()).all(), k
        assert _rel(got[k].numpy(), want[k]) <= FWD_REL, (k, _rel(got[k].numpy(), want[k]))
    if gt_cameras:  # the camera tokens change the predicted cameras
        with torch.no_grad():
            plain = da3_forward(model, _t(x))
        assert _rel(plain["pose_enc"].numpy(), got["pose_enc"].numpy()) > 1e-3


@pytest.mark.parametrize("S", [4, 10], ids=["umeyama", "ransac"])
def test_da3_inference_with_gt_alignment_matches_jax(tiny, S):
    """``da3_inference`` on uint8 frames, the trajectory aligned to GT
    extrinsics by Umeyama Sim(3) (RANSAC from 10 views) and the depth scaled."""
    tree, model = tiny
    frames = np.random.default_rng(8).integers(0, 256, (S, 56, 56, 3), dtype=np.uint8)
    gt = _gt_cameras(S, seed=9)[0]
    want = jmodel.da3_inference(tree, frames, JaxDA3Config.tiny(), attn_impl="xla",
                                compute_dtype=jnp.float32, gt_extrinsics=gt,
                                return_features=True)
    got = da3_inference(model, frames, compute_dtype=torch.float32, gt_extrinsics=gt,
                        return_features=True)
    for k in ("depth", "conf", "extrinsics", "intrinsics", "processed_images", "features"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert _rel(g, w) <= FWD_REL, (k, _rel(g, w))
