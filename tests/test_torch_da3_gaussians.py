"""The port's Gaussian branch and splatting renderer
(``videogpa_torch/models/da3/{gaussians,gs_render}.py``) against the JAX
package's on the CPU in f32: ``gaussian_adapter``, GSDPT on the tiny DA3's
trunk features, ``save_gs_ply``, ``render_3dgs`` (a random scene with more
gaussians a tile than its budget, and gaussians that share one depth, where
the pick among equals follows ``lax.top_k``'s lowest-index-first order), its
gradient, and the trajectory helpers. Mirrors ``tests/test_da3.py``'s
``TestGaussianBranch``, ``TestGSRenderer`` and ``TestGSRendererGrad``.
Limits: 1e-5 relative norm; the PLY's header equal, its floats within 1e-6
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videogpa_tpu.models.da3 import DA3Config as JaxDA3Config
from videogpa_tpu.models.da3 import gaussians as jgs
from videogpa_tpu.models.da3 import gs_render as jrender
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.da3 import DA3Config
from videogpa_torch.models.da3 import gaussians as tgs
from videogpa_torch.models.da3 import gs_render as trender
from test_torch_bridge import random_jax_tree

torch.set_num_threads(2)
REL = 1e-5
# the JAX functions jitted: their eager first calls take seconds each
_FIELDS = ("means", "harmonics", "opacities", "scales", "rotations")
_j_adapter_fields = jax.jit(
    lambda *a, **kw: tuple(getattr(jgs.gaussian_adapter(*a, **kw), k) for k in _FIELDS),
    static_argnums=(5,), static_argnames=("sh_degree",))


def _j_adapter(*args, **kw):
    return jgs.Gaussians(*_j_adapter_fields(*args, **kw))
_j_gsdpt = jax.jit(jgs.gsdpt_forward, static_argnums=(3,))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cameras(B, V, H, W, seed):
    rng = np.random.default_rng(seed)
    E = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    for b in range(B):
        for v in range(V):
            q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            E[b, v, :3, :3] = q * np.sign(np.linalg.det(q))
            E[b, v, :3, 3] = rng.normal(size=3) * 0.3
    K = np.tile(np.array([[1.2 * W, 0, W / 2], [0, 1.1 * H, H / 2], [0, 0, 1]], np.float32),
                (B, V, 1, 1))
    return E, K


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_gaussian_adapter_matches_jax(sh_degree):
    B, V, H, W = 1, 2, 6, 8
    rng = np.random.default_rng(0)
    E, K = _cameras(B, V, H, W, seed=1)
    depths = rng.uniform(1, 4, (B, V, H, W)).astype(np.float32)
    opac = rng.uniform(0, 1, (B, V, H, W)).astype(np.float32)
    raw = rng.normal(size=(B, V, H, W, tgs.gs_raw_dim(sh_degree))).astype(np.float32)
    want = _j_adapter(*map(jnp.asarray, (E, K, depths, opac, raw)), (H, W),
                      sh_degree=sh_degree)
    got = tgs.gaussian_adapter(*map(_t, (E, K, depths, opac, raw)), (H, W), sh_degree=sh_degree)
    for k in _FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape, k
        assert _rel(g.numpy(), w) <= REL, (k, _rel(g.numpy(), w))
    # identity cameras and no offsets: the means' z is the depth
    Ei = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    g = tgs.gaussian_adapter(_t(Ei), _t(K), _t(depths), _t(opac), torch.zeros_like(_t(raw)),
                             (H, W), sh_degree=sh_degree)
    np.testing.assert_allclose(g.means[0, :, 2].reshape(V, H, W).numpy(), depths[0], rtol=1e-6)


def test_gsdpt_matches_jax_and_writes_the_jax_ply(tmp_path):
    """GSDPT on trunk features at the tiny DA3's shapes, the adapter on its
    output, and the 3DGS PLY both packages write from it."""
    jcfg, cfg = JaxDA3Config.tiny(), DA3Config.tiny()
    want_sd = state_dict_from_jax(random_jax_tree(jgs.gsdpt_init, jcfg))
    built = tgs.gsdpt_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in built.state_dict().items()} == {
        k: tuple(v.shape) for k, v in want_sd.items()}

    gs_tree = random_jax_tree(jgs.gsdpt_init, jcfg, seed=3)
    head = load_jax_params(tgs.GSDPT(cfg), gs_tree).eval()
    B, V, S = 1, 2, cfg.img_size
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (B, V, 3, S, S)).astype(np.float32)
    P = (S // cfg.patch_size) ** 2  # the trunk's tokens without the cls slot
    feats = [(jnp.asarray(rng.standard_normal((B, V, P, cfg.tokens_dim)), jnp.float32),
              jnp.asarray(rng.standard_normal((B, V, cfg.tokens_dim)), jnp.float32))
             for _ in range(4)]
    want_raw, want_opac = _j_gsdpt(gs_tree, feats, jnp.asarray(imgs), jcfg)
    with torch.no_grad():
        raw, opac = tgs.gsdpt_forward(head, [(_t(t), _t(c)) for t, c in feats], _t(imgs))
    assert raw.shape == (B, V, S, S, tgs.gs_raw_dim(0)) and opac.shape == (B, V, S, S)
    assert _rel(raw.numpy(), want_raw) <= REL and _rel(opac.numpy(), want_opac) <= REL

    E, K = _cameras(B, V, S, S, seed=5)
    depths = np.full((B, V, S, S), 2.0, np.float32)
    g = tgs.gaussian_adapter(_t(E), _t(K), _t(depths), opac, raw, (S, S))
    jg = _j_adapter(jnp.asarray(E), jnp.asarray(K), jnp.asarray(depths), want_opac,
                    want_raw, (S, S))
    tgs.save_gs_ply(g, str(tmp_path / "port.ply"))
    jgs.save_gs_ply(jg, str(tmp_path / "jax.ply"))
    got_b, want_b = (tmp_path / "port.ply").read_bytes(), (tmp_path / "jax.ply").read_bytes()
    end = b"end_header\n"
    h = got_b.index(end) + len(end)
    assert got_b[:h] == want_b[:h] and len(got_b) == len(want_b)
    assert b"f_dc_0" in got_b[:h] and b"rot_3" in got_b[:h]
    ga, wa = np.frombuffer(got_b[h:], "<f4"), np.frombuffer(want_b[h:], "<f4")
    np.testing.assert_allclose(ga, wa, rtol=1e-6, atol=1e-6)


def _scene(N, seed, z=None):
    """N gaussians in front of an identity camera; ``z`` fixes every depth."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.45, 0.45, N),
                      rng.uniform(1.5, 3.0, N) if z is None else np.full(N, z)], -1)
    quats = rng.normal(size=(N, 4))
    return dict(means=means[None].astype(np.float32),
                harmonics=rng.normal(size=(1, N, 3, 1)).astype(np.float32),
                opacities=rng.uniform(0.3, 0.95, (1, N)).astype(np.float32),
                scales=rng.uniform(0.02, 0.08, (1, N, 3)).astype(np.float32),
                rotations=(quats / np.linalg.norm(quats, axis=-1, keepdims=True))[None]
                .astype(np.float32))


def _views(V, W, H, seed):
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    extr[:, :3, 3] = rng.normal(size=(V, 3)) * 0.05
    intr = np.tile(np.array([[60.0 / W, 0, 0.5], [0, 60.0 / H, 0.5], [0, 0, 1]], np.float32),
                   (V, 1, 1))
    return extr, intr


@pytest.mark.parametrize("case", ["random", "tied_depth"])
def test_render_3dgs_matches_jax(case):
    """More live gaussians a tile than its budget (8), so the pick decides
    the image: at random depths, and with every gaussian at one depth, where
    ``lax.top_k`` takes equal depths lowest index first."""
    W, H, V = 40, 24, 2
    g = _scene(160, seed=6, z=2.0 if case == "tied_depth" else None)
    extr, intr = _views(V, W, H, seed=7)
    bg = np.random.default_rng(8).uniform(0, 1, (V, 3)).astype(np.float32)
    want = jrender.render_3dgs(jnp.asarray(extr), jnp.asarray(intr), (H, W),
                               jgs.Gaussians(**{k: jnp.asarray(v) for k, v in g.items()}),
                               background_color=jnp.asarray(bg), max_per_tile=8)
    got = trender.render_3dgs(extr, intr, (H, W), tgs.Gaussians(**g), background_color=bg,
                              max_per_tile=8, device="cpu")
    for gt, w in zip(got, want):
        assert gt.shape == w.shape
        assert _rel(gt.numpy(), w) <= REL, _rel(gt.numpy(), w)
    if case == "tied_depth":  # a pick by another order among equals renders another image
        order = np.random.default_rng(9).permutation(160)
        shuffled = tgs.Gaussians(**{k: v[:, order] for k, v in g.items()})
        other = trender.render_3dgs(extr, intr, (H, W), shuffled, background_color=bg,
                                    max_per_tile=8, device="cpu")
        assert _rel(other[0].numpy(), want[0]) > 1e-3


def test_occlusion_and_grad_match_jax():
    """A near gaussian occludes a far one in either array order, and the
    gradient of an image loss w.r.t. the means agrees with JAX's."""
    W, H = 32, 32
    extr = np.eye(4, dtype=np.float32)[None]
    intr = np.array([[[30.0 / W, 0, 0.5], [0, 30.0 / H, 0.5], [0, 0, 1]]], np.float32)
    sh = (np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32) - 0.5) / trender._SH_C0
    for order in ([0, 1], [1, 0]):
        g = tgs.Gaussians(means=np.array([[[0, 0, 1.5], [0, 0, 3.0]]], np.float32)[:, order],
                          harmonics=sh.reshape(1, 2, 3, 1)[:, order],
                          opacities=np.full((1, 2), 0.99, np.float32),
                          scales=np.full((1, 2, 3), 0.08, np.float32),
                          rotations=np.tile(np.array([1.0, 0, 0, 0], np.float32), (1, 2, 1)))
        c = trender.render_3dgs(extr, intr, (H, W), g, device="cpu")[0][0, :, 16, 16]
        assert c[0] > 0.8 and c[1] < 0.15

    def fields(lib, means):
        return dict(means=means, harmonics=lib.full((1, 1, 3, 1), 0.5 / trender._SH_C0),
                    opacities=lib.full((1, 1), 0.9), scales=lib.full((1, 1, 3), 0.05),
                    rotations=lib.asarray([[[1.0, 0, 0, 0]]]))

    m0 = np.array([[[0.05, -0.03, 2.0]]], np.float32)

    def jloss(means):
        color, _ = jrender.render_3dgs(jnp.asarray(extr), jnp.asarray(intr), (H, W),
                                       jgs.Gaussians(**fields(jnp, means)), max_per_tile=1)
        return jnp.sum(color ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(m0)))
    means = torch.tensor(m0, requires_grad=True)
    color, _ = trender.render_3dgs(extr, intr, (H, W), tgs.Gaussians(**fields(torch, means)),
                                   max_per_tile=1, device="cpu")
    (color ** 2).sum().backward()
    assert np.abs(want).max() > 0
    assert _rel(means.grad.numpy(), want) <= 1e-4


def _rotation(rng, angle):
    a = rng.normal(size=3)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / np.linalg.norm(a)
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def test_trajectory_helpers_match_jax():
    """Poses a few degrees apart (the JAX package's smoothing writes into a
    read-only array when a quaternion has to be flipped, so the comparison
    stays in one hemisphere); then the port alone on poses whose
    quaternions flip: the smoothed rotations stay orthonormal."""
    rng = np.random.default_rng(10)
    V = 4  # as run_renderer_chunked's test: the JAX helpers' eager operations compile once
    c2ws = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for i in range(V):
        c2ws[i, :3, :3] = _rotation(rng, 0.1)
    c2ws[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (V, 3)), 0)
    t = np.linspace(0, 1, 5, dtype=np.float32)
    intr = np.array([[1.1, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32)
    pairs = [
        (trender.render_stabilization_path(c2ws, k_size=5),
         jrender.render_stabilization_path(c2ws, k_size=5)),
        (trender.interpolate_extrinsics(c2ws[0], c2ws[1], t),
         jrender.interpolate_extrinsics(c2ws[0], c2ws[1], t)),
        (trender.interpolate_intrinsics(intr, 2 * intr, t),
         jrender.interpolate_intrinsics(intr, 2 * intr, t)),
        *zip(trender.render_wander_path(c2ws[0], intr, 32, 48),
             jrender.render_wander_path(c2ws[0], intr, 32, 48)),
        *zip(trender.render_dolly_zoom_path(c2ws[0], intr, 32, 48),
             jrender.render_dolly_zoom_path(c2ws[0], intr, 32, 48)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-5)

    for i in range(V):
        c2ws[i, :3, :3] = _rotation(rng, 3.0)
    sm = trender.render_stabilization_path(c2ws, k_size=5)
    RtR = np.einsum("vij,vik->vjk", sm[:, :3, :3], sm[:, :3, :3])
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (V, 1, 1)), atol=1e-5)


def test_run_renderer_chunked_modes_match_jax():
    W, H, V = 16, 16, 4
    g = _scene(24, seed=11)
    extr = np.tile(np.eye(4, dtype=np.float32)[:3], (V, 1, 1))
    extr[:, 0, 3] = 0.02 * np.arange(V)
    intr = np.tile(np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32),
                   (V, 1, 1))
    jg = jgs.Gaussians(**{k: jnp.asarray(v) for k, v in g.items()})
    for mode, n in [("original", V), ("smooth", V), ("interpolate", (V - 1) * 8 - (V - 2)),
                    ("wander", 60), ("dolly_zoom", 60)]:
        color, depth = trender.run_renderer_chunked(tgs.Gaussians(**g), extr, intr, (H, W),
                                                    trj_mode=mode, chunk_size=30,
                                                    max_per_tile=16, device="cpu")
        assert color.shape == (n, 3, H, W) and depth.shape == (n, H, W), mode
        assert np.isfinite(color).all()
        if mode in ("original", "smooth"):
            want, _ = jrender.run_renderer_chunked(jg, extr, intr, (H, W), trj_mode=mode,
                                                   chunk_size=30, max_per_tile=16)
            assert _rel(color, want) <= REL, mode
    with pytest.raises(ValueError, match="trj_mode"):
        trender.run_renderer_chunked(tgs.Gaussians(**g), extr, intr, (H, W), trj_mode="orbit",
                                     device="cpu")
