"""The port's ring attention against the JAX package's
(``videogpa_tpu/ops/ring_attention.py``): the per-shard pieces in this
process, and the ring itself in 4 ``gloo`` ranks (spawned once for the file,
``test_torch_dist_cases.ring_cases``) against JAX's ``ring_attention_sharded`` on
a 4-device CPU mesh, at JAX's own tolerances (2e-5 forward, 5e-4 grads).
Inputs are seeded numpy, f32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_cases as cases
from videogpa_torch.checkpoint import save_pytree
from videogpa_torch.ops import ring_attention as tring
from videogpa_torch.ops.attention import attention
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxCogConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.cogvideox.dit import dit_forward as jax_dit_forward
from videogpa_tpu.ops import attention as jattn
from videogpa_tpu.ops import ring_attention as jring
from videogpa_tpu.ops.attention import mha_reference
from videogpa_tpu.parallel import MeshAxes, make_mesh

torch.set_num_threads(2)
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the per-shard pieces, in this process
# ---------------------------------------------------------------------------

def _bnhd(x):
    return np.ascontiguousarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("case", ["no_mask_bhnd", "no_mask_bnhd", "mask", "all_masked"])
def test_attn_with_lse_matches_jax(case):
    q, k, v = (_rnd(s, (2, 3, 40 if i == 0 else 56, 16)) for i, s in enumerate((1, 2, 3)))
    mask = {"mask": _rnd(4, (56,)) > 0, "all_masked": np.zeros(56, bool)}.get(case)
    want_o, want_lse = jring._attn_with_lse_xla(
        *map(jnp.asarray, (q, k, v)), None if mask is None else jnp.asarray(mask))
    if case == "no_mask_bnhd":
        o, lse = tring._attn_with_lse(*(_t(_bnhd(x)) for x in (q, k, v)), layout="bnhd")
        o = o.transpose(1, 2)
    else:
        o, lse = tring._attn_with_lse(_t(q), _t(k), _t(v),
                                      None if mask is None else _t(mask))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=FWD_TOL, rtol=1e-6)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_merge_matches_jax(layout):
    o, o_i = _rnd(5, (2, 3, 40, 16)), _rnd(6, (2, 3, 40, 16))
    lse, lse_i = _rnd(7, (2, 3, 40), 3.0), _rnd(8, (2, 3, 40), 3.0)
    lse_i[0, 0, :5] = jring._EMPTY_LSE  # an empty shard's rows
    want_o, want_lse = jring._merge(*map(jnp.asarray, (o, lse, o_i, lse_i)))
    if layout == "bnhd":
        got_o, got_lse = tring._merge(_t(_bnhd(o)), _t(lse), _t(_bnhd(o_i)), _t(lse_i), "bnhd")
        got_o = got_o.transpose(1, 2)
    else:
        got_o, got_lse = tring._merge(_t(o), _t(lse), _t(o_i), _t(lse_i))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_bwd_step_matches_jax(masked):
    """One (query shard, key shard) pair's gradients, P from the global LSE
    and delta from the merged O of attention over two key shards."""
    q, g = _rnd(9, (1, 2, 48, 16)), _rnd(10, (1, 2, 48, 16))
    k, v = _rnd(11, (1, 2, 64, 16)), _rnd(12, (1, 2, 64, 16))
    mask = (_rnd(13, (32,)) > 0) if masked else np.ones(32, bool)
    full = np.concatenate([mask, np.ones(32, bool)])
    o, lse = jring._attn_with_lse_xla(*map(jnp.asarray, (q, k, v)), jnp.asarray(full))
    delta = jnp.sum(o * jnp.asarray(g), axis=-1)
    want = jring._bwd_step_xla(jnp.asarray(q), jnp.asarray(k[:, :, :32]),
                               jnp.asarray(v[:, :, :32]), jnp.asarray(mask, jnp.float32),
                               jnp.asarray(g), lse, delta, masked)
    got = tring._bwd_step(_t(q), _t(k[:, :, :32]), _t(v[:, :, :32]), _t(o), _t(lse), _t(g),
                          _t(mask) if masked else None)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n_valid, shard", [(300, 75), (5, 2), (17778 - 2, 5926)])
def test_shard_validity_matches_jax(n_valid, shard):
    assert tring._shard_validity(n_valid, shard) == jring._shard_validity(n_valid, shard)
    full, partial = tring._shard_validity(n_valid, shard)
    n = -(-n_valid // shard)
    keys = [tring._resident_keys(r, shard, (full, partial)) for r in range(n + 1)]
    assert sum(keys) == n_valid and keys[-1] == 0


def test_ring_impl_without_mesh_raises():
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="mesh"):
        attention(q, q, q, impl="ring")
    with pytest.raises(ValueError):
        tring.ring_attention(q, q, q, None, kv_mask=torch.ones(64), n_valid=60)


# ---------------------------------------------------------------------------
# the ring, in 4 gloo ranks
# ---------------------------------------------------------------------------

# name -> (seed, (B, H, N, D), port mesh, JAX mesh axes, JAX impl, layout)
_ATTN = {
    "seq4_n128": (0, (1, 2, 128, 32), "seq4", MeshAxes(seq=4), "xla", "bhnd"),
    "p1_n64": (1, (1, 2, 64, 16), "dp4", MeshAxes(data=4), "xla", "bhnd"),
    "grads_n96": (4, (1, 2, 96, 16), "seq4", MeshAxes(seq=4), "xla", "bhnd"),
    "ragged_n70": (5, (1, 2, 70, 16), "seq4", MeshAxes(seq=4), "xla", "bhnd"),
    "two_rings_n71_bnhd": (6, (1, 3, 71, 16), "dp2_seq2", MeshAxes(data=2, seq=2), "xla",
                           "bnhd"),
    "flash_n300": (7, (1, 2, 300, 64), "seq4", MeshAxes(seq=4), "flash", "bhnd"),
    "flash_n5": (8, (1, 2, 5, 64), "seq4", MeshAxes(seq=4), "flash", "bhnd"),
}


def _qkv(seed, shape):
    return tuple(_rnd(seed * 10 + i, shape) for i in range(3))


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Every rank's results of ``ring_cases`` on the inputs below."""
    workdir = str(tmp_path_factory.mktemp("ring"))
    attn = {}
    for name, (seed, shape, mesh, _, _, layout) in _ATTN.items():
        q, k, v = _qkv(seed, shape)
        if layout == "bnhd":
            q, k, v = map(_bnhd, (q, k, v))
        attn[name] = {"q": q, "k": k, "v": v, "layout": np.array(layout),
                      "mesh": np.array(mesh)}
    q, k, v = _qkv(9, (1, 2, 64, 16))
    masked = {"q": q, "k": k, "v": v, "g": _rnd(99, (1, 2, 64, 16)),
              "mask": (_rnd(98, (64,)) > -0.3).astype(np.float32)}
    cfg = JaxCogConfig.tiny()
    rng = np.random.default_rng(3)
    dit = {"params": jax.tree.map(np.asarray, jax_dit_init(jax.random.PRNGKey(0), cfg)),
           "x": rng.standard_normal((1, cfg.sample_frames, cfg.in_channels, cfg.sample_height,
                                     cfg.sample_width)).astype(np.float32),
           "txt": rng.standard_normal((1, cfg.max_text_seq_length,
                                       cfg.text_embed_dim)).astype(np.float32),
           "t": np.array([500])}
    cross = {"q": _rnd(90, (1, 2, 70, 16)), "k": _rnd(91, (1, 2, 13, 16)),
             "v": _rnd(92, (1, 2, 13, 16))}
    save_pytree({"attention": attn, "masked": masked, "dit": dit, "cross": cross},
                f"{workdir}/ring.npz")
    ranks = cases.Ranks("ring_cases", workdir)
    for name in _ATTN:  # JAX's references, computed while the ranks run
        _jax_ring(name)
    return {"runs": ranks.results(), "dit": dit, "masked": masked, "cross": cross}


@functools.lru_cache(maxsize=None)
def _jax_ring(name):
    """JAX's ring_attention_sharded on the case's 4-device CPU mesh, jitted:
    O and the gradients of sum(O^2), in (B, H, N, D)."""
    seed, shape, _, axes, impl, _ = _ATTN[name]
    mesh = make_mesh(axes, devices=jax.devices()[:4])
    q, k, v = map(jnp.asarray, _qkv(seed, shape))

    def loss(q, k, v):
        o = jring.ring_attention_sharded(q, k, v, mesh, impl=impl)
        return jnp.sum(o * o), o

    attn_interpret = jattn.INTERPRET
    jattn.INTERPRET = True  # the Pallas kernels of impl="flash", interpreted on the CPU
    try:
        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
    finally:
        jattn.INTERPRET = attn_interpret
    return np.asarray(o), [np.asarray(g) for g in grads]


def _rank_result(ring_runs, name):
    """Rank 0's result of a case; every rank returns the same whole tensors."""
    runs = ring_runs["runs"]
    for r in runs[1:]:
        for key in runs[0][name]:
            np.testing.assert_array_equal(r[name][key], runs[0][name][key])
    res = runs[0][name]
    if _ATTN.get(name, (None,) * 6)[5] == "bnhd":
        res = {k: np.swapaxes(x, 1, 2) for k, x in res.items()}
    return res


@pytest.mark.parametrize("name", list(_ATTN))
def test_ring_forward_matches_jax(ring_runs, name):
    """TestRingAttention / TestRingFlashRagged / TestRingRaggedAndDiT's
    forwards: divisible N, P = 1, ragged N (n = 5 over 4 shards: full,
    full, partial(1), empty), two rings of 2 side by side in bnhd."""
    got = _rank_result(ring_runs, name)
    want, _ = _jax_ring(name)
    np.testing.assert_allclose(got["o"], want, atol=FWD_TOL, rtol=FWD_TOL)
    seed, shape, *_ = _ATTN[name]
    ref = np.asarray(mha_reference(*map(jnp.asarray, _qkv(seed, shape))))
    np.testing.assert_allclose(got["o"], ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("name", list(_ATTN))
def test_ring_gradients_match_jax(ring_runs, name):
    """Gradients through the backward ring, whose dK/dV rotate with K/V."""
    got = _rank_result(ring_runs, name)
    _, want = _jax_ring(name)
    for key, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[key], w, atol=GRAD_TOL, err_msg=key)


def test_ring_with_rotating_key_mask_matches_jax(ring_runs):
    """``ring_attention`` on each rank's shards with a ``kv_mask`` that
    rotates with K/V, against JAX's masked attention over the whole
    sequence (the XLA with-lse body on one shard)."""
    m = ring_runs["masked"]
    L = 16
    got = {k: np.concatenate([r["masked"][k] for r in ring_runs["runs"]], axis=2)
           for k in ("o", "dq", "dk", "dv")}
    q, k, v, g = map(jnp.asarray, (m["q"], m["k"], m["v"], m["g"]))
    mask = jnp.asarray(m["mask"] > 0)

    def loss(q, k, v):
        o = jring._attn_with_lse_xla(q, k, v, mask)[0]
        return jnp.sum(o * g), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    assert got["o"].shape[2] == 4 * L
    np.testing.assert_allclose(got["o"], np.asarray(o), atol=FWD_TOL, rtol=FWD_TOL)
    for key, w in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], np.asarray(w), atol=GRAD_TOL, err_msg=key)
    assert not got["dk"][:, :, np.asarray(m["mask"]) == 0].any()


def test_ring_cross_attention_pads_queries_and_keys_apart(ring_runs):
    """Nq = 70 queries, Nk = 13 keys over seq 4: the queries pad to 72, the
    keys to 16 (shards full, full, full, partial(1)); against plain
    attention and its gradients in JAX. JAX's ``ring_attention_sharded``
    pads k by q's padding and masks keys by q's length, so a cross
    attention with ragged lengths has no JAX ring reference (ROADMAP,
    Queue 3)."""
    c = ring_runs["cross"]
    got = ring_runs["runs"][0]["cross"]

    def loss(q, k, v):
        o = mha_reference(q, k, v)
        return jnp.sum(o * o), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (c["q"], c["k"], c["v"])))
    np.testing.assert_allclose(got["o"], np.asarray(o), atol=FWD_TOL, rtol=FWD_TOL)
    for key, w in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], np.asarray(w), atol=GRAD_TOL, err_msg=key)


_j_dit = jax.jit(jax_dit_forward, static_argnums=(4,),
                 static_argnames=("attn_impl", "compute_dtype"))


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_dit_forward_with_ring_impl(ring_runs, layout):
    """attn_impl="ring" flows through the tiny CogVideoX DiT under a seq
    mesh of 4: the port's ring against JAX's ring on a 4-device mesh and
    against JAX's single-device forward. Both packages' plain forwards agree
    to 1e-4 (test_torch_cogvideox.py), the ring adds no error of its own."""
    d = ring_runs["dit"]
    got = ring_runs["runs"][0][f"dit_{layout}"]
    for r in ring_runs["runs"][1:]:
        np.testing.assert_array_equal(r[f"dit_{layout}"], got)
    cfg = JaxCogConfig.tiny()
    args = (d["params"], jnp.asarray(d["x"]), jnp.asarray(d["txt"]), jnp.asarray(d["t"]), cfg)
    want = np.asarray(_j_dit(*args, attn_impl="xla", compute_dtype=jnp.float32))
    with jax.set_mesh(make_mesh(MeshAxes(seq=4), devices=jax.devices()[:4])):
        want_ring = np.asarray(_j_dit(*args, attn_impl="ring", compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want_ring, atol=1e-4, rtol=1e-4)
