"""The port's parallel layer (``videogpa_torch.parallel``) against the JAX
package's (``videogpa_tpu/parallel``, ``tests/test_parallel.py``,
``__graft_entry__.dryrun_multichip``).

The spec functions shard exactly JAX's leaves, name by name through the
weight bridge. In 4 ``gloo`` ranks (spawned once for the file,
``test_torch_dist_cases.parallel_cases``): the tensor-parallel forwards of Wan,
VGGT and the CogVideoX DiT over dp 2 x tp 2 and at tp 4 on the tiny DiT's 2
heads, the dp x tp DPO step against the port's single-process step at JAX's
sharded-vs-replicated tolerances, and segments 1-4 of the
multichip dry run against JAX's single-device numbers. f32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_cases as cases
from test_torch_bridge import random_jax_tree
from test_torch_train import _jax_draws, _lora_np
from videogpa_torch.checkpoint import save_pytree
from videogpa_torch.convert import _STACKED as BRIDGE_STACKED
from videogpa_torch.convert import load_jax_params, state_dict_from_jax
from videogpa_torch.models.cogvideox import CogVideoXTransformer
from videogpa_torch.models.vggt import VGGT
from videogpa_torch.models.wan import WanTransformer
from videogpa_torch.parallel import sharding as tsh
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxCogConfig
from videogpa_tpu.models.cogvideox import dit_forward as jax_dit_forward
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.vggt import model as jvggt
from videogpa_tpu.models.vggt.config import VGGTConfig as JaxVGGTConfig
from videogpa_tpu.models.wan import dit as jwan
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_tpu.parallel import sharding as jsh
from videogpa_tpu.train import lora as jlora
from videogpa_tpu.train import trainer as jtrainer

torch.set_num_threads(2)
# tests/test_parallel.py's tolerances
WAN_ATOL, VGGT_ATOL, DIT_ATOL = 2e-4, 5e-4, 2e-4
METRIC_RTOL, METRIC_ATOL, LORA_ATOL = 2e-5, 2e-6, 1e-5


def _jcfg(cfg, jax_cls):
    return jax_cls(**dataclasses.asdict(cfg))


_j_dit = jax.jit(jax_dit_forward, static_argnums=(4,),
                 static_argnames=("attn_impl", "compute_dtype"))
_j_wan = jax.jit(jwan.wan_forward, static_argnums=(4,),
                 static_argnames=("attn_impl", "compute_dtype"))
_j_vggt = jax.jit(jvggt.vggt_forward, static_argnums=(2,),
                  static_argnames=("attn_impl", "compute_dtype", "dpt_chunk"))


def _rng_batch(rng, cfg, B):
    shape = (B, cfg.in_channels, cfg.sample_frames, cfg.sample_height, cfg.sample_width)
    return {"x_win": rng.standard_normal(shape).astype(np.float32),
            "x_lose": rng.standard_normal(shape).astype(np.float32),
            "prompt_emb": rng.standard_normal(
                (B, cfg.max_text_seq_length, cfg.text_embed_dim)).astype(np.float32)}


def _draws(key, cfg, batch):
    t, noise = _jax_draws(key, cfg, batch)
    return {"timesteps": t.numpy(), "noise": noise.numpy()}


# ---------------------------------------------------------------------------
# spec functions, in this process
# ---------------------------------------------------------------------------

def _spec_markers(params, specs):
    """A tree shaped like ``params`` whose leaves mark JAX's sharded dims:
    size 2 on a dim split over "model", 1 elsewhere, the layer count on a
    stacked leading axis; through the bridge it names the port's leaves."""
    def mark(path, leaf, spec):
        names = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        stacked = any(n in BRIDGE_STACKED for n in names)
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        return np.zeros(tuple(leaf.shape[0] if (i == 0 and stacked) else
                              (2 if s == "model" else 1) for i, s in enumerate(spec)), np.int8)

    return jax.tree_util.tree_map_with_path(
        mark, params, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


_SPEC_CASES = {
    "cogvideox": (lambda: random_jax_tree(jax_dit_init, _jcfg(cases.COG_TINY, JaxCogConfig)),
                  jsh.dit_param_specs, lambda: CogVideoXTransformer(cases.COG_TINY),
        tsh.dit_param_specs),
    "wan": (lambda: random_jax_tree(jwan.wan_init, _jcfg(cases.WAN_TP, JaxWanConfig)),
            jsh.wan_param_specs, lambda: WanTransformer(cases.WAN_TP), tsh.wan_param_specs),
    "vggt": (lambda: random_jax_tree(jvggt.vggt_init, JaxVGGTConfig.tiny()),
             jsh.vit_param_specs, lambda: VGGT(cases.VGGT_TINY), tsh.vit_param_specs),
}


@pytest.mark.parametrize("family", list(_SPEC_CASES))
def test_param_specs_shard_the_leaves_jax_shards(family):
    """Every leaf the JAX rules shard is sharded by the port's rules on the
    same dim (the bridge's transposes applied), and no other leaf."""
    make_tree, jax_specs, make_model, port_specs = _SPEC_CASES[family]
    params = make_tree()
    markers = state_dict_from_jax(_spec_markers(params, jax_specs(params)))
    model = make_model()
    specs = port_specs(model)
    assert set(specs) == set(markers) == {n for n, _ in model.named_parameters()}
    n_sharded = 0
    for name, spec in specs.items():
        want = [d for d, size in enumerate(markers[name].shape) if size == 2]
        got = [d for d, axis in enumerate(spec) if axis == "model"]
        assert got == want, (name, spec, tuple(markers[name].shape))
        n_sharded += bool(got)
    assert n_sharded > 0
    assert all(s.blocks == (3 if ".qkv." in n and any(s) else 1) for n, s in specs.items())


def test_lora_and_batch_specs():
    lora = jlora.lora_init(jax.random.PRNGKey(0), 2, 32, rank=4)
    tl = {n: {k: torch.zeros(np.shape(v)) for k, v in ab.items()} for n, ab in lora.items()}
    assert all(s == tsh.P() for ab in tsh.lora_param_specs(tl).values() for s in ab.values())
    assert all(s == jax.sharding.PartitionSpec() for ab in jsh.lora_param_specs(lora).values()
               for s in ab.values())
    batch = {"x_win": torch.zeros(4, 2), "prompt_emb": torch.zeros(4, 3)}
    assert tsh.batch_specs(batch) == {"x_win": tsh.P("data"), "prompt_emb": tsh.P("data")}
    x = torch.arange(12.0).reshape(4, 3)
    assert tsh.seq_shard(x) is x


def test_local_slice_splits_fused_qkv_per_third():
    """A rank's block of a fused q | k | v weight holds the same rows of each
    third: whole heads of q, k and v."""
    class _Mesh:  # the queries local_slice makes of a mesh
        mesh_dim_names = ("data", "seq", "model")
        mesh = torch.zeros(1, 1, 2)

        def __init__(self, r):
            self.r = r

        def size(self, dim):
            return self.mesh.shape[dim]

        def get_coordinate(self):
            return (0, 0, self.r)

    w = torch.arange(12.0)[:, None].expand(12, 3)
    for r in range(2):
        got = tsh.local_slice(w, tsh.P("model", None, blocks=3), _Mesh(r))
        assert got[:, 0].tolist() == [2 * r, 2 * r + 1, 4 + 2 * r, 5 + 2 * r,
                                      8 + 2 * r, 9 + 2 * r]
        arr = np.arange(8.0).reshape(2, 4)
        np.testing.assert_array_equal(tsh.local_slice(arr, tsh.P(None, "model"), _Mesh(r)),
                                      arr[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="split"):
        tsh.local_slice(torch.zeros(5, 3), tsh.P("model"), _Mesh(0))


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs (numpy, seeded), every rank's results of ``parallel_cases``
    and the references (``_references``)."""
    workdir = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    tiny, small = _jcfg(cases.COG_TINY, JaxCogConfig), _jcfg(cases.COG_SMALL, JaxCogConfig)
    wcfg = _jcfg(cases.WAN_TP, JaxWanConfig)
    vcfg = JaxVGGTConfig.tiny()
    inp = {
        "wan": {"params": random_jax_tree(jwan.wan_init, wcfg, seed=1),
                "x": rng.standard_normal((1, wcfg.in_channels, 3, 8, 8)).astype(np.float32),
                "ctx": rng.standard_normal((1, wcfg.text_len, wcfg.text_dim)).astype(
                    np.float32),
                "t": np.full((1,), 500.0, np.float32)},
        "vggt": {"params": random_jax_tree(jvggt.vggt_init, vcfg, seed=2),
                 "images": rng.uniform(0, 1, (1, 2, 3, vcfg.img_size, vcfg.img_size)).astype(
                     np.float32)},
        "dit_batch": {"params": random_jax_tree(jax_dit_init, tiny, seed=3),
                      "x": rng.standard_normal((2, tiny.sample_frames, tiny.in_channels,
                                                tiny.sample_height, tiny.sample_width)).astype(
                          np.float32),
                      "txt": rng.standard_normal((2, tiny.max_text_seq_length,
                                                  tiny.text_embed_dim)).astype(np.float32),
                      "t": np.array([100, 900])},
        "dit_tp4": {"params": random_jax_tree(jax_dit_init, tiny, seed=4),
                    "x": rng.standard_normal((1, tiny.sample_frames, tiny.in_channels,
                                              tiny.sample_height, tiny.sample_width)).astype(
                        np.float32),
                    "txt": rng.standard_normal((1, tiny.max_text_seq_length,
                                                tiny.text_embed_dim)).astype(np.float32),
                    "t": np.array([300])},
    }
    wshape = (2, wcfg.in_channels, 3, 8, 8)
    inp["wan_train"] = {
        "params": random_jax_tree(jwan.wan_init, wcfg, seed=10),
        "lora": _lora_np(11, wcfg.num_layers, wcfg.dim, 4),
        "batch": {"x_win": rng.standard_normal(wshape).astype(np.float32),
                  "x_lose": rng.standard_normal(wshape).astype(np.float32),
                  "prompt_emb": rng.standard_normal((2, wcfg.text_len, wcfg.text_dim)).astype(
                      np.float32)},
        "draws": {"timesteps": np.array([300, 800]),
                  "noise": rng.standard_normal(wshape).astype(np.float32)}}
    train_batch = _rng_batch(rng, tiny, 2)
    inp["train"] = {"params": random_jax_tree(jax_dit_init, tiny, seed=5),
                    "lora": _lora_np(6, tiny.num_layers, tiny.hidden_dim, 4),
                    "batch": train_batch,
                    "draws": _draws(jax.random.PRNGKey(7), cases.COG_TINY, train_batch)}
    # __graft_entry__.dryrun_multichip's inputs, at 4 ranks (dp 2: B = 4)
    batch = _rng_batch(rng, small, 4)
    sp_batch = {k: v[:1] for k, v in batch.items()}
    vtiny = JaxVGGTConfig.tiny()
    inp["dryrun"] = {
        "base": random_jax_tree(jax_dit_init, small, seed=9),
        "lora": _lora_np(1, small.num_layers, small.hidden_dim, 4, b_scale=0.0),
        "batch": batch, "draws": _draws(jax.random.PRNGKey(3), cases.COG_SMALL, batch),
        "x_sp": np.ascontiguousarray(np.swapaxes(batch["x_win"][:1], 1, 2)),
        "e_sp": batch["prompt_emb"][:1],
        "lora_sp": _lora_np(5, small.num_layers, small.hidden_dim, 4),
        "batch_sp": sp_batch,
        "draws_sp": _draws(jax.random.PRNGKey(6), cases.COG_SMALL, sp_batch),
        "gen_params": random_jax_tree(jax_dit_init, small, seed=7),
        "x_g": rng.standard_normal((1, small.sample_frames, small.in_channels,
                                    small.sample_height, small.sample_width)).astype(np.float32),
        "e_g": rng.standard_normal((1, small.max_text_seq_length,
                                    small.text_embed_dim)).astype(np.float32),
        "vparams": random_jax_tree(jvggt.vggt_init, vtiny, seed=8),
        "imgs": (rng.standard_normal((2, 2, 3, vtiny.img_size, vtiny.img_size)) * 0.2
                 + 0.5).astype(np.float32),
    }
    save_pytree(inp, f"{workdir}/parallel.npz")
    ranks = cases.Ranks("parallel_cases", workdir)
    ref = _references(inp)  # while the ranks run
    return {"inp": inp, "ranks": ranks.results(), "ref": ref}


def _jax_dit(c, cfg):
    return np.asarray(_j_dit(c["params"], jnp.asarray(c["x"]), jnp.asarray(c["txt"]),
                             jnp.asarray(c["t"]), _jcfg(cfg, JaxCogConfig), attn_impl="xla",
                             compute_dtype=jnp.float32))


def _jax_step(base, lora, batch, key, cfg, kw):
    """JAX's single-device step; without remat, which changes no number and
    compiles faster."""
    jt = jtrainer.TrainerConfig(compute_dtype=jnp.float32, attn_impl="xla",
                                **{**kw, "remat": False})
    state = jtrainer.init_train_state(jax.tree.map(jnp.asarray, lora), jt)
    step, _ = jtrainer.make_dpo_train_step(jax.tree.map(jnp.asarray, base),
                                           _jcfg(cfg, JaxCogConfig), jt)
    state, m = step(state, jax.tree.map(jnp.asarray, batch), key)
    return {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, state.lora)


def _port_step(c, wan=False):
    """The port's single-process step on the whole batch, the same draws."""
    cfg, cls = (cases.WAN_TP, WanTransformer) if wan else (cases.COG_TINY, CogVideoXTransformer)
    model = load_jax_params(cls(cfg), c["params"]).requires_grad_(False)
    return cases.dpo_step(model, cfg, c["lora"], c["batch"], c["draws"], wan=wan,
                          **cases.TRAIN_KW)


def _references(inp):
    """JAX's single-device numbers of every case, and the port's
    single-process DPO step."""
    wan, vggt, d = inp["wan"], inp["vggt"], inp["dryrun"]
    def j_vggt(params, images):
        return _j_vggt(params, jnp.asarray(images), JaxVGGTConfig.tiny(), attn_impl="xla",
                       compute_dtype=jnp.float32, dpt_chunk=4)

    tr = inp["train"]
    return {
        "wan": np.asarray(_j_wan(wan["params"], jnp.asarray(wan["x"]), jnp.asarray(wan["t"]),
                                 jnp.asarray(wan["ctx"]), _jcfg(cases.WAN_TP, JaxWanConfig),
                                 attn_impl="xla", compute_dtype=jnp.float32)),
        "vggt": jax.tree.map(np.asarray, j_vggt(vggt["params"], vggt["images"])),
        "dit_batch": _jax_dit(inp["dit_batch"], cases.COG_TINY),
        "dit_tp4": _jax_dit(inp["dit_tp4"], cases.COG_TINY),
        "train_port": _port_step(tr),
        "wan_train_port": _port_step(inp["wan_train"], wan=True),
        "seg1": _jax_step(d["base"], d["lora"], d["batch"], jax.random.PRNGKey(3),
                          cases.COG_SMALL, cases.DRYRUN_KW)[0],
        "seg2": _jax_dit({"params": d["base"], "x": d["x_sp"], "txt": d["e_sp"],
                          "t": np.array([500])}, cases.COG_SMALL),
        "seg3": _jax_step(d["base"], d["lora_sp"], d["batch_sp"], jax.random.PRNGKey(6),
                          cases.COG_SMALL, cases.DRYRUN_KW),
        "seg4_gen": _jax_dit({"params": d["gen_params"], "x": d["x_g"], "txt": d["e_g"],
                              "t": np.array([500])}, cases.COG_SMALL),
        "seg4_depth": np.asarray(j_vggt(d["vparams"], d["imgs"])["depth"]),
    }


def _same_on(ranks, key):
    """The result of ``key``, equal on each of ``ranks``."""
    first = ranks[0][key]
    for r in ranks[1:]:
        jax.tree.map(np.testing.assert_array_equal, r[key], first)
    return first


def test_mesh_size_mismatch_raises(runs):
    assert all(int(r["mesh_size_mismatch_raises"]) == 1 for r in runs["ranks"])


def test_sharded_leaves_hold_one_tp_th_each(runs):
    """Each rank keeps 1/tp of every leaf dit_param_specs shards (checked
    on every rank of the dp 2 x tp 2 mesh): q/k/v/fc1 weight and bias,
    to_out/fc2 weight, in each layer."""
    for r in runs["ranks"]:
        numel = r["local_numel"]
        assert len(numel) == 10 * cases.COG_TINY.num_layers
        for name, (local, full) in numel.items():
            assert local * 2 == full, name


def test_sharded_leaves_free_the_whole_tensor(runs):
    """A sharded leaf's storage holds its block alone: a column-parallel
    block (leading rows, a contiguous view) kept the whole weight alive, so
    a real rank held every q/k/v/fc1 weight whole besides its block."""
    for r in runs["ranks"]:
        for name, (storage, block) in r["local_storage"].items():
            assert storage == block, name


def test_wan_tp_matches_replicated(runs):
    """TestWanTP: the Wan DiT split by wan_param_specs over dp 2 x tp 2."""
    np.testing.assert_allclose(_same_on(runs["ranks"], "wan"), runs["ref"]["wan"],
                               atol=WAN_ATOL)


def test_wan_ring_matches_replicated(runs):
    """The Wan DiT with attn_impl="ring" over seq 4: its self-attention
    (48 tokens) and its cross-attention (16 text keys) through the ring."""
    np.testing.assert_allclose(_same_on(runs["ranks"], "wan_ring"), runs["ref"]["wan"],
                               atol=WAN_ATOL)


@pytest.mark.parametrize("tag", ["wan_train_dp2_tp2", "wan_train_ring"])
def test_wan_dpo_step_matches_single_process(runs, tag):
    """One Wan DPO step over dp 2 x tp 2 (wan_param_specs; the QK RMS-norm's
    mean square summed over the model group), and over seq 4 with the ring,
    against the single-process step at TestTPTrainingNumerics' tolerances."""
    got = _same_on(runs["ranks"], tag)
    port_m, port_lora = runs["ref"]["wan_train_port"]
    for k in ("loss", "reward_margin", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]), port_m[k], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    for n, ab in port_lora.items():
        for k, want in ab.items():
            np.testing.assert_allclose(got["lora"][n][k], want, atol=LORA_ATOL,
                                       err_msg=f"{n}.{k}")


def test_vggt_tp_matches_replicated(runs):
    """TestVGGTTP: the VGGT split by vit_param_specs over dp 2 x tp 2."""
    got = _same_on(runs["ranks"], "vggt")
    for key in ("pose_enc", "depth", "world_points"):
        np.testing.assert_allclose(got[key], runs["ref"]["vggt"][key], atol=VGGT_ATOL,
                                   err_msg=key)


def test_dit_tp_with_data_sharded_batch(runs):
    """TestDiTTPBatch: dp 2 x tp 2, each data rank forwards its row."""
    want = runs["ref"]["dit_batch"]
    for r in runs["ranks"]:
        d = int(r["dit_batch"]["data_rank"])
        np.testing.assert_allclose(r["dit_batch"]["rows"], want[d:d + 1], atol=DIT_ATOL)


def test_dit_tp4_gathers_heads_tp_does_not_divide(runs):
    """tp 4 on the tiny DiT's 2 heads (a shard would hold half a head):
    each attention gathers its q/k/v and keeps its columns of the output;
    the numbers are the replicated ones, as GSPMD gives them in JAX."""
    np.testing.assert_allclose(_same_on(runs["ranks"], "dit_tp4"), runs["ref"]["dit_tp4"],
                               atol=DIT_ATOL)


@pytest.mark.parametrize("tag", ["train_dp2_tp2", "train_tp4"])
def test_tp_dpo_step_matches_single_process(runs, tag):
    """TestTPTrainingNumerics: loss, reward_margin, grad_norm and the
    updated LoRA of the sharded step equal the single-process step's (on
    the whole batch, the JAX draws injected) at JAX's sharded-vs-replicated
    tolerances; test_torch_train.py holds that step to JAX's."""
    got = _same_on(runs["ranks"], tag)
    port_m, port_lora = runs["ref"]["train_port"]
    for k in ("loss", "reward_margin", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]), port_m[k], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    c = runs["inp"]["train"]
    for n, ab in port_lora.items():
        for k, want in ab.items():
            assert np.abs(want - c["lora"][n][k]).max() > 1e-4  # the update happened
            np.testing.assert_allclose(got["lora"][n][k], want, atol=LORA_ATOL,
                                       err_msg=f"{n}.{k}")


def test_dryrun_segment1_dp_tp_dpo_step(runs):
    """Segment 1: the DPO step of _small_cfg over dp 2 x tp 2 (B = 4)."""
    got, want = _same_on(runs["ranks"], "seg1"), runs["ref"]["seg1"]
    assert np.isfinite(float(got["loss"]))
    for k in ("loss", "reward_margin", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_dryrun_segment2_ring_dit_forward(runs):
    """Segment 2: the DiT forward with attn_impl="ring" over seq 4."""
    np.testing.assert_allclose(_same_on(runs["ranks"], "seg2"), runs["ref"]["seg2"],
                               atol=DIT_ATOL)


def test_dryrun_segment3_ring_dpo_step(runs):
    """Segment 3: the seq-parallel DPO step, whose backward ring rotates
    dK/dV, against JAX's single-device step."""
    got = _same_on(runs["ranks"], "seg3")
    want_m, want_lora = runs["ref"]["seg3"]
    for k in ("loss", "reward_margin", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]), want_m[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for n, ab in want_lora.items():
        for k, w in ab.items():
            np.testing.assert_allclose(got["lora"][n][k], w, atol=LORA_ATOL, err_msg=f"{n}.{k}")


def test_dryrun_segment4_disjoint_sub_meshes(runs):
    """Segment 4: the TP sampler on ranks 0-1 and the DP VGGT scorer on
    ranks 2-3, sub-meshes of one world."""
    ranks = runs["ranks"]
    assert all("seg4_gen" in r and "seg4_depth" not in r for r in ranks[:2])
    assert all("seg4_depth" in r and "seg4_gen" not in r for r in ranks[2:])
    np.testing.assert_allclose(_same_on(ranks[:2], "seg4_gen"), runs["ref"]["seg4_gen"],
                               atol=DIT_ATOL)
    got = np.concatenate([ranks[2]["seg4_depth"], ranks[3]["seg4_depth"]])
    np.testing.assert_allclose(got, runs["ref"]["seg4_depth"], atol=VGGT_ATOL)
