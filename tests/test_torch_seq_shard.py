"""Sequence parallelism of the DiTs' residual streams
(``videogpa_torch.parallel.sharding.seq_shard``, ``parallel.tp.SeqShard``)
against the JAX package's ``seq_shard`` layout constraint.

In 4 ``gloo`` ranks (spawned once for the file,
``test_torch_dist_cases.seq_shard_cases``): one DPO step of the tiny
CogVideoX DiT and of a small Wan DiT at dp 2 x tp 2 and at tp 4, with
video streams that neither tp divides (105 tokens and 8 text tokens; 45),
against JAX's step under its mesh on 4 CPU devices (without remat, which
changes no number and compiles faster; the four compiles at once): loss, metrics and the
LoRA gradients (accumulate 2: the optimiser holds them after the first
call). Each rank's bytes a remat block keeps for the backward are 1/tp of
one process's, up to the padding of the last block, and a remat recompute
run after the mesh's context has ended still runs under the forward's
mesh. f32 throughout."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_dist_cases as cases
from test_torch_bridge import random_jax_tree
from test_torch_parallel import _jcfg
from test_torch_train import _jax_draws, _lora_np
from videogpa_torch.checkpoint import save_pytree
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxCogConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.wan import dit as jwan
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_tpu.parallel import MeshAxes
from videogpa_tpu.parallel import make_mesh as jax_make_mesh
from videogpa_tpu.parallel import sharding as jsh
from videogpa_tpu.train import trainer as jtrainer
from videogpa_tpu.train import wan_trainer as jwan_trainer

# the cross-package tolerances of test_torch_train.py and of
# test_torch_parallel.py's dry-run segments: metrics rtol 1e-4 / atol 1e-5,
# gradients rtol 1e-3 / atol 1e-4 of their largest value
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-3, 1e-4
LAYOUTS = {"dp2_tp2": MeshAxes(data=2, model=2), "tp4": MeshAxes(model=4)}


def _wan_draws(key, batch):
    """The draws of the JAX Wan step (wan_trainer.py:61-64)."""
    k_t, k_noise = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (batch["x_win"].shape[0],), 1, 1000))
    return t, np.array(jax.random.normal(k_noise, batch["x_win"].shape, jnp.float32))


def _jax_step(family, c, axes, key):
    """JAX's step under ``axes`` on the first 4 CPU devices, lowered:
    (its compile, a function of the compiled step giving the metrics and
    the LoRA gradients of the first accumulation call)."""
    mesh = jax_make_mesh(axes, devices=jax.devices()[:axes.size])
    jt = jtrainer.TrainerConfig(compute_dtype=jnp.float32, attn_impl="xla",
                                **{**cases.SP_TRAIN_KW, "remat": False})
    base = jax.tree.map(jnp.asarray, c["params"])
    if family == "cog":
        step = jtrainer.make_dpo_train_step_unbound(_jcfg(cases.COG_SP, JaxCogConfig), jt)[0]
        base = (jsh.shard_tree(base, jsh.dit_param_specs(base), mesh), None)
    else:
        step = jwan_trainer.make_wan_dpo_train_step_unbound(_jcfg(cases.WAN_TP, JaxWanConfig),
                                                            jt)[0]
        base = (jsh.shard_tree(base, jsh.wan_param_specs(base), mesh),)
    lora = jsh.shard_tree(jax.tree.map(jnp.asarray, c["lora"]),
                          jsh.lora_param_specs(c["lora"]), mesh)
    batch = jax.tree.map(jnp.asarray, c["batch"])
    args = (*base, jtrainer.init_train_state(lora, jt),
            jsh.shard_tree(batch, jsh.batch_specs(batch), mesh), key)
    with jax.set_mesh(mesh):
        lowered = step.lower(*args)

    def run(compiled):
        with jax.set_mesh(mesh):
            state, metrics = compiled(*args)
        grads = {f"{n}.{k}": np.asarray(g) for n, ab in state.opt_state.acc_grads.items()
                 for k, g in ab.items()}
        return {k: float(v) for k, v in metrics.items()}, grads

    return lowered.compile, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("seq_shard"))
    rng = np.random.default_rng(0)
    cog = _jcfg(cases.COG_SP, JaxCogConfig)
    shape = (2, cog.in_channels, cog.sample_frames, cog.sample_height, cog.sample_width)
    cog_batch = {"x_win": rng.standard_normal(shape).astype(np.float32),
                 "x_lose": rng.standard_normal(shape).astype(np.float32),
                 "prompt_emb": rng.standard_normal(
                     (2, cog.max_text_seq_length, cog.text_embed_dim)).astype(np.float32)}
    t, noise = _jax_draws(jax.random.PRNGKey(3), cases.COG_SP, cog_batch)
    wcfg = _jcfg(cases.WAN_TP, JaxWanConfig)
    wshape = (2,) + cases.WAN_SP_LATENT
    wan_batch = {"x_win": rng.standard_normal(wshape).astype(np.float32),
                 "x_lose": rng.standard_normal(wshape).astype(np.float32),
                 "prompt_emb": rng.standard_normal((2, wcfg.text_len, wcfg.text_dim)).astype(
                     np.float32)}
    wt, wnoise = _wan_draws(jax.random.PRNGKey(4), wan_batch)
    inp = {"cog": {"params": random_jax_tree(jax_dit_init, cog, seed=1),
                   "lora": _lora_np(2, cog.num_layers, cog.hidden_dim, 4),
                   "batch": cog_batch, "draws": {"timesteps": t.numpy(), "noise": noise.numpy()}},
           "wan": {"params": random_jax_tree(jwan.wan_init, wcfg, seed=5),
                   "lora": _lora_np(6, wcfg.num_layers, wcfg.dim, 4),
                   "batch": wan_batch, "draws": {"timesteps": wt, "noise": wnoise}}}
    save_pytree(inp, f"{workdir}/seq_shard.npz")
    ranks = cases.Ranks("seq_shard_cases", workdir)
    steps = {f"{fam}_{tag}": _jax_step(fam, inp[fam], axes, jax.random.PRNGKey(3 if fam == "cog"
                                                                              else 4))
             for fam in ("cog", "wan") for tag, axes in LAYOUTS.items()}
    with ThreadPoolExecutor(len(steps)) as pool:  # XLA compiles outside the GIL
        compiled = dict(zip(steps, pool.map(lambda s: s[0](), steps.values())))
    ref = {k: run(compiled[k]) for k, (_, run) in steps.items()}
    return {"ranks": ranks.results(), "ref": ref}


@pytest.mark.parametrize("family", ["cog", "wan"])
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_sequence_sharded_dpo_step_matches_jax_under_its_mesh(runs, family, tag):
    """Loss, metrics and every LoRA gradient of the sequence-sharded step,
    equal on every rank, against JAX's step under the same mesh."""
    key = f"{family}_{tag}"
    got = [r[key] for r in runs["ranks"]]
    want_m, want_g = runs["ref"][key]
    for m, g in got[1:]:
        assert m == got[0][0]
        for n in g:
            np.testing.assert_array_equal(g[n], got[0][1][n])
    metrics, grads = got[0]
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    assert set(grads) == set(want_g)
    for n, w in want_g.items():
        assert np.abs(w).max() > 0, n
        np.testing.assert_allclose(grads[n], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * np.abs(w).max(), err_msg=n)


def _streams(family):
    """Each residual stream's length and width, and the bytes of an f32 row."""
    if family == "cog":
        c = cases.COG_SP
        video = c.sample_frames * (c.sample_height // c.patch_size) * (
            c.sample_width // c.patch_size)
        return [video, c.max_text_seq_length], c.hidden_dim
    _, f, h, w = cases.WAN_SP_LATENT
    return [f * (h // 2) * (w // 2)], cases.WAN_TP.dim


@pytest.mark.parametrize("family", ["cog", "wan"])
def test_remat_blocks_keep_one_tp_th_of_the_sequence(runs, family):
    """What a remat block keeps for the backward on each rank (its inputs,
    counted by saved_tensors_hooks) is its ceil(n / tp) rows of each stream:
    1/tp of one process's, up to the padding of the last block, in whole
    512-byte blocks."""
    lengths, width = _streams(family)
    assert lengths[0] % 2 and lengths[0] % 4  # neither tp divides the video stream

    def want(tp):
        return sum(-(-(-(-n // tp) * width * 4) // 512) * 512 for n in lengths)

    for r in runs["ranks"]:
        tp1 = int(r[f"{family}_block_bytes_tp1"])
        assert tp1 == want(1)
        for tag, tp in (("dp2_tp2", 2), ("tp4", 4)):
            got = int(r[f"{family}_block_bytes_{tag}"])
            assert got == want(tp), (tag, got, want(tp))
            assert tp1 / tp <= got < tp1 / tp + len(lengths) * (width * 4 + 512)


def test_remat_recompute_runs_under_the_forward_mesh(runs):
    """A backward after the mesh's context has ended (as the autograd engine
    runs a CUDA backward, on a thread of its own) recomputes the blocks
    under the forward's mesh: the gradients are those of a backward inside
    the context."""
    for r in runs["ranks"]:
        assert float(r["backward_after_the_mesh_context"]) == 0.0
