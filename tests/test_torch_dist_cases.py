"""Multi-rank cases of the port's parallel layer, run in ``gloo`` process
groups on the CPU (no JAX here: the test files hold the JAX references).

``Ranks`` starts the ranks once per test file (``torch.multiprocessing``
with the spawn method, a ``FileStore`` under the test's temporary
directory, one intra-op thread a rank): each rank runs one cases function
of this module, which reads its inputs from ``.npz`` files the parent wrote
and returns numpy results, and the parent gets every rank's results back.
The module holds no test of its own: pytest collects none from it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from videogpa_torch.checkpoint import load_pytree, save_pytree
from videogpa_torch.models.cogvideox import CogVideoXConfig
from videogpa_torch.models.vggt import VGGTConfig
from videogpa_torch.models.wan import WanConfig

WORLD = 4
# the configs of tests/test_parallel.py and of __graft_entry__._small_cfg
COG_TINY = CogVideoXConfig.tiny()
COG_SMALL = dataclasses.replace(COG_TINY, num_layers=4, num_heads=4, head_dim=32,
                                sample_frames=5, sample_height=16, sample_width=24)
WAN_TP = dataclasses.replace(WanConfig.tiny(), num_heads=4, dim=64, ffn_dim=128)
VGGT_TINY = VGGTConfig.tiny()
# the DPO steps' trainer settings (f32, remat, LoRA r 4 / alpha 8); warmup 0
# so the first update moves the LoRA
TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10, lora_rank=4,
                lora_alpha=8.0, remat=True)
# __graft_entry__.dryrun_multichip's trainer settings
DRYRUN_KW = dict(lora_rank=4, lora_alpha=8.0, remat=True, warmup_steps=2, max_steps=10)


def _entry(rank: int, world: int, store: str, fn: str, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        out = globals()[fn](rank, workdir)
        save_pytree(out, os.path.join(workdir, f"out_{fn}_{rank}.npz"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``fn(rank, workdir)`` running on ``world`` gloo ranks, started at
    construction, so the parent can compute its references meanwhile;
    ``results()`` waits for every rank (raising what a rank raised) and
    returns each rank's result tree (numpy leaves)."""

    def __init__(self, fn: str, workdir: str, world: int = WORLD):
        import torch.multiprocessing as mp

        self.fn, self.workdir, self.world = fn, workdir, world
        self._ctx = mp.spawn(_entry, args=(world, os.path.join(workdir, "store"), fn, workdir),
                             nprocs=world, join=False)

    def results(self) -> list:
        while not self._ctx.join():
            pass
        return [load_pytree(os.path.join(self.workdir, f"out_{self.fn}_{r}.npz"),
                            to_device=False) for r in range(self.world)]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def _inputs(workdir: str, name: str) -> dict:
    return load_pytree(os.path.join(workdir, name + ".npz"), to_device=False)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_cases(rank: int, workdir: str) -> dict:
    """Every ring case of ``test_torch_ring_attention.py`` on this rank:
    outputs and the gradients of sum(O^2) (or of sum(O * G))."""
    from videogpa_torch.models.cogvideox import CogVideoXTransformer, dit_forward
    from videogpa_torch.convert import load_jax_params
    from videogpa_torch.ops.attention import attention
    from videogpa_torch.ops.ring_attention import ring_attention
    from videogpa_torch.parallel import MeshAxes, make_mesh, set_mesh
    from videogpa_torch.parallel.mesh import axis_rank

    inp = _inputs(workdir, "ring")
    seq = make_mesh(MeshAxes(data=1, seq=4), device_type="cpu")
    meshes = {"seq4": seq, "dp4": make_mesh(MeshAxes(data=4), device_type="cpu"),
              "dp2_seq2": make_mesh(MeshAxes(data=2, seq=2), device_type="cpu")}
    out = {}
    for name, case in inp["attention"].items():
        q, k, v = (_t(case[x]).requires_grad_(True) for x in "qkv")
        layout = str(case["layout"])
        with set_mesh(meshes[str(case["mesh"])]):
            o = attention(q, k, v, impl="ring", layout=layout)
        (o * o).sum().backward()
        out[name] = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}

    # cross attention: the query and key lengths pad to multiples of P apart
    c = inp["cross"]
    q, k, v = (_t(c[x]).requires_grad_(True) for x in "qkv")
    with set_mesh(seq):
        o = attention(q, k, v, impl="ring")
    (o * o).sum().backward()
    out["cross"] = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}

    # ring_attention on this rank's shards with a rotating key mask
    c = inp["masked"]
    group, r = seq.get_group("seq"), axis_rank(seq, "seq")
    L = c["q"].shape[2] // 4
    q, k, v = (_t(c[x][:, :, r * L:(r + 1) * L]).requires_grad_(True) for x in "qkv")
    o = ring_attention(q, k, v, group, kv_mask=_t(c["mask"][r * L:(r + 1) * L]))
    (o * _t(c["g"][:, :, r * L:(r + 1) * L])).sum().backward()
    out["masked"] = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}

    # the tiny CogVideoX DiT with attn_impl="ring", in both attention layouts
    d = inp["dit"]
    model = load_jax_params(CogVideoXTransformer(COG_TINY), d["params"]).requires_grad_(False)
    for layout in ("bhnd", "bnhd"):
        with set_mesh(seq), torch.no_grad():
            got = dit_forward(model, _t(d["x"]), _t(d["txt"]), _t(d["t"]),
                              compute_dtype=torch.float32, attn_impl="ring",
                              attn_layout=layout)
        out[f"dit_{layout}"] = _np(got)
    return out


# ---------------------------------------------------------------------------
# tensor, data and sequence parallelism
# ---------------------------------------------------------------------------

def _cog(cfg, params):
    from videogpa_torch.convert import load_jax_params
    from videogpa_torch.models.cogvideox import CogVideoXTransformer

    return load_jax_params(CogVideoXTransformer(cfg), params).requires_grad_(False)


def dpo_step(model, cfg, lora_np, batch, draws, mesh=None, attn_impl="auto", wan=False,
             **kw):
    """One CogVideoX (or, with ``wan``, Wan) train-step call with the whole
    batch's ``draws``, under ``mesh`` on this rank's slice of ``batch`` (or
    in one process without a mesh): (metrics, updated LoRA), numpy."""
    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.parallel.sharding import batch_specs, shard_tree
    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    tcfg = TrainerConfig(compute_dtype=torch.float32, attn_impl=attn_impl, **kw)
    lora = {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
            for n, ab in lora_np.items()}
    state = init_train_state(lora, tcfg)
    step, _ = (make_wan_dpo_train_step if wan else make_dpo_train_step)(model, cfg, tcfg)
    batch = {k: _t(v) for k, v in batch.items()}
    local = batch if mesh is None else shard_tree(batch, batch_specs(batch), mesh)
    with set_mesh(mesh):
        state, metrics = step(state, local, timesteps=_t(draws["timesteps"]),
                              noise=_t(draws["noise"]))
    return ({k: np.float64(v) for k, v in metrics.items()},
            {n: {k: _np(t) for k, t in ab.items()} for n, ab in state.lora.items()})


def parallel_cases(rank: int, workdir: str) -> dict:
    """Every multi-rank case of ``test_torch_parallel.py`` on this rank."""
    import torch.distributed as dist

    from videogpa_torch.convert import load_jax_params
    from videogpa_torch.models.cogvideox import dit_forward
    from videogpa_torch.models.vggt import VGGT, vggt_forward
    from videogpa_torch.models.wan import WanTransformer, wan_forward
    from videogpa_torch.parallel import MeshAxes, make_mesh, set_mesh
    from videogpa_torch.parallel.mesh import axis_rank
    from videogpa_torch.parallel.sharding import (
        P, batch_specs, dit_param_specs, shard_tree, vit_param_specs, wan_param_specs)

    inp = _inputs(workdir, "parallel")
    out: dict = {}
    dp_tp = make_mesh(MeshAxes(data=2, model=2), device_type="cpu")
    tp4 = make_mesh(MeshAxes(model=4), device_type="cpu")
    sp = make_mesh(MeshAxes(seq=4), device_type="cpu")
    try:
        make_mesh(MeshAxes(data=3), device_type="cpu")
        out["mesh_size_mismatch_raises"] = np.int64(0)
    except ValueError:
        out["mesh_size_mismatch_raises"] = np.int64(1)

    # TestWanTP: the Wan DiT split by wan_param_specs over dp 2 x tp 2
    c = inp["wan"]
    wan = load_jax_params(WanTransformer(WAN_TP), c["params"]).requires_grad_(False)
    wan = shard_tree(wan, wan_param_specs(wan), dp_tp)
    with set_mesh(dp_tp), torch.no_grad():
        out["wan"] = _np(wan_forward(wan, _t(c["x"]), _t(c["t"]), _t(c["ctx"]),
                                     compute_dtype=torch.float32))

    # the Wan DiT with attn_impl="ring" over seq 4 (self- and cross-attention)
    wan_sp = load_jax_params(WanTransformer(WAN_TP), c["params"]).requires_grad_(False)
    with set_mesh(sp), torch.no_grad():
        out["wan_ring"] = _np(wan_forward(wan_sp, _t(c["x"]), _t(c["t"]), _t(c["ctx"]),
                                          compute_dtype=torch.float32, attn_impl="ring"))

    # one Wan DPO step over dp 2 x tp 2, and over seq 4 with the ring
    c = inp["wan_train"]
    for tag, mesh, impl in (("wan_train_dp2_tp2", dp_tp, "auto"), ("wan_train_ring", sp, "ring")):
        model = load_jax_params(WanTransformer(WAN_TP), c["params"]).requires_grad_(False)
        if mesh is dp_tp:
            model = shard_tree(model, wan_param_specs(model), mesh)
        metrics, lora = dpo_step(model, WAN_TP, c["lora"], c["batch"], c["draws"], mesh,
                                  attn_impl=impl, wan=True, **TRAIN_KW)
        out[tag] = {"metrics": metrics, "lora": lora}

    # TestVGGTTP: the VGGT split by vit_param_specs over dp 2 x tp 2
    c = inp["vggt"]
    vggt = load_jax_params(VGGT(VGGT_TINY), c["params"]).eval()
    vggt = shard_tree(vggt, vit_param_specs(vggt), dp_tp)
    with set_mesh(dp_tp), torch.no_grad():
        res = vggt_forward(vggt, _t(c["images"]), compute_dtype=torch.float32, dpt_chunk=4)
    out["vggt"] = {k: _np(res[k]) for k in ("pose_enc", "depth", "world_points")}

    # TestDiTTPBatch: the tiny DiT over dp 2 x tp 2, the batch split over data
    c = inp["dit_batch"]
    dit = _cog(COG_TINY, c["params"])
    full_numel = {n: p.numel() for n, p in dit.named_parameters()}
    specs = dit_param_specs(dit)
    dit = shard_tree(dit, specs, dp_tp)
    out["local_numel"] = {n: np.int64([p.numel(), full_numel[n]])
                          for n, p in dit.named_parameters() if any(specs[n])}
    # the bytes each sharded leaf's storage holds against its block's
    out["local_storage"] = {n: np.int64([p.untyped_storage().nbytes(),
                                         p.numel() * p.element_size()])
                            for n, p in dit.named_parameters() if any(specs[n])}
    batch = {k: _t(c[k]) for k in ("x", "txt", "t")}
    local = shard_tree(batch, batch_specs(batch), dp_tp)
    with set_mesh(dp_tp), torch.no_grad():
        out["dit_batch"] = {"rows": _np(dit_forward(dit, local["x"], local["txt"], local["t"],
                                                    compute_dtype=torch.float32)),
                            "data_rank": np.int64(axis_rank(dp_tp, "data"))}

    # tp 4 on the tiny DiT's 2 heads: every attention gathers its heads
    c = inp["dit_tp4"]
    dit4 = _cog(COG_TINY, c["params"])
    dit4 = shard_tree(dit4, dit_param_specs(dit4), tp4)
    with set_mesh(tp4), torch.no_grad():
        out["dit_tp4"] = _np(dit_forward(dit4, _t(c["x"]), _t(c["txt"]), _t(c["t"]),
                                         compute_dtype=torch.float32))

    # TestTPTrainingNumerics: one DPO step over dp 2 x tp 2, and at tp 4
    c = inp["train"]
    for tag, mesh in (("train_dp2_tp2", dp_tp), ("train_tp4", tp4)):
        model = _cog(COG_TINY, c["params"])
        model = shard_tree(model, dit_param_specs(model), mesh)
        metrics, lora = dpo_step(model, COG_TINY, c["lora"], c["batch"], c["draws"], mesh,
                                  **TRAIN_KW)
        out[tag] = {"metrics": metrics, "lora": lora}

    # __graft_entry__.dryrun_multichip, segments 1-4
    c = inp["dryrun"]
    model = _cog(COG_SMALL, c["base"])
    model = shard_tree(model, dit_param_specs(model), dp_tp)
    metrics, _ = dpo_step(model, COG_SMALL, c["lora"], c["batch"], c["draws"], dp_tp,
                           **DRYRUN_KW)
    out["seg1"] = metrics
    base_sp = _cog(COG_SMALL, c["base"])
    with set_mesh(sp), torch.no_grad():
        out["seg2"] = _np(dit_forward(base_sp, _t(c["x_sp"]), _t(c["e_sp"]),
                                      torch.tensor([500]), compute_dtype=torch.float32,
                                      attn_impl="ring"))
    metrics, lora = dpo_step(base_sp, COG_SMALL, c["lora_sp"], c["batch_sp"], c["draws_sp"],
                              sp, attn_impl="ring", **DRYRUN_KW)
    out["seg3"] = {"metrics": metrics, "lora": lora}

    # segment 4: the TP sampler on ranks 0-1, the DP VGGT scorer on ranks 2-3,
    # sub-meshes of one world (every rank makes both)
    gen_mesh = make_mesh(MeshAxes(model=2), device_type="cpu", ranks=[0, 1])
    score_mesh = make_mesh(MeshAxes(data=2), device_type="cpu", ranks=[2, 3])
    if rank < 2:
        gen = _cog(COG_SMALL, c["gen_params"])
        gen = shard_tree(gen, dit_param_specs(gen), gen_mesh)
        with set_mesh(gen_mesh), torch.no_grad():
            out["seg4_gen"] = _np(dit_forward(gen, _t(c["x_g"]), _t(c["e_g"]),
                                              torch.tensor([500]),
                                              compute_dtype=torch.float32))
    else:
        scorer = load_jax_params(VGGT(VGGT_TINY), c["vparams"]).eval()
        imgs = shard_tree(_t(c["imgs"]), P("data"), score_mesh)
        with set_mesh(score_mesh), torch.no_grad():
            out["seg4_depth"] = _np(vggt_forward(scorer, imgs, compute_dtype=torch.float32,
                                                 dpt_chunk=4)["depth"])
    out["rank"] = np.int64(dist.get_rank())
    return out


# ---------------------------------------------------------------------------
# sequence parallelism of the DiTs' residual streams
# ---------------------------------------------------------------------------

# lengths that neither tp 2 nor tp 4 divides: CogVideoX 3 x 5 x 7 = 105
# video and 8 text tokens, Wan 3 x 3 x 5 = 45 tokens
COG_SP = dataclasses.replace(COG_TINY, sample_height=10, sample_width=14)
WAN_SP_LATENT = (WAN_TP.in_channels, 3, 6, 10)
SP_TRAIN_KW = dict(TRAIN_KW, accumulate_grad_batches=2)


def grads_step(model, cfg, lora_np, batch, draws, mesh=None, wan=False):
    """One train-step call with accumulate 2 (no update yet): (metrics, the
    LoRA gradients the optimiser holds), numpy."""
    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.parallel.sharding import batch_specs, shard_tree
    from videogpa_torch.train.trainer import (
        TrainerConfig, init_train_state, make_dpo_train_step)
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    tcfg = TrainerConfig(compute_dtype=torch.float32, **SP_TRAIN_KW)
    lora = {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
            for n, ab in lora_np.items()}
    state = init_train_state(lora, tcfg)
    step, _ = (make_wan_dpo_train_step if wan else make_dpo_train_step)(model, cfg, tcfg)
    batch = {k: _t(v) for k, v in batch.items()}
    local = batch if mesh is None else shard_tree(batch, batch_specs(batch), mesh)
    with set_mesh(mesh):
        state, metrics = step(state, local, timesteps=_t(draws["timesteps"]),
                              noise=_t(draws["noise"]))
    names = [f"{n}.{k}" for n in lora for k in ("lora_A", "lora_B")]  # lora_leaves' order
    return ({k: np.float64(v) for k, v in metrics.items()},
            {n: _np(g) for n, g in zip(names, state.opt_state["acc_grads"])})


def _block_bytes(make, cfg, dim, forward, mesh, specs):
    """What one checkpointed block keeps for the backward on this rank: the
    bytes a remat forward saves through two blocks, less through one
    (``train.memory.saved_bytes``)."""
    from videogpa_torch.parallel import set_mesh
    from videogpa_torch.parallel.sharding import shard_tree
    from videogpa_torch.train.lora import lora_init
    from videogpa_torch.train.memory import saved_bytes

    saved = []
    for depth in (2, 1):
        torch.manual_seed(0)
        model = make(dataclasses.replace(cfg, num_layers=depth)).requires_grad_(False)
        if mesh is not None:
            model = shard_tree(model, specs(model), mesh)
        lora = lora_init(2, dim, 4, torch.Generator().manual_seed(1), device="cpu")
        with set_mesh(mesh):
            saved.append(saved_bytes(lambda: forward(model, lora),
                                     list(model.parameters()))[0])
    return np.int64(saved[0] - saved[1])


def seq_shard_cases(rank: int, workdir: str) -> dict:
    """Every multi-rank case of ``test_torch_seq_shard.py`` on this rank."""
    from videogpa_torch.convert import load_jax_params
    from videogpa_torch.models.cogvideox import CogVideoXTransformer, dit_forward
    from videogpa_torch.models.wan import WanTransformer, wan_forward
    from videogpa_torch.parallel import MeshAxes, make_mesh, set_mesh
    from videogpa_torch.parallel.sharding import dit_param_specs, shard_tree, wan_param_specs
    from videogpa_torch.train.lora import lora_leaves

    inp = _inputs(workdir, "seq_shard")
    meshes = {"dp2_tp2": make_mesh(MeshAxes(data=2, model=2), device_type="cpu"),
              "tp4": make_mesh(MeshAxes(model=4), device_type="cpu")}
    out: dict = {}
    def cog_shard(mesh):
        model = _cog(COG_SP, inp["cog"]["params"])
        return shard_tree(model, dit_param_specs(model), mesh)

    for tag, mesh in meshes.items():
        c = inp["cog"]
        model = cog_shard(mesh)
        out[f"cog_{tag}"] = grads_step(model, COG_SP, c["lora"], c["batch"], c["draws"], mesh)
        c = inp["wan"]
        wan = load_jax_params(WanTransformer(WAN_TP), c["params"]).requires_grad_(False)
        wan = shard_tree(wan, wan_param_specs(wan), mesh)
        out[f"wan_{tag}"] = grads_step(wan, WAN_TP, c["lora"], c["batch"], c["draws"], mesh,
                                       wan=True)

    # the bytes a remat block keeps on this rank, at tp 1 (no mesh), 2 and 4
    x = _t(inp["cog"]["batch"]["x_win"][:1]).transpose(1, 2)
    txt = _t(inp["cog"]["batch"]["prompt_emb"][:1])
    w = inp["wan"]["batch"]

    def cog_fwd(model, lora):
        return dit_forward(model, x, txt, torch.tensor([500]), compute_dtype=torch.float32,
                           lora=lora, remat=True)

    def wan_fwd(model, lora):
        return wan_forward(model, _t(w["x_win"][:1]), torch.tensor([500.0]),
                           _t(w["prompt_emb"][:1]), remat=True, compute_dtype=torch.float32,
                           lora=lora)

    for tag, mesh in (("tp1", None), *meshes.items()):
        out[f"cog_block_bytes_{tag}"] = _block_bytes(CogVideoXTransformer, COG_SP,
                                                     COG_SP.hidden_dim, cog_fwd, mesh,
                                                     dit_param_specs)
        out[f"wan_block_bytes_{tag}"] = _block_bytes(WanTransformer, WAN_TP, WAN_TP.dim, wan_fwd,
                                                     mesh, wan_param_specs)

    # the remat recompute runs in the backward: called after the mesh's
    # context has ended, it must still run under the mesh of the forward
    c = inp["cog"]
    lora = {n: {k: _t(v).requires_grad_(True) for k, v in ab.items()}
            for n, ab in c["lora"].items()}
    model = cog_shard(meshes["tp4"])
    grads = {}
    for where in ("inside", "after"):
        with set_mesh(meshes["tp4"]):
            y = cog_fwd(model, lora)
            if where == "inside":
                (y * y).sum().backward()
        if where == "after":
            (y * y).sum().backward()
        grads[where] = [_np(t.grad) for t in lora_leaves(lora)]
        for t in lora_leaves(lora):
            t.grad = None
    out["backward_after_the_mesh_context"] = np.float64(max(
        np.abs(a - b).max() for a, b in zip(grads["inside"], grads["after"])))
    return out
