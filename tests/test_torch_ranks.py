"""The plan of ``chip_smoke.py --ranks 4``, the port's multi-card run over
NCCL, on the CPU: its meshes against the JAX package's dry-run layout, each
rank's rows against ``batch_specs`` on meshes over PyTorch's fake process
group, the per-rank launch formulas against the wrappers a tiny step calls,
and the mode's refusal on a host without four cards. No JAX here: the dry
run's layout rule is read from ``__graft_entry__.py``'s source."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs
from videogpa_torch.models.cogvideox import CogVideoXConfig, dit_init
from videogpa_torch.models.wan import WanConfig, wan_init
from videogpa_torch.ops import attention as A
from videogpa_torch.ops import ring_attention as ring
from videogpa_torch.parallel import MeshAxes, make_mesh
from videogpa_torch.parallel.sharding import batch_specs, shard_tree
from videogpa_torch.train.lora import lora_init
from videogpa_torch.train.trainer import TrainerConfig, init_train_state, make_dpo_train_step
from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """No group of an earlier test in this process; the fake groups started
    here end with the module."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _fake_world(rank: int, world: int = cs.RANKS_WORLD) -> None:
    """PyTorch's fake process group as ``rank`` of ``world`` (collectives
    move nothing: the meshes' layouts are what is checked)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def _dry_run_rule(n_devices: int):
    """(dp, tp, the generator's devices, the scorer's devices) by the lines of
    ``__graft_entry__.dryrun_multichip`` that lay them out, run on
    ``n_devices``."""
    with open(os.path.join(ROOT, "__graft_entry__.py")) as f:
        src = f.read()
    rule = {}
    for name in ("dp", "tp", "half"):
        m = re.search(rf"^    {name} = (.+)$", src, re.M)
        assert m, f"__graft_entry__.py lays out no {name}"
        rule[name] = eval(m.group(1), {}, {"n_devices": n_devices, **rule})
    devs = list(range(n_devices))
    assert "devs[:half]" in src and "devs[half:]" in src
    return rule["dp"], rule["tp"], devs[:rule["half"]], devs[rule["half"]:]


def test_plan_is_the_dry_runs_layout_at_four():
    dp, tp, gen, score = _dry_run_rule(4)
    plan = cs.ranks_plan(4)
    assert list(plan) == ["data", "seq", "model", "dp_tp", "gen", "score"]
    assert plan["dp_tp"] == ({"data": dp, "model": tp}, None) == ({"data": 2, "model": 2}, None)
    assert plan["gen"] == ({"model": len(gen)}, gen) == ({"model": 2}, [0, 1])
    assert plan["score"] == ({"data": len(score)}, score) == ({"data": 2}, [2, 3])
    assert plan["data"][0] == {"data": 4} and plan["seq"][0] == {"seq": 4}
    assert plan["model"][0] == {"model": 4}
    for axes, ranks in plan.values():  # each mesh's axes cover its ranks
        assert MeshAxes(**axes).size == (4 if ranks is None else len(ranks))
    for phase, meshes in cs.RANKS_PHASE_MESH.items():
        assert phase in cs.RANKS_PHASES and all(m in plan for m in meshes)


@pytest.mark.parametrize("name", ["data", "seq", "model", "dp_tp", "gen", "score"])
def test_coordinates_are_the_device_meshes(name):
    axes, ranks = cs.ranks_plan(4)[name]
    for rank in range(4):
        _fake_world(rank)
        mesh = make_mesh(MeshAxes(**axes), device_type="cpu", ranks=ranks)
        got = mesh.get_coordinate()
        assert cs.ranks_coord(axes, ranks, rank) == (None if got is None else tuple(got))


@pytest.mark.parametrize("phase", sorted(cs.RANKS_BATCH))
def test_rows_are_batch_specs_slices(phase):
    """Each rank's rows of the phase's global batch are the block
    ``shard_tree(batch, batch_specs(batch), mesh)`` keeps on its mesh."""
    axes, ranks = cs.ranks_plan(4)[cs.RANKS_PHASE_MESH[phase][-1]]
    B = cs.RANKS_BATCH[phase]
    batch = {"x_win": torch.arange(B * 3.0).reshape(B, 3), "prompt_emb": torch.randn(B, 2, 5)}
    seen = []
    for rank in range(4):
        _fake_world(rank)
        mesh = make_mesh(MeshAxes(**axes), device_type="cpu", ranks=ranks)
        rows = cs.ranks_rows(phase, rank)
        if mesh.get_coordinate() is None:
            assert rows is None
            continue
        local = shard_tree(batch, batch_specs(batch), mesh)
        for k, v in batch.items():
            assert torch.equal(local[k], v[rows.start:rows.stop])
        seen += list(rows)
    # the data ranks hold the whole batch between them, each row once a replica
    assert sorted(set(seen)) == list(range(B))
    assert len(seen) == B * (len(ranks) if ranks else 4) // axes.get("data", 1)


@pytest.mark.parametrize("n,P", [(17776, 4), (41026, 4), (9, 4), (10, 4), (4, 4)])
def test_ring_pairs_are_the_shards_with_keys(n, P):
    """A rank's ring launches one pair a resident shard with keys: every
    shard of a length P divides, and of a padded one the full shards and the
    partial one (9 = 3 + 3 + 3 + 0 keys: one shard empty)."""
    L = -(-n // P)
    keys = [max(0, min(L, n - s * L)) for s in range(P)]
    assert cs.ranks_ring_pairs(n, P) == sum(k > 0 for k in keys)
    validity = ring._shard_validity(n, L) if L * P != n else None
    assert [ring._resident_keys(s, L, validity) for s in range(P)] == keys


def test_launch_formulas_at_full_size():
    L = CogVideoXConfig.cogvideox_5b().num_layers
    wan_L = WanConfig.ti2v_5b().num_layers
    # [train]'s and [wan-train]'s counts a mini-step: one launch an attention
    # a rank, whatever its share of the heads or of the batch
    assert cs.ranks_launches("ranks_train", 0) == {"flash_attn_fwd": 252, "flash_attn_bwd": 84}
    assert cs.ranks_launches("ranks_cog15_train", 3) == {"flash_attn_fwd": 6 * L,
                                                        "flash_attn_bwd": 2 * L}
    assert cs.ranks_launches("ranks_wan_train", 1) == {"flash_attn_fwd_d128": 12 * wan_L,
                                                      "flash_attn_bwd_d128": 4 * wan_L} == {
        "flash_attn_fwd_d128": 360, "flash_attn_bwd_d128": 120}
    # under seq 4 each attention is a ring of 4 pairs (17,776 = 4 x 4,444)
    assert cs.ranks_launches("ranks_seq_train", 2) == {"flash_attn_fwd": 4 * 252,
                                                      "flash_attn_bwd": 4 * 84}
    # 17,776 and 41,026 tokens: 4 pairs each (41,026 = 3 x 10,257 + 10,255)
    assert cs.ranks_launches("ranks_ring", 0) == {"flash_attn_fwd": 8, "flash_attn_bwd": 8}
    # the sampler's ranks: one CFG-pair forward; the scorer's: [scorer]'s batch
    assert cs.ranks_launches("ranks_overlap", 1) == {"flash_attn_fwd": L}
    assert cs.ranks_launches("ranks_overlap", 2) == {
        "flash_attn_fwd": 24, "flash_attn_short": 48, "flash_attn_fwd_f32": 16}
    with pytest.raises(ValueError):
        cs.ranks_launches("ranks_nccl", 0)


_FORWARDS = ("flash_attn_fwd", "flash_attn_short", "flash_attn_fwd_f32", "flash_attn_fwd_d128")
_BACKWARDS = ("flash_attn_bwd", "flash_attn_bwd_f32", "flash_attn_bwd_d128")


def _count_calls(monkeypatch) -> dict:
    """Count the calls of each attention wrapper (one launch each on the card;
    their plain versions here)."""
    calls = dict.fromkeys(_FORWARDS + _BACKWARDS, 0)
    for name in calls:
        fn = getattr(A, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(A, name, counted)
    return calls


@pytest.mark.parametrize("model", ["cogvideox", "wan"])
def test_a_step_calls_six_forwards_and_two_backwards_an_attention(model, monkeypatch):
    """The premise of the DPO formulas: one train-step call runs every
    attention of the model in 6 forwards (2 policy, their 2 remat
    recomputes, 2 reference) and 2 backwards, one wrapper call each."""
    tcfg = TrainerConfig(compute_dtype=torch.float32, warmup_steps=0, lora_rank=4,
                         lora_alpha=8.0, remat=True)
    g = torch.Generator().manual_seed(0)
    if model == "cogvideox":
        cfg = CogVideoXConfig.tiny()
        net = dit_init(cfg, g, device="cpu").requires_grad_(False)
        step = make_dpo_train_step(net, cfg, tcfg)[0]
        lat = (1, cfg.vae_latent_channels, cfg.sample_frames, cfg.sample_height,
               cfg.sample_width)
        text = (1, cfg.max_text_seq_length, cfg.text_embed_dim)
        dim, attns = cfg.hidden_dim, cfg.num_layers
    else:
        cfg = WanConfig.tiny()
        net = wan_init(cfg, g, device="cpu").requires_grad_(False)
        step = make_wan_dpo_train_step(net, cfg, tcfg)[0]
        lat = (1, cfg.in_channels, 3, 4, 6)
        text = (1, cfg.text_len, cfg.text_dim)
        dim, attns = cfg.dim, 2 * cfg.num_layers  # self- and cross-attention
    batch = {"x_win": torch.randn(lat, generator=g), "x_lose": torch.randn(lat, generator=g),
             "prompt_emb": torch.randn(text, generator=g)}
    state = init_train_state(lora_init(cfg.num_layers, dim, 4, g, device="cpu"), tcfg)
    calls = _count_calls(monkeypatch)
    step(state, batch, generator=g)
    assert sum(calls[n] for n in _FORWARDS) == 6 * attns
    assert sum(calls[n] for n in _BACKWARDS) == 2 * attns


def test_kernel_overlap_reads_a_chrome_trace(tmp_path):
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
         "ts": 100.0, "dur": 50.0},
        {"cat": "kernel", "name": "void flash_attn_fwd_kernel<64>(CUtensorMap_st)", "ts": 120.0,
         "dur": 100.0},
        {"cat": "kernel", "name": "flash_attn_bwd_main", "ts": 300.0, "dur": 40.0},
        {"cat": "kernel", "name": "ncclDevKernel_SendRecv", "ts": 330.0, "dur": 30.0},
        {"cat": "kernel", "name": "elementwise_kernel", "ts": 400.0, "dur": 30.0},
        {"cat": "cpu_op", "name": "flash_attn_fwd", "ts": 0.0, "dur": 1000.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    got = cs._kernel_overlap(str(path))
    assert got == {"nccl_ms": 0.08, "attention_ms": 0.14, "overlap_ms": 0.04,
                   "nccl_kernels": 2, "attention_kernels": 2}


@pytest.mark.parametrize("argv,rc", [(["--ranks", "4"], 1), (["--ranks", "3"], 2),
                                     (["--ranks", "4", "--phases", "ranks_nccl,nope"], 2)])
def test_ranks_mode_refuses_this_host(argv, rc, tmp_path):
    """No fallback: without four CUDA devices (or with a count or a phase it
    does not take) the mode exits non-zero with its message and prints no
    result, from the checkout and from a directory holding the script
    alone."""
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text(open(os.path.join(ROOT, script)).read())
        p = subprocess.run([sys.executable, script, *argv], cwd=cwd, capture_output=True,
                           text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode == rc, p.stderr
        assert "chip_smoke: --ranks" in p.stderr
        assert '"ok"' not in p.stdout
