"""The port's per-rank memory of the sharded DPO steps
(``videogpa_torch.train.memory``) against the JAX package's
(``videogpa_tpu/train/memory.py``), with no card and no compile.

- Argument bytes: JAX's ``argument_size_in_bytes`` of the step is the sum
  over its arguments of each device's shard: ``jax.eval_shape`` of
  ``dit_init`` / ``wan_init`` and ``lora_init`` + ``init_train_state`` and
  the batch, laid out by ``dit_param_specs`` / ``wan_param_specs`` /
  ``batch_specs`` on the 8-device CPU mesh, ``shard_shape`` x itemsize. The
  port's rank builds the same tensors under ``FakeTensorMode`` and the fake
  process group. JAX's 0-d counters (the optimiser's counts, the step) and
  the PRNG key are left out on both sides: the port keeps them on the host.
- ``tokens``: JAX's formula, with the patch_size_t trim.
- A tiny step reckoned on fake tensors: its figures add up, no kernel
  launches, and at tp 4 a remat block keeps a quarter of tp 1's rows, up to
  the padding.
- The attention wrappers on traced operands: a real call's allocations,
  no launch and no count.
- The command line, read as JAX's ``__main__`` reads it.

No JAX ``aot_*`` function is called: they compile and write a cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from videogpa_torch.models.cogvideox import CogVideoXConfig
from videogpa_torch.models.wan import WanConfig
from videogpa_torch.ops import attention as A
from videogpa_torch.train import memory as M
from videogpa_torch.train.trainer import TrainerConfig
from videogpa_tpu.models.cogvideox import CogVideoXConfig as JaxCogConfig
from videogpa_tpu.models.cogvideox import dit_init as jax_dit_init
from videogpa_tpu.models.wan import dit as jwan
from videogpa_tpu.models.wan.config import WanConfig as JaxWanConfig
from videogpa_tpu.parallel import MeshAxes
from videogpa_tpu.parallel import make_mesh as jax_make_mesh
from videogpa_tpu.parallel import sharding as jsh
from videogpa_tpu.train import lora as jlora
from videogpa_tpu.train import trainer as jtrainer

WAN_TINY_LATENT = (3, 8, 8)
CONFIGS = {
    "cog_tiny_i2v": CogVideoXConfig.tiny(i2v=True),
    "cog_tiny_pt2": dataclasses.replace(CogVideoXConfig.tiny(), patch_size_t=2, sample_frames=5),
    "wan_tiny": WanConfig.tiny(),
    "cogvideox_5b_i2v": CogVideoXConfig.cogvideox_5b_i2v(),
    "cogvideox_1_5_5b": CogVideoXConfig.cogvideox_1_5_5b(),
    "wan_ti2v_5b": WanConfig.ti2v_5b(),
}
# JAX's dry-run layouts: (dp, tp, global batch)
LAYOUTS = [(2, 4, 2), (1, 8, 1)]


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The fake process group ``rank_mesh`` starts, ended with the module."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _tcfg(name):
    rank = 64 if "5b" in name else 4
    return TrainerConfig(lora_rank=rank, lora_alpha=2.0 * rank, remat=True)


def _port(name, mesh, batch, **kw):
    cfg = CONFIGS[name]
    if isinstance(cfg, WanConfig):
        fhw = (21, 44, 80) if "5b" in name else WAN_TINY_LATENT
        return M.aot_wan_train_memory(mesh=mesh, batch_size=batch, latent_fhw=fhw,
                                      tcfg=_tcfg(name), cfg=cfg, **kw)
    return M.aot_train_memory(cfg, _tcfg(name), mesh=mesh, batch_size=batch, **kw)


def _jax_argument_bytes(name, dp, tp, batch):
    """Each device's shard bytes of the JAX step's array arguments."""
    cfg = CONFIGS[name]
    mesh = jax_make_mesh(MeshAxes(data=dp, model=tp))
    key = jax.random.PRNGKey(0)
    tc = _tcfg(name)
    if isinstance(cfg, WanConfig):
        jcfg = JaxWanConfig(**dataclasses.asdict(cfg))
        base = jax.eval_shape(lambda k: jwan.wan_init(k, jcfg, dtype=jnp.bfloat16), key)
        specs, dim = jsh.wan_param_specs(base), jcfg.dim
        fhw = (21, 44, 80) if "5b" in name else WAN_TINY_LATENT
        lat = (batch, jcfg.in_channels) + fhw
        prompt = (batch, jcfg.text_len, jcfg.text_dim)
    else:
        jcfg = JaxCogConfig(**dataclasses.asdict(cfg))
        base = jax.eval_shape(lambda k: jax_dit_init(k, jcfg, dtype=jnp.bfloat16), key)
        specs, dim = jsh.dit_param_specs(base), jcfg.hidden_dim
        lat = (batch, jcfg.out_channels, jcfg.sample_frames, jcfg.sample_height,
               jcfg.sample_width)
        prompt = (batch, jcfg.max_text_seq_length, jcfg.text_embed_dim)
    jt = jtrainer.TrainerConfig(lora_rank=tc.lora_rank, lora_alpha=tc.lora_alpha,
                                compute_dtype=jnp.bfloat16, remat=True, attn_impl="flash")
    lora = jax.eval_shape(lambda k: jlora.lora_init(k, jcfg.num_layers, dim, rank=jt.lora_rank),
                          key)
    state = jax.eval_shape(lambda lo: jtrainer.init_train_state(lo, jt), lora)
    batch_tree = {"x_win": jax.ShapeDtypeStruct(lat, jnp.float32),
                  "x_lose": jax.ShapeDtypeStruct(lat, jnp.float32),
                  "prompt_emb": jax.ShapeDtypeStruct(prompt, jnp.float32)}
    P = jax.sharding.PartitionSpec

    def total(tree, spec_tree):
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda s: isinstance(s, P))
        assert len(leaves) == len(spec_leaves)
        return sum(int(np.prod(NamedSharding(mesh, s).shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(leaves, spec_leaves) if x.ndim)

    return (total(base, specs) + total(state, jax.tree.map(lambda _: P(), state))
            + total(batch_tree, jsh.batch_specs(batch_tree)))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"dp{t[0]}_tp{t[1]}_b{t[2]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_argument_bytes_are_jaxs_shard_bytes(name, layout):
    """A rank's base shard, LoRA, AdamW moments and batch rows: the bytes
    JAX's step takes on each device at the same layout."""
    dp, tp, batch = layout
    got = _port(name, M.rank_mesh(dp, tp), batch, reckon=False)
    assert got["argument_bytes"] == _jax_argument_bytes(name, dp, tp, batch)
    assert got["mesh"] == {"data": dp, "model": tp} and got["global_batch_pairs"] == batch


def _jax_tokens(name):
    """JAX's ``tokens`` (memory.py:154-161 and the Wan step's)."""
    cfg = CONFIGS[name]
    if isinstance(cfg, WanConfig):
        F, H, W = (21, 44, 80) if "5b" in name else WAN_TINY_LATENT
        pt, ph, pw = cfg.patch_size
        return (F // pt) * (H // ph) * (W // pw)
    pt = cfg.patch_size_t or 1
    return ((cfg.sample_frames - cfg.sample_frames % pt) // pt
            * (cfg.sample_height // cfg.patch_size) * (cfg.sample_width // cfg.patch_size)
            + cfg.max_text_seq_length)


def test_tokens_are_jaxs():
    want = {"cogvideox_5b_i2v": 17_776, "cogvideox_1_5_5b": 41_026, "wan_ti2v_5b": 18_480}
    for name in CONFIGS:
        got = _port(name, M.ONE_DEVICE, 1, reckon=False)["tokens"]
        assert got == _jax_tokens(name), name
        assert want.get(name, got) == got, name


def test_tiny_step_reckons_on_fake_tensors_and_keeps_a_quarter_at_tp4():
    """The tiny step reckoned at tp 1 and at rank 0 of tp 4 (105 video + 8
    text tokens: tp 4 divides neither): the figures add up, nothing
    launches, and a remat block keeps ceil(n / 4) rows of each stream."""
    cfg = dataclasses.replace(CogVideoXConfig.tiny(), num_heads=4, head_dim=64,
                              sample_height=10, sample_width=14)
    tc = TrainerConfig(lora_rank=4, lora_alpha=8.0, remat=True)
    counts = {f: f.launches for f in (A.flash_attn_fwd, A.flash_attn_bwd, A.flash_attn_short)}
    out = {tp: M.aot_train_memory(cfg, tc, mesh=M.rank_mesh(1, tp) if tp > 1 else M.ONE_DEVICE,
                                  batch_size=1)
           for tp in (1, 4)}
    assert {f: f.launches for f in counts} == counts
    for tp, r in out.items():
        assert r["alias_gib"] == 0.0 and r["peak_by_category_gib"]["backward"] >= 0
        assert r["per_device_hbm_bytes"] > r["argument_bytes"] > 0
        by_cat = r["peak_by_category_gib"]
        assert sum(by_cat.values()) == pytest.approx(r["per_device_hbm_gib"], abs=2e-3)
        rows = [-(-105 // tp), -(-8 // tp)]
        assert r["block_residual_bytes"] == sum(-(-n * 256 * 2 // 512) * 512 for n in rows)
        assert r["residual_gib"] == round(2 * cfg.num_layers * r["block_residual_bytes"] / 2**30,
                                          3)
    # a quarter of the 113 rows, up to the 3 + 0 pad rows of tp 4's blocks
    quarter = out[4]["block_residual_bytes"] / out[1]["block_residual_bytes"]
    assert 0.25 <= quarter <= 0.25 * (108 + 8) / 113


class _Allocations(TorchDispatchMode):
    """(shape, dtype) of every tensor an operation dispatched in the mode makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.made += [(tuple(t.shape), t.dtype) for t in torch.utils._pytree.tree_leaves(out)
                      if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("D", [64, 128])
def test_traced_operands_allocate_as_a_real_call_and_launch_nothing(D):
    """K1/K3 (D 64) and K6/K7 (D 128) on traced operands: O and the LSE,
    then the backward's f32 scratch as ``bwd_splits`` and ``_launch_bwd``
    prescribe (base-2 LSE and delta padded to whole query tiles, the dQ
    accumulator, dK/dV partials for a split query range) and the gradients;
    no launch is counted. A plain meta tensor still raises, and a traced
    operand is still held to the 16-byte stride rule."""
    fwd, bwd, q_tile = ((A.flash_attn_fwd, A.flash_attn_bwd, A.BWD_QUERIES) if D == 64 else
                        (A.flash_attn_fwd_d128, A.flash_attn_bwd_d128, A.BWD_D128_QUERIES))
    B, Nq, Nk, H = 1, 1000, 300, 2
    counts = (fwd.launches, bwd.launches)
    bf16, f32 = torch.bfloat16, torch.float32
    with FakeTensorMode():
        q = torch.empty(B, Nq, H, D, device="meta", dtype=bf16)
        k = torch.empty(B, Nk, H, D, device="meta", dtype=bf16)
        assert A.traced(q) and A._on_card(q)
        made = _Allocations()
        with made:
            o, lse = fwd(q, k, k, layout="bnhd", with_lse=True)
        assert made.made == [((B, Nq, H, D), bf16), ((B, H, Nq), f32)]
        splits, _ = A.bwd_splits(B * H, Nq, Nk, q_tile)
        assert splits > 1
        nq_pad, nk_pad = -(-Nq // q_tile) * q_tile, -(-Nk // A.BWD_KEYS) * A.BWD_KEYS
        made = _Allocations()
        with made:
            grads = bwd(q, k, k, o, lse, torch.empty_like(q), layout="bnhd")
        # the dO operand made above, then the wrapper's own allocations
        assert made.made == [((B, Nq, H, D), bf16), ((B * H, nq_pad), f32),
                             ((B * H, nq_pad), f32), ((B * H, nq_pad, D), f32),
                             ((splits, B * H, nk_pad, D), f32), ((splits, B * H, nk_pad, D), f32),
                             ((B, Nq, H, D), bf16), ((B, Nk, H, D), bf16), ((B, Nk, H, D), bf16)]
        assert [tuple(g.shape) for g in grads] == [(B, Nq, H, D), (B, Nk, H, D), (B, Nk, H, D)]
        odd = torch.empty(B, Nq, H, D + 4, device="meta", dtype=bf16)[..., :D]  # 8-byte rows
        with pytest.raises(ValueError, match="16-byte"):
            fwd(odd, k, k, layout="bnhd")
    assert (fwd.launches, bwd.launches) == counts
    plain = torch.empty(B, Nq, H, D, device="meta", dtype=bf16)
    with pytest.raises(ValueError, match="unsupported device"):
        fwd(plain, plain, plain)


def test_command_line_reads_as_jaxs():
    """``[cogvideox|wan|cog15] [DPxTP] [batch]`` as JAX's ``__main__`` reads
    them (an unknown model is CogVideoX), ``--measure``, and the refused
    ``@topology``."""
    assert M.parse_args([]) == (M.aot_train_memory, {"measure": False})
    assert M.parse_args(["wan"]) == (M.aot_wan_train_memory, {"measure": False})
    assert M.parse_args(["cog15", "1x8", "1"]) == (
        M.aot_cog15_train_memory, {"measure": False, "mesh": (1, 8), "batch_size": 1})
    assert M.parse_args(["other", "2x4", "--measure"]) == (
        M.aot_train_memory, {"measure": True, "mesh": (2, 4)})
    with pytest.raises(SystemExit, match="topology"):
        M.parse_args(["cogvideox", "2x4@v5e:2x4"])
