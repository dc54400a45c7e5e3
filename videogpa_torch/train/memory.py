"""Per-rank memory of the sharded 5B DPO train steps
(``videogpa_tpu/train/memory.py``).

The reference trains CogVideoX-5B and Wan2.2-TI2V-5B DPO on 8 GPUs with
Lightning DDP (``train/CogVideoX-I2V-5B/03_train.py:249-258``). The JAX
package shows that its sharded step fits a device by compiling it against a
TPU topology it never runs and reading ``memory_analysis()``. The port does
the same for one rank of a mesh the machine need not have:

- ``rank_mesh(dp, tp, rank)`` starts PyTorch's *fake* process group (a
  ``FakeStore`` at world size dp·tp, whose collectives return at once and
  move nothing) and lays the data × model mesh over it: the counterpart of
  ``tpu_topology_mesh``;
- the step runs on this rank's shard of the base DiT (``dit_param_specs`` /
  ``wan_param_specs``), the LoRA and optimiser state and this rank's rows of
  the batch, under ``FakeTensorMode``: no tensor has storage and no kernel
  launches (the attention wrappers take traced operands on the card's route,
  ``ops.attention.traced``), while a dispatch mode adds up the bytes alive
  after each operation, by category, rounded as the CUDA caching allocator
  rounds a block: the counterpart of the ahead-of-time compile. The traced
  tensors sit on "cuda" where PyTorch is built with CUDA, else on "meta";
- with ``measure=True`` the same rank's step runs for real on the card, its
  kernels launching (K1/K3 for CogVideoX, K6/K7 for Wan), and
  ``torch.cuda.max_memory_allocated`` is reported beside the reckoning.

Under the fake group a rank's collectives leave their outputs as they were
made (an all-gather's output uninitialised), so a measured rank's loss may
be NaN: nothing here asserts finiteness. A measured rank holds no NCCL
buffers either: a real rank of an 8-card job adds NCCL's own (not counted
by ``max_memory_allocated``, which counts PyTorch's allocator alone).

The port updates the LoRA and optimiser state in place and donates nothing,
so the step's outputs are its metrics and ``alias_gib`` is 0. The JAX
package's ``make_dpo_train_step_unbound`` (its step traced on abstract
params) has no counterpart: the port's steps take the rank's shard as it
is built here.

``python -m videogpa_torch.train.memory [cogvideox|wan|cog15] [DPxTP]
[batch] [--measure]`` prints the figures as JSON, as the JAX module's
``__main__`` does.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, MeshAxes, axis_size, local_slice, make_mesh, set_mesh)
from videogpa_torch.train.lora import TARGETS
from videogpa_torch.train.trainer import TrainerConfig, init_train_state

_GIB = 2 ** 30
# the CUDA caching allocator hands out blocks in multiples of 512 bytes
_BLOCK = 512
# ``mesh`` value for the step on one device under no mesh (as the
# single-card train paths run it)
ONE_DEVICE = "one-device"
CATEGORIES = ("argument", "forward", "backward")


def _rounded(nbytes: int) -> int:
    return -(-nbytes // _BLOCK) * _BLOCK


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive after each operation dispatched while
    the mode is on, and their peak, by category: "argument" (tensors handed
    to ``track`` before the step), "forward" (made outside the backward: the
    forwards and what autograd keeps of them, the loss, the optimiser's
    temporaries) and "backward" (made while an autograd node runs: the
    recomputed blocks, the gradients, the kernels' scratch). A storage counts
    once, from its first tensor to its death (a weakref callback), rounded
    to the allocator's 512-byte blocks. Enter it inside ``FakeTensorMode`` to
    reckon a step without memory, or around real tensors."""

    def __init__(self):
        super().__init__()
        self._live: Dict[int, tuple] = {}
        self.now = dict.fromkeys(CATEGORIES, 0)
        self.peak = dict(self.now)

    @property
    def peak_bytes(self) -> int:
        return sum(self.peak.values())

    def track(self, t: torch.Tensor, category: str) -> None:
        st = _storage(t)
        key = st._cdata
        if key in self._live:
            return
        n = _rounded(st.nbytes())
        self._live[key] = (category, n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.now[category] += n
        if sum(self.now.values()) > self.peak_bytes:
            self.peak = dict(self.now)

    def _free(self, key: int) -> None:
        category, n, _ = self._live.pop(key)
        self.now[category] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        category = "backward" if torch._C._current_autograd_node() is not None else "forward"
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t, category)
        return out


def _bytes(tensors: Sequence[torch.Tensor], blocks: bool = False) -> int:
    """Bytes of the distinct storages of ``tensors``, in whole allocator
    blocks with ``blocks``."""
    seen = {_storage(t)._cdata: _storage(t).nbytes() for t in tensors}
    return sum(map(_rounded, seen.values())) if blocks else sum(seen.values())


def saved_bytes(run, exclude: Sequence[torch.Tensor] = ()):
    """(bytes of the distinct storages autograd saves for the backward while
    ``run()`` runs, outside recomputed regions and apart from the storages
    of ``exclude``; ``run()``'s result). The checkpointed blocks keep their
    inputs so; the tensors they save inside are recomputed and not seen."""
    skip = {_storage(t)._cdata for t in exclude}
    seen: Dict[int, int] = {}

    def pack(t):
        st = _storage(t)
        if st._cdata not in skip:
            seen[st._cdata] = _rounded(st.nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    return sum(seen.values()), out


def rank_mesh(dp: int = 2, tp: int = 4, rank: int = 0):
    """This ``rank``'s view of a ``MeshAxes(data=dp, model=tp)`` mesh over
    the fake process group at world size dp·tp: the counterpart of
    ``tpu_topology_mesh``, a layout reckoned for without its devices. A fake
    group already started is replaced; another group raises (a process
    holds one default group: run each layout in a process of its own)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group is already initialised: rank_mesh starts "
                               "the fake group in a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=dp * tp)
    return make_mesh(MeshAxes(data=dp, model=tp),
                     device_type="cuda" if torch.cuda.is_available() else "cpu")


def _traced_device() -> str:
    """Where traced tensors sit: "cuda" where PyTorch is built with CUDA; a
    CPU-only build records no CUDA device in autograd, so "meta" there."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _rank_module(module, specs_of, cfg, mesh, device) -> nn.Module:
    """``module(cfg)`` with each parameter an empty one of this rank's shard
    shape (``specs_of``'s, as ``shard_tree`` splits them) on ``device``: the
    module is built on "meta", so no whole tensor is made on the way."""
    model = module(cfg, device="meta", dtype=torch.bfloat16)
    specs = specs_of(model)
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            spec = specs[f"{mod_name}.{name}" if mod_name else name]
            sharded = mesh is not None and any(spec)
            shape = local_slice(p, spec, mesh).shape if sharded else p.shape
            mod._parameters[name] = nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device=device), requires_grad=False)
    return model


def _lora(num_layers: int, dim: int, rank: int, device, real: bool) -> dict:
    """A stacked LoRA tree of ``lora_init``'s shapes: B zero, A random for
    ``real`` tensors (the values count only there)."""
    out = {}
    for name in TARGETS:
        a = torch.empty((num_layers, rank, dim), dtype=torch.float32, device=device)
        if real:
            a.uniform_(-dim ** -0.5, dim ** -0.5)
        out[name] = {"lora_A": a,
                     "lora_B": torch.zeros((num_layers, dim, rank), dtype=torch.float32,
                                           device=device)}
    return out


@dataclasses.dataclass
class _Family:
    """What differs between the CogVideoX and the Wan step."""

    module: Any
    specs: Any
    make_step: Any
    forward: Any  # (model, lora, batch, tcfg) -> a policy forward's output
    dim: int
    batch_shapes: Dict[str, tuple]
    tokens: int


def _cog_family(cfg: CogVideoXConfig, batch: int) -> _Family:
    from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward
    from videogpa_torch.parallel.sharding import dit_param_specs
    from videogpa_torch.train.trainer import make_dpo_train_step

    pt = cfg.patch_size_t or 1
    frames = cfg.sample_frames - cfg.sample_frames % pt
    lat = (batch, cfg.out_channels, cfg.sample_frames, cfg.sample_height, cfg.sample_width)

    def forward(model, lora, b, tcfg):
        x = b["x_win"].transpose(1, 2)[:, :frames]
        if cfg.in_channels > cfg.out_channels:
            x = torch.cat([x, torch.zeros_like(x)], dim=2)
        t = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        return dit_forward(model, x, b["prompt_emb"], t, compute_dtype=tcfg.compute_dtype,
                           lora=lora, lora_scaling=tcfg.lora_alpha / tcfg.lora_rank,
                           attn_layout="bnhd", remat=tcfg.remat, attn_impl=tcfg.attn_impl)

    return _Family(
        CogVideoXTransformer, dit_param_specs, make_dpo_train_step, forward,
        cfg.hidden_dim,
        {"x_win": lat, "x_lose": lat,
         "prompt_emb": (batch, cfg.max_text_seq_length, cfg.text_embed_dim)},
        # DiT tokens as the step sees them: F trimmed to a multiple of
        # patch_size_t and patchified by it (trainer.py's 1.5 trim)
        frames // pt * (cfg.sample_height // cfg.patch_size)
        * (cfg.sample_width // cfg.patch_size) + cfg.max_text_seq_length)


def _wan_family(cfg, batch: int, latent_fhw) -> _Family:
    from videogpa_torch.models.wan.dit import WanTransformer, wan_forward
    from videogpa_torch.models.wan.flow_match import ti2v_timestep_tokens
    from videogpa_torch.parallel.sharding import wan_param_specs
    from videogpa_torch.train.wan_trainer import make_wan_dpo_train_step

    F, H, W = latent_fhw
    pt, ph, pw = cfg.patch_size
    lat = (batch, cfg.in_channels, F, H, W)

    def forward(model, lora, b, tcfg):
        t = torch.ones(b["x_win"].shape[0], device=b["x_win"].device)
        return wan_forward(model, b["x_win"], ti2v_timestep_tokens(t, (F, H, W), cfg.patch_size),
                           b["prompt_emb"], remat=tcfg.remat, compute_dtype=tcfg.compute_dtype,
                           lora=lora, lora_scaling=tcfg.lora_alpha / tcfg.lora_rank,
                           attn_impl=tcfg.attn_impl)

    return _Family(WanTransformer, wan_param_specs, make_wan_dpo_train_step, forward,
                   cfg.dim, {"x_win": lat, "x_lose": lat,
                             "prompt_emb": (batch, cfg.text_len, cfg.text_dim)},
                   (F // pt) * (H // ph) * (W // pw))


def _launch_counts() -> Dict[str, int]:
    from videogpa_torch.ops import attention as A

    return {f.__name__: f.launches for f in (A.flash_attn_fwd, A.flash_attn_bwd,
                                             A.flash_attn_short, A.flash_attn_fwd_d128,
                                             A.flash_attn_bwd_d128)}


def _rank_step(fam: _Family, cfg, tcfg: TrainerConfig, mesh, device: str, real: bool):
    """The rank's step built on ``device``: (step, state, batch, model, its
    arguments). Real tensors get random values (the values do not count
    towards memory; the kernels run on finite numbers)."""
    model = _rank_module(fam.module, fam.specs, cfg, mesh, device)
    if real:
        with torch.no_grad():
            for p in model.parameters():
                p.uniform_(-0.02, 0.02)
    lora = _lora(cfg.num_layers, fam.dim, tcfg.lora_rank, device, real)
    state = init_train_state(lora, tcfg)
    k = tcfg.accumulate_grad_batches
    if k > 1:  # reckon the mini-step that makes the update
        state.opt_state["mini_step"] = k - 1
    batch = {name: (torch.randn if real else torch.empty)(shape, device=device)
             for name, shape in fam.batch_shapes.items()}
    step, _ = fam.make_step(model, cfg, tcfg)
    args = (list(model.parameters()) + [t for ab in lora.values() for t in ab.values()]
            + [t for key in ("mu", "nu", "acc_grads") for t in state.opt_state.get(key, [])]
            + list(batch.values()))
    return step, state, batch, model, args


def _reckon(fam: _Family, cfg, tcfg, mesh, device: str) -> Dict[str, Any]:
    """The rank's step under ``FakeTensorMode``: peak live bytes by
    category, argument and output bytes, and the bytes the checkpointed
    blocks keep for the backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), set_mesh(mesh):
        step, state, batch, model, args = _rank_step(fam, cfg, tcfg, mesh, device, real=False)
        counter = LiveBytes()
        for t in args:
            counter.track(t, "argument")
        before = _launch_counts()
        with counter:
            _, metrics = step(state, batch)
        if _launch_counts() != before:
            raise RuntimeError("a traced step launched a kernel")
        # what a checkpointed block keeps for the backward (its inputs): the
        # bytes a policy forward saves through two blocks, less through one
        saved = []
        for depth in (2, 1):
            m = _rank_module(fam.module, fam.specs, dataclasses.replace(cfg, num_layers=depth),
                             mesh, device)
            saved.append(saved_bytes(lambda: fam.forward(m, state.lora, batch, tcfg),
                                     args + list(m.parameters()))[0])
    return {"peak": counter.peak, "peak_bytes": counter.peak_bytes,
            "argument_bytes": _bytes(args), "argument_blocks": _bytes(args, blocks=True),
            "output_bytes": _bytes(list(metrics.values()), blocks=True),
            "block_residual_bytes": saved[0] - saved[1]}


def _argument_bytes(fam: _Family, cfg, tcfg, mesh, device: str) -> int:
    """The bytes of the rank's step arguments, built under ``FakeTensorMode``
    with no step run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _bytes(_rank_step(fam, cfg, tcfg, mesh, device, real=False)[-1])


def _measure(fam: _Family, cfg, tcfg, mesh, device: str) -> Dict[str, Any]:
    """The rank's step for real on the card: its peak allocated bytes and the
    attention kernels' launches."""
    with set_mesh(mesh):
        step, state, batch, _, _ = _rank_step(fam, cfg, tcfg, mesh, device, real=True)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = _launch_counts()
        step(state, batch)
        torch.cuda.synchronize(device)
    after = _launch_counts()
    return {"peak_bytes": torch.cuda.max_memory_allocated(device),
            "launches": {k: after[k] - before[k] for k in after}}


def _default_tcfg(attn_impl: str = "auto") -> TrainerConfig:
    """JAX's defaults: LoRA r 64, alpha 128, bf16 base, remat, the flash
    kernels (the port's "auto")."""
    return TrainerConfig(lora_rank=64, lora_alpha=128.0, compute_dtype=torch.bfloat16,
                         remat=True, attn_impl=attn_impl)


def _train_memory(fam_of, cfg, tcfg, mesh, batch_size: int, device, measure: bool,
                  reckon: bool):
    if torch.device(device).type != "cuda":
        raise ValueError(f"the reckoning is of the card's step: device must be cuda, got {device}")
    if mesh is None:
        mesh = rank_mesh()
    elif mesh == ONE_DEVICE:
        mesh = None
    dp = 1 if mesh is None else axis_size(mesh, DATA_AXIS)
    if batch_size % dp:
        raise ValueError(f"global batch {batch_size} does not split over data = {dp}")
    fam = fam_of(batch_size // dp)
    stats = {
        "platform": "cuda",
        "mesh": ({"data": 1, "model": 1} if mesh is None else
                 {"data": dp, "model": axis_size(mesh, MODEL_AXIS)}),
        "global_batch_pairs": batch_size,
        "tokens": fam.tokens,
        "attn_impl": tcfg.attn_impl,
    }
    if reckon:
        stats.update(_figures(_reckon(fam, cfg, tcfg, mesh, _traced_device()), cfg))
    else:
        n = _argument_bytes(fam, cfg, tcfg, mesh, _traced_device())
        stats.update(argument_gib=round(n / _GIB, 3), argument_bytes=n)
    if measure:
        m = _measure(fam, cfg, tcfg, mesh, device)
        stats["measured_peak_bytes"] = int(m["peak_bytes"])
        stats["measured_peak_gib"] = round(m["peak_bytes"] / _GIB, 3)
        stats["measured_launches"] = m["launches"]
    return stats


def _figures(r: Dict[str, Any], cfg) -> Dict[str, Any]:
    """JAX's figures (and the port's own) of a reckoning ``r``."""
    total = r["peak_bytes"]
    return {
        "per_device_hbm_bytes": int(total),
        "per_device_hbm_gib": round(total / _GIB, 3),
        "argument_gib": round(r["argument_bytes"] / _GIB, 3),
        "temp_gib": round((total - r["argument_blocks"] - r["output_bytes"]) / _GIB, 3),
        "output_gib": round(r["output_bytes"] / _GIB, 3),
        "alias_gib": 0.0,
        "peak_by_category_gib": {k: round(v / _GIB, 3) for k, v in r["peak"].items()},
        "argument_bytes": int(r["argument_bytes"]),
        # both policy forwards hold every block's inputs until the backward
        "residual_gib": round(2 * cfg.num_layers * r["block_residual_bytes"] / _GIB, 3),
        "block_residual_bytes": int(r["block_residual_bytes"]),
    }


def aot_train_memory(cfg: Optional[CogVideoXConfig] = None,
                     tcfg: Optional[TrainerConfig] = None, mesh=None, batch_size: int = 2,
                     device="cuda", measure: bool = False,
                     reckon: bool = True) -> Dict[str, Any]:
    """This rank's memory in the CogVideoX DPO train step.

    ``batch_size`` is the GLOBAL preference-pair batch (split over the
    ``data`` axis). Default cfg/tcfg is the CogVideoX-5B-I2V operating point
    of the JAX module: 42 layers, hidden 3,072, 49f@480x720 latents (17,776
    tokens with the text), LoRA r 64, remat, bf16 base. ``mesh`` is a mesh
    of ``rank_mesh`` (default: rank 0 of JAX's dp 2 x tp 4), or
    ``ONE_DEVICE`` for the step on one card under no mesh. ``device`` is the
    card the figures are for; ``measure=True`` also runs the step there
    (``reckon=False`` runs it alone).

    Returns JAX's keys with their meanings: ``mesh``,
    ``global_batch_pairs``, ``tokens``, ``attn_impl``,
    ``per_device_hbm_bytes``/``_gib`` (the peak of the bytes alive:
    arguments + temps + outputs), ``argument_gib`` (the rank's base shard,
    LoRA, optimiser state and batch rows), ``temp_gib``, ``output_gib`` (the
    metrics: the state is updated in place), ``alias_gib`` (0: nothing is
    donated); and ``peak_by_category_gib``, ``block_residual_bytes`` (what a
    checkpointed block keeps for the backward: its inputs, this rank's rows
    of the residual streams, 1/tp of them under a model axis), its
    ``residual_gib`` over the blocks of the two policy forwards and, when
    measured, ``measured_peak_gib`` and ``measured_launches``.
    """
    cfg = cfg or CogVideoXConfig.cogvideox_5b_i2v()
    tcfg = tcfg or _default_tcfg()
    return _train_memory(lambda b: _cog_family(cfg, b), cfg, tcfg, mesh, batch_size, device,
                         measure, reckon)


def aot_cog15_train_memory(mesh=None, batch_size: int = 2, attn_impl: str = "auto",
                           device="cuda", measure: bool = False,
                           reckon: bool = True) -> Dict[str, Any]:
    """``aot_train_memory`` for CogVideoX1.5-5B: 81f@768x1360 latents at
    patch_size_t 2 give (20 trimmed frames / 2) x 48 x 85 = 40,800 video
    tokens + 226 text = 41,026 DiT tokens a forward
    (``train/CogVideoX1.5-5B/03_train.py:54,95``)."""
    return aot_train_memory(CogVideoXConfig.cogvideox_1_5_5b(), _default_tcfg(attn_impl), mesh,
                            batch_size, device, measure, reckon)


def aot_wan_train_memory(mesh=None, batch_size: int = 2, latent_fhw: tuple = (21, 44, 80),
                         device="cuda", measure: bool = False, reckon: bool = True,
                         tcfg: Optional[TrainerConfig] = None, cfg=None) -> Dict[str, Any]:
    """This rank's memory in the Wan2.2-TI2V-5B DPO train step (flow
    matching, per-token timesteps) at 81f@704x1280 = (21, 44, 80) latents,
    18,480 DiT tokens at patch (1, 2, 2)
    (``train/Wan2.2-TI2V-5B/03_train.py:354-366``). Same method and keys as
    ``aot_train_memory``; ``cfg`` (default Wan2.2-TI2V-5B) and ``tcfg`` as
    there."""
    from videogpa_torch.models.wan.config import WanConfig

    cfg = cfg or WanConfig.ti2v_5b()
    return _train_memory(lambda b: _wan_family(cfg, b, latent_fhw), cfg, tcfg or _default_tcfg(),
                         mesh, batch_size, device, measure, reckon)


def parse_args(argv: Sequence[str]):
    """(function, keyword arguments) of ``python -m videogpa_torch.train.memory
    [cogvideox|wan|cog15] [DPxTP] [batch] [--measure]``, as the JAX module's
    ``__main__`` reads its arguments: an unknown model name is CogVideoX,
    ``DPxTP`` builds ``rank_mesh(dp, tp)``. JAX's ``@topology`` suffix names
    a TPU topology to compile for; here it has no meaning and is refused."""
    args = [a for a in argv if a != "--measure"]
    which = args[0] if args else "cogvideox"
    fn = {"wan": aot_wan_train_memory, "cog15": aot_cog15_train_memory}.get(
        which, aot_train_memory)
    kwargs: Dict[str, Any] = {"measure": "--measure" in argv}
    if len(args) > 1:
        spec = args[1]
        if "@" in spec:
            raise SystemExit(f"{spec!r}: the '@topology' suffix names a TPU topology; the port "
                             "reckons a rank of a PyTorch mesh: give DPxTP alone")
        dp, tp = (int(n) for n in spec.split("x"))
        kwargs["mesh"] = (dp, tp)
    if len(args) > 2:
        kwargs["batch_size"] = int(args[2])
    return fn, kwargs


def main(argv: Optional[Sequence[str]] = None) -> None:
    import json

    fn, kwargs = parse_args(sys.argv[1:] if argv is None else argv)
    if "mesh" in kwargs:
        kwargs["mesh"] = rank_mesh(*kwargs["mesh"])
    print(json.dumps(fn(**kwargs), indent=2))


if __name__ == "__main__":
    main()
