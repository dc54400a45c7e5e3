"""Tensor-parallel layers over the ambient mesh's ``model`` axis.

JAX's GSPMD inserts the collectives of a sharded layer itself; the port's
layers call these. A layer is tensor-parallel where ``shard_tree`` left its
weight with a fraction of its rows (``model_group``); its input then passes
Megatron's f (``copy_to``: identity forward, all-reduce backward) and a
row-parallel output g (``reduce_from``: all-reduce forward, identity
backward), which ``torch.distributed.nn.functional.all_reduce`` is not: it
all-reduces both ways, which would scale the gradients by tp. Every rank
computes the replicated parts of the model, so the gradient that reaches a
replicated tensor is the whole one on every rank.

Where tp does not divide a layer's heads (a shard would cut a head), the
layer gathers q, k and v over ``model`` (``gather_from``: all-gather
forward; backward sum over the group and keep the local block), attends on
every head, and keeps its own columns of the output for the row-parallel
projection: the same numbers as the replicated layer, at the cost of the
gather.

Sequence parallelism (Megatron's, the layout JAX's ``seq_shard``
constraint gives the DiTs' scan carries): under a ``model`` axis above 1 a
DiT keeps its residual stream as each rank's block of the sequence
(``SeqShard``; ``parallel.sharding.seq_shard``), so the inputs that remat
keeps for the backward are 1/tp on each rank. The norms, modulations,
gates and residual adds run on the block; the input of a column-parallel
layer is all-gathered along the sequence (``SeqShard.gather``: its
backward reduce-scatters) in place of f, and the row-parallel output is
reduce-scattered along the sequence (``SeqShard.scatter``: its backward
all-gathers) in place of g's all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from videogpa_torch.ops import layers as L
from videogpa_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size, get_mesh


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the ``model`` axis: its process group, the
    axis size and its coordinate."""

    group: object
    size: int
    rank: int

    def block(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a replicated ``x`` along ``dim``."""
        w = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * w, w)


def _rows(lin: nn.Module, full: int) -> int:
    """The output rows ``lin``'s weight holds (an int8 ``QuantLinear``,
    which has none, is never split)."""
    weight = getattr(lin, "weight", None)
    return full if weight is None else weight.shape[0]


def is_sharded(lin: nn.Module, full: int) -> bool:
    """Whether ``shard_tree`` split the rows of the linear ``lin``."""
    return _rows(lin, full) != full


def model_group(lin: nn.Module, full: int, what: str) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of a column-parallel linear ``lin`` whose
    weight holds a share of its ``full`` output rows, or None when it holds
    them all. Raises when the rows were split but the ambient mesh's
    ``model`` axis does not match."""
    local = _rows(lin, full)
    if local == full:
        return None
    mesh = get_mesh()
    tp = axis_size(mesh, MODEL_AXIS) if mesh is not None else 1
    if local * tp != full:
        raise ValueError(
            f"{what} holds {local} of {full} rows, but the ambient mesh's 'model' axis has "
            f"size {tp}: call the model inside set_mesh(mesh) with the mesh it was sharded on")
    return TensorParallel(mesh.get_group(MODEL_AXIS), tp, axis_rank(mesh, MODEL_AXIS))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorParallel):
        ctx.tp = tp
        return _all_gather(x, tp.group, tp.size, -1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.block(_all_reduce(g, ctx.tp.group)).contiguous(), None


def _seq_major(x: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) -> a contiguous (N, B, ...): the collectives' first dim."""
    return x.movedim(1, 0).contiguous()


def _gather_rows(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's (B, rows, ...) block in rank order: (B, size * rows, ...)."""
    import torch.distributed as dist

    src = _seq_major(x)
    out = src.new_empty((tp.size * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=tp.group)
    return out.movedim(0, 1)


def _scatter_rows(y: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the group of the (B, size * rows, ...) ``y``, this rank's rows."""
    import torch.distributed as dist

    src = _seq_major(y)
    out = src.new_empty((src.shape[0] // tp.size,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=tp.group)
    return out.movedim(0, 1)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A sequence of ``n`` rows (dim 1) held in blocks over the ``model``
    axis ``tp``: rank r holds rows [r * rows, (r + 1) * rows) of the
    sequence padded with zero rows to ``tp.size * rows``. No pad row
    reaches a real one: ``gather`` drops them before the layer, and they
    go into no attention and no sum over the sequence."""

    tp: TensorParallel
    n: int

    @property
    def rows(self) -> int:
        return -(-self.n // self.tp.size)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        extra = self.tp.size * self.rows - self.n
        if extra == 0:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra) + x.shape[2:])], dim=1)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole (B, n, ...) ``x``, padded: a tensor
        of its own, so that keeping it does not keep the whole sequence."""
        return self.pad(x).narrow(1, self.tp.rank * self.rows, self.rows).clone(
            memory_format=torch.contiguous_format)

    def gather(self, x: torch.Tensor, layer: Optional[TensorParallel]) -> torch.Tensor:
        """The whole sequence of each rank's block ``x``, the input of a
        layer: a column-parallel one (``layer`` given), whose backward sums
        every rank's share of the gradient and keeps this rank's rows
        (reduce-scatter), or a replicated one (None), whose gradient is
        whole on each rank and of which the backward keeps the block."""
        return _SeqGather.apply(x, self, layer is not None)

    def scatter(self, y: torch.Tensor, layer: Optional[TensorParallel]) -> torch.Tensor:
        """This rank's block of a whole-sequence output ``y``: the sum over
        the group of a row-parallel layer's partial outputs (``layer``
        given; reduce-scatter), or the block of a replicated one (None)."""
        return _SeqScatter.apply(y, self, layer is not None)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ss: SeqShard, reduce_grad: bool):
        ctx.ss, ctx.reduce_grad = ss, reduce_grad
        return _gather_rows(x, ss.tp).narrow(1, 0, ss.n)

    @staticmethod
    def backward(ctx, g):
        ss = ctx.ss
        if ctx.reduce_grad:
            return _scatter_rows(ss.pad(g), ss.tp), None, None
        return ss.block(g), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, ss: SeqShard, reduce: bool):
        ctx.ss = ss
        if reduce:
            return _scatter_rows(ss.pad(y), ss.tp)
        return ss.block(y)

    @staticmethod
    def backward(ctx, g):
        ss = ctx.ss
        return _gather_rows(g.contiguous(), ss.tp).narrow(1, 0, ss.n), None, None


def seq_group() -> Optional[TensorParallel]:
    """The ambient mesh's ``model`` axis when it is above 1: the group over
    which the DiTs shard their residual streams by the sequence; else None."""
    mesh = get_mesh()
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return TensorParallel(mesh.get_group(MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                          axis_rank(mesh, MODEL_AXIS))


def copy_to(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Megatron's f: the input of column-parallel layers."""
    return x if tp is None else _CopyTo.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Megatron's g: the sum of row-parallel partial outputs."""
    return x if tp is None else _ReduceFrom.apply(x, tp.group)


def sum_over(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """A sum over the group of values whose consumers are each rank's own
    (a statistic of sharded columns): all-reduce both ways."""
    return x if tp is None else _AllReduce.apply(x, tp.group)


def gather_from(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's columns of ``x`` (last dim), in rank order."""
    return _GatherFrom.apply(x, tp)


def heads_split(y: torch.Tensor, head_dim: int, tp: Optional[TensorParallel]):
    """(y, gathered): a column-parallel projection ``y`` whose local width
    holds whole heads stays as it is; one that would cut a head is gathered
    to every head (``gathered`` True), and the caller keeps its own columns
    of the attention output with ``tp.block``."""
    if tp is None or y.shape[-1] % head_dim == 0:
        return y, False
    return gather_from(y, tp), True


def row_linear(lin: nn.Module, x: torch.Tensor, tp: Optional[TensorParallel],
               delta: Optional[torch.Tensor] = None, reduce=None) -> torch.Tensor:
    """A row-parallel linear: this rank's columns of the weight on its
    columns of ``x``, the partial sums (with ``delta``, a LoRA's partial
    share) reduced over the group, the replicated bias added once.
    ``reduce(y)``, where given, takes the place of that all-reduce (and
    runs on the whole output of an unsplit ``lin`` too): the
    sequence-parallel blocks pass ``SeqShard.scatter``, whose output is
    this rank's rows."""
    if tp is None:
        y = lin(x)
        y = y if delta is None else y + delta
        return y if reduce is None else reduce(y)
    y = L.linear(x, lin.weight)
    if delta is not None:
        y = y + delta
    y = reduce_from(y, tp) if reduce is None else reduce(y)
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


def rmsnorm(x: torch.Tensor, norm: nn.Module, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``norm`` (an RMS norm over the whole width) on column-parallel ``x``:
    the mean square sums over the group, the weight is this rank's block."""
    if tp is None:
        return norm(x)
    xf = x.float()
    ms = sum_over(xf.square().sum(-1, keepdim=True), tp) / (x.shape[-1] * tp.size)
    return (xf * torch.rsqrt(ms + norm.eps) * tp.block(norm.weight).float()).to(x.dtype)


# LoRA targets by the side of the layer they adapt
_COLUMN_TARGETS, _ROW_TARGETS = ("to_q", "to_k", "to_v"), ("to_out",)


def lora_block(layer_lora: Optional[dict], tp: Optional[TensorParallel]) -> Optional[dict]:
    """One layer's LoRA tree restricted to this rank's shard: B's rows of the
    column-parallel targets, A's columns of the row-parallel one. The tree
    stays replicated; its gradients reach the rows and columns this rank
    used, and the train steps sum them over the group."""
    if layer_lora is None or tp is None:
        return layer_lora
    out = {}
    for name, ab in layer_lora.items():
        if name in _COLUMN_TARGETS:
            out[name] = {"lora_A": ab["lora_A"], "lora_B": tp.block(ab["lora_B"], 0)}
        elif name in _ROW_TARGETS:
            out[name] = {"lora_A": tp.block(ab["lora_A"], -1), "lora_B": ab["lora_B"]}
        else:
            raise ValueError(f"LoRA target {name!r} has no tensor-parallel layout")
    return out
