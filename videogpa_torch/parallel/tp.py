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
               delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel linear: this rank's columns of the weight on its
    columns of ``x``, the partial sums (with ``delta``, a LoRA's partial
    share) reduced over the group, the replicated bias added once."""
    if tp is None:
        y = lin(x)
        return y if delta is None else y + delta
    y = L.linear(x, lin.weight)
    if delta is not None:
        y = y + delta
    y = reduce_from(y, tp)
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
