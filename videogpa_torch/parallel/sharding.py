"""Sharding rules for model parameters, LoRA trees and batches
(``videogpa_tpu/parallel/sharding.py``).

Tensor parallelism over the ``model`` axis in the Megatron pattern, with the
JAX package's rules: in the stacked blocks, the attention's q / k / v (the
ViT's fused qkv) and the FFN's fc1 are column-parallel (weight rows and bias
split), the attention output (to_out / o / proj) and fc2 row-parallel
(weight columns split, bias replicated); everything else is replicated.
A spec names a mesh axis (or None) per dim of the port's tensor: JAX's
``P(None, None, "model")`` on a stacked (L, in, out) kernel is
``P("model", None)`` on the port's per-layer (out, in) weight.

``shard_tree`` really splits the tensors: each rank keeps 1/tp of every
leaf the rules shard. Where JAX's GSPMD inserts the collectives, the port's
layers insert them themselves (``parallel.tp``), reading the local widths:
a model is tensor-parallel where its weights were sharded.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from videogpa_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, P, axis_rank, axis_size, local_slice)
from videogpa_torch.parallel.tp import SeqShard, seq_group

# nodes whose JAX leaves stack every layer on a leading axis: JAX's rules
# shard only stacked (3-D) kernels, so a list node of blocks stays replicated
_STACKED = ("blocks", "frame_blocks", "global_blocks", "blocks_pre")
COLUMN, FUSED_COLUMN = P(MODEL_AXIS), P(MODEL_AXIS, blocks=3)
ROW, REPLICATED = P(None, MODEL_AXIS), P()


def _in_stacked_blocks(name: str) -> bool:
    node = next((p for p in name.split(".") if "blocks" in p), None)
    return node in _STACKED


def _specs(model: nn.Module, rule) -> Dict[str, P]:
    """{parameter name: spec} over ``model.named_parameters()``; ``rule(module
    path parts, leaf name)`` gives the spec of a leaf in the stacked blocks."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        spec = rule(parts[:-1], parts[-1]) if _in_stacked_blocks(name) else None
        out[name] = spec or REPLICATED
    return out


def dit_param_specs(model: nn.Module) -> Dict[str, P]:
    """Specs of the CogVideoX DiT (``sharding.py:24``): attn1.to_q/to_k/to_v
    and ff.fc1 column-parallel, attn1.to_out and ff.fc2 row-parallel."""

    def rule(mod, leaf):
        if mod[-1] in ("to_q", "to_k", "to_v", "fc1"):
            return COLUMN
        if mod[-1] in ("to_out", "fc2") and leaf == "weight":
            return ROW
        return None

    return _specs(model, rule)


def wan_param_specs(model: nn.Module) -> Dict[str, P]:
    """Specs of the Wan2.2 DiT (``sharding.py:46``): self- and
    cross-attention q/k/v and ffn.fc1 column-parallel, o and ffn.fc2
    row-parallel; norms, modulations and embeddings replicated (the QK
    RMS-norm weights are sliced where they are used)."""

    def rule(mod, leaf):
        if mod[-1] in ("q", "k", "v", "fc1"):
            return COLUMN
        if mod[-1] in ("o", "fc2") and leaf == "weight":
            return ROW
        return None

    return _specs(model, rule)


def vit_param_specs(model: nn.Module) -> Dict[str, P]:
    """Specs of stacked ViT blocks (``sharding.py:72``: the VGGT
    aggregator's frame/global blocks, DINOv2's, DA3's ``blocks_pre``):
    attn.qkv (fused: split per third) and mlp.fc1 column-parallel,
    attn.proj and mlp.fc2 row-parallel."""

    def rule(mod, leaf):
        pair = tuple(mod[-2:])
        if pair == ("attn", "qkv"):
            return FUSED_COLUMN
        if pair == ("mlp", "fc1"):
            return COLUMN
        if pair in (("attn", "proj"), ("mlp", "fc2")) and leaf == "weight":
            return ROW
        return None

    return _specs(model, rule)


def seq_shard(x: torch.Tensor) -> torch.Tensor:
    """Megatron-style sequence sharding of a DiT residual (``sharding.py:99``).

    Under an ambient mesh whose ``model`` axis is above 1: this rank's
    block of ``x``'s sequence (dim 1), padded with zero rows where tp does
    not divide its length (``parallel.tp.SeqShard``), so the carries that
    remat keeps for the backward are 1/tp on each rank (1/(dp·tp) of the
    global batch, as JAX's (data, model) constraint lays them out); the
    backward all-gathers. Otherwise ``x`` itself, as JAX's is a no-op
    without a ``model`` axis. The DiTs run each block on the blocks and
    gather the sequence into the column-parallel layers, so their numbers
    are the replicated ones."""
    tp = seq_group()
    return x if tp is None else SeqShard(tp, x.shape[1]).scatter(x, None)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def lora_param_specs(lora: Any) -> Any:
    """LoRA trees are small: replicated (``sharding.py:121``). The
    tensor-parallel layers use the rows / columns of their shard, and the
    train steps sum the gradients over ``model`` and average them over
    ``data``."""
    return _tree_map(lambda _: REPLICATED, lora)


def batch_specs(batch: Any) -> Any:
    """Every batch array split over ``data`` on its leading dim (``sharding.py:126``)."""
    return _tree_map(lambda _: P(DATA_AXIS), batch)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Lay ``tree`` out on ``mesh`` by ``specs`` (``sharding.py:131``).

    An ``nn.Module`` with a ``{parameter name: spec}`` dict is split in
    place: each sharded parameter keeps this rank's block only (its
    ``.data`` replaced by a copy of the block in storage of its own, so the
    whole tensor is freed: a block of leading rows is a contiguous view
    that would keep it) and the module is returned. A tree of tensors or
    numpy arrays with a spec tree of the same structure gives a new tree of
    this rank's blocks (a replicated leaf is returned as it is)."""
    if isinstance(tree, nn.Module):
        params = dict(tree.named_parameters())
        if set(specs) != set(params):
            raise ValueError("specs must name every parameter of the module")
        with torch.no_grad():
            for name, p in params.items():
                if any(specs[name]):
                    p.data = local_slice(p.data, specs[name], mesh).clone(
                        memory_format=torch.contiguous_format)
        return tree
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    return local_slice(tree, specs, mesh) if any(specs) else tree


# ---------------------------------------------------------------------------
# Data parallelism in the train steps
# ---------------------------------------------------------------------------

def data_rows(mesh, local_batch: int) -> Tuple[int, Optional[slice]]:
    """(global batch, this rank's rows of it or None) under ``mesh``'s
    ``data`` axis, for a rank holding ``local_batch`` rows (its
    ``batch_specs`` slice). The train steps draw noise and timesteps for the
    global batch and keep their rows, so they draw what one process would."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return local_batch, None
    r = axis_rank(mesh, DATA_AXIS)
    return local_batch * axis_size(mesh, DATA_AXIS), slice(r * local_batch, (r + 1) * local_batch)


def take_rows(x: torch.Tensor, rows: Optional[slice], global_batch: int, what: str) -> torch.Tensor:
    """This rank's ``rows`` of a draw ``x`` made for the whole batch."""
    if x.shape[0] != global_batch:
        raise ValueError(f"{what} has {x.shape[0]} rows, the whole batch {global_batch}")
    return x if rows is None else x[rows]


@torch.no_grad()
def reduce_grads(grads, mesh, tensor_parallel: bool):
    """Gradients of replicated LoRA leaves on each rank -> the gradients of
    the whole step: summed over ``model`` where the model is
    tensor-parallel (each rank's hold only its shard's share), averaged over
    ``data`` (each rank's are those of its slice of the batch), in one
    all-reduce of the flattened leaves an axis; the data-parallel
    all-reduce runs under any mesh, also at one rank. The ``seq`` ranks
    already hold the whole gradients (the ring's edges gather them).
    Returns new tensors; without a mesh, ``grads`` as they are."""
    if mesh is None:
        return grads
    import torch.distributed as dist

    out = [g.clone() for g in grads]
    for axis, op in ((MODEL_AXIS, "sum"), (DATA_AXIS, "mean")):
        n = axis_size(mesh, axis)
        if axis == MODEL_AXIS and (n == 1 or not tensor_parallel):
            continue
        flat = torch.cat([g.reshape(-1) for g in out])
        dist.all_reduce(flat, group=mesh.get_group(axis))
        if op == "mean":
            flat /= n
        out = [t.view_as(g) for t, g in zip(flat.split([g.numel() for g in out]), out)]
    return out


@torch.no_grad()
def mean_over_data(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Batch-mean metrics of each rank's slice -> the whole batch's (equal
    slices, so the mean of the means), in one all-reduce under any mesh."""
    if mesh is None:
        return metrics
    import torch.distributed as dist

    names = list(metrics)
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat, group=mesh.get_group(DATA_AXIS))
    flat /= axis_size(mesh, DATA_AXIS)
    return dict(zip(names, flat.unbind()))


__all__ = ["P", "dit_param_specs", "wan_param_specs", "vit_param_specs", "seq_shard",
           "lora_param_specs", "batch_specs", "shard_tree", "local_slice", "data_rows", "take_rows",
           "reduce_grads", "mean_over_data"]
