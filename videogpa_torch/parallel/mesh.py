"""Device mesh and the ambient-mesh context (``videogpa_tpu/parallel/mesh.py``).

Axis conventions, as in the JAX package:

- ``data``: batch / preference-pair parallelism; the LoRA gradients are
  averaged over it (the reference's DDP, ``train/CogVideoX-I2V-5B/
  03_train.py:249-258``).
- ``seq``: sequence parallelism; ``attention(impl="ring")`` rotates K/V
  shards around it (``ops.ring_attention``).
- ``model``: tensor parallelism of the DiT / ViT heads and FFN
  (``parallel.sharding``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those three
named dims. Process-group setup stays with the caller, as
``jax.distributed`` does in JAX: ``torch.distributed.init_process_group``
(``nccl`` on the cards, ``gloo`` on the CPU) comes first. The port's tensors
are per rank: a rank holds the whole of a replicated leaf and its own slice
of a sharded one (``parallel.sharding.shard_tree``), and the models find
the mesh through ``set_mesh`` (the counterpart of ``jax.set_mesh``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: int = 1
    seq: int = 1
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model


def make_mesh(axes: Optional[MeshAxes] = None, device_type: str = "cuda",
              ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over ``ranks`` (default: every rank of the default
    process group) with dims ``("data", "seq", "model")``.

    With ``axes=None`` every rank goes to ``data`` (pure DP, the reference's
    only strategy). The axis sizes must multiply to the number of ranks, else
    ``ValueError``. ``device_type`` is "cuda" unless the caller asks for
    "cpu" (the ``gloo`` tests). Every rank of the world calls this for every
    mesh, also a mesh over other ranks (a disjoint sub-mesh): the groups are
    made collectively.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if axes is None:
        axes = MeshAxes(data=len(world))
    if axes.size != len(world):
        raise ValueError(f"mesh axes {axes} need {axes.size} ranks, got {len(world)}")
    shape = (axes.data, axes.seq, axes.model)
    if ranks is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=AXES)
    return DeviceMesh(device_type, torch.tensor(world).reshape(shape), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh`` (1 for an axis the mesh does not have)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; raises if the rank is not in ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {torch.distributed.get_rank()} is not in the mesh {mesh}")
    names = mesh.mesh_dim_names or ()
    return coord[names.index(axis)] if axis in names else 0


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dim of a tensor;
    trailing dims left out are replicated. ``blocks`` > 1 says the sharded
    dim holds that many equal blocks (a fused q | k | v projection), each
    split alike, so a rank keeps whole heads of each."""

    def __new__(cls, *dims, blocks: int = 1):
        self = super().__new__(cls, dims)
        self.blocks = blocks
        return self

    def __repr__(self) -> str:
        extra = f", blocks={self.blocks}" if self.blocks > 1 else ""
        return f"P({', '.join(map(repr, self))}{extra})"

    def __eq__(self, other) -> bool:
        return tuple.__eq__(self, other) and self.blocks == getattr(other, "blocks", 1)

    def __hash__(self) -> int:
        return hash((tuple(self), self.blocks))


def local_slice(x, spec: P, mesh):
    """This rank's block of a whole tensor (or numpy array) ``x`` under
    ``spec``: along each named dim, the block at this rank's coordinate
    (the dim must split evenly)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        size = x.shape[dim]
        if size % (n * spec.blocks):
            raise ValueError(f"dim {dim} of size {size} does not split into "
                             f"{spec.blocks} x {n} blocks over {axis!r}")
        step = size // spec.blocks
        w = step // n
        starts = [b * step + r * w for b in range(spec.blocks)]
        if isinstance(x, np.ndarray):
            x = np.concatenate([np.take(x, range(s, s + w), axis=dim) for s in starts], axis=dim)
        else:
            parts = [x.narrow(dim, s, w) for s in starts]
            x = torch.cat(parts, dim=dim) if spec.blocks > 1 else parts[0]
    return x


class Sharding:
    """Where a tensor lives on ``mesh``: ``spec`` names a mesh axis (or
    None) per dim, as a JAX ``NamedSharding``. ``local(x)`` is this rank's
    block of a whole tensor ``x`` (``local_slice``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return local_slice(x, self.spec, self.mesh)


def shard(mesh, *spec) -> Sharding:
    """The ``Sharding`` of the given per-dim axis names."""
    return Sharding(mesh, spec)


def replicate(mesh) -> Sharding:
    return Sharding(mesh, ())


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The counterpart of an in-jit sharding constraint. The values are
    unchanged, as in JAX; the port's tensors are per rank, and the layouts
    are set where tensors are made (``shard_tree``, the ring's shards). It
    checks that each named axis is one of the ambient mesh's (no-op without
    a mesh)."""
    mesh = get_mesh()
    if mesh is not None:
        for axis in spec:
            for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
                if a is not None and a not in (mesh.mesh_dim_names or ()):
                    raise ValueError(f"constrain: mesh has no axis {a!r}")
    return x


_MESH: contextvars.ContextVar = contextvars.ContextVar("videogpa_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (``jax.set_mesh``):
    ``attention(impl="ring")``, the tensor-parallel layers and the train
    steps read it with ``get_mesh``."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh():
    """The ambient mesh, or None."""
    return _MESH.get()


def in_mesh(mesh, fn, *args):
    """``fn(*args)`` with ``mesh`` the ambient mesh. A remat block takes its
    caller's mesh along so: its recompute runs in the backward, which the
    autograd engine runs on a thread of its own for CUDA tensors, where the
    caller's ``set_mesh`` is not in force."""
    with set_mesh(mesh):
        return fn(*args)
