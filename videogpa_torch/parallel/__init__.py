"""Data, sequence and tensor parallelism on ``torch.distributed``
(``videogpa_tpu/parallel``).

One ``DeviceMesh`` with the named dims ``data``, ``seq`` and ``model``
(``mesh``), parameter and batch layouts (``sharding``), the collectives of
the tensor-parallel layers (``tp``) and, in ``ops.ring_attention``, the ring
over ``seq``. The models and train steps find the mesh through ``set_mesh``.
"""

from videogpa_torch.parallel.mesh import (
    MeshAxes,
    constrain,
    get_mesh,
    make_mesh,
    replicate,
    set_mesh,
    shard,
)

__all__ = ["MeshAxes", "make_mesh", "shard", "replicate", "constrain", "set_mesh", "get_mesh"]
