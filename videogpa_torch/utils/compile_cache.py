"""``enable_compile_cache`` (``videogpa_tpu/utils/compile_cache.py``) as a
no-op.

The JAX package points XLA's persistent compilation cache at a directory so
that each process of the replicate flow skips minutes of compiles. The port
runs eager PyTorch and hand-written kernels, which ``ops/_kernels.py``
builds once into ``build/kernels/`` keyed by a hash of their sources: there
is no compilation cache to arm. The function stays so that callers of the
JAX package's entry points keep their call.
"""

from __future__ import annotations

__all__ = ["enable_compile_cache"]


def enable_compile_cache(force: bool = False) -> None:
    """Does nothing (see the module docstring)."""
    del force
