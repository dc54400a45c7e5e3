"""Per-slot uint32 scatter-min: the z-buffer's kernel (K5).

Counterpart of ``videogpa_tpu/geometry/zbuffer_kernel.py::scatter_min_u32``:
``full((n_slots,), 0xFFFFFFFF).at[lin].min(key)`` with 0xFFFFFFFF keys as
no-ops, bit for bit. On the TPU that Pallas kernel (windowed all-pairs
tiers) lost to XLA's serial scatter and stays off by default
(``VIDEOGPA_ZBUFFER_KERNEL``). On Hopper the same function is one
``atomicMin`` per update (``csrc/zbuffer_scatter_min.cu``), so in the port it
IS the z-buffer of every lowering that scatters: the packed key of
``reproject_views_packed`` and both passes of the exact
``project_points_zbuffer``. Since both JAX lowerings give the same bits,
``VIDEOGPA_ZBUFFER_KERNEL`` has no meaning here.

PyTorch's uint32 support is thin, so keys travel as int64 tensors holding
values in [0, 2**32); the CUDA path hands the kernel their 32-bit patterns.
"""

from __future__ import annotations

import torch

from videogpa_torch.ops import _kernels

SENTINEL = 0xFFFFFFFF


def scatter_min_u32_reference(lin: torch.Tensor, key: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Plain version: ``scatter_reduce_`` "amin" over an int64 buffer."""
    buf = torch.full((n_slots,), SENTINEL, dtype=torch.int64, device=lin.device)
    return buf.scatter_reduce_(0, lin.long(), key.long(), reduce="amin")


def scatter_min_u32(lin: torch.Tensor, key: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per-slot minimum of uint32 keys.

    Args:
        lin: (U,) integer addresses, all in [0, n_slots).
        key: (U,) int64 holding uint32 values; 0xFFFFFFFF entries are no-ops.
        n_slots: buffer length (< 2**31).

    Returns:
        (n_slots,) int64 per-slot minima, 0xFFFFFFFF where no update landed.

    CPU tensors take the plain version. CUDA tensors launch the kernel (the
    wrapper fills the buffer with 0xFFFFFFFF via ``torch.full`` first);
    anything else raises. Each launch adds one to ``scatter_min_u32.launches``.
    """
    if lin.shape != key.shape or lin.dim() != 1:
        raise ValueError(f"scatter_min_u32: lin {tuple(lin.shape)} and key "
                         f"{tuple(key.shape)} must be equal 1-D shapes")
    if not 0 < n_slots < 2 ** 31:
        raise ValueError(f"scatter_min_u32: n_slots {n_slots} outside (0, 2**31)")
    if lin.device.type == "cpu":
        return scatter_min_u32_reference(lin, key, n_slots)
    if lin.device.type != "cuda" or key.device != lin.device:
        raise ValueError(f"scatter_min_u32: unsupported devices {lin.device}, {key.device}")
    if lin.dtype not in (torch.int32, torch.int64) or key.dtype != torch.int64:
        raise TypeError(f"scatter_min_u32: lin must be int32/int64 and key int64, "
                        f"got {lin.dtype}, {key.dtype}")
    if lin.numel():
        # an atomic out of bounds would corrupt memory: a device-side assert,
        # which does not stall the host the way reading the bounds back would
        lo, hi = torch.aminmax(lin)
        torch._assert_async((lo >= 0) & (hi < n_slots))
    lin32 = lin.to(torch.int32).contiguous()
    key32 = torch.where(key >= 2 ** 31, key - 2 ** 32, key).to(torch.int32).contiguous()
    buf = torch.full((n_slots,), -1, dtype=torch.int32, device=lin.device)  # 0xFFFFFFFF
    fn = _kernels.kernel("scatter_min_u32")
    with torch.cuda.device(lin.device):
        stream = torch.cuda.current_stream(lin.device).cuda_stream
        rc = fn(lin32.data_ptr(), key32.data_ptr(), buf.data_ptr(), lin32.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_min_u32: kernel launch failed with cudaError {rc}")
    scatter_min_u32.launches += 1
    return buf.to(torch.int64) & SENTINEL


scatter_min_u32.launches = 0
