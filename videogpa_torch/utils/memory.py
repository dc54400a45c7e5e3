"""Device memory introspection and cleanup (``videogpa_tpu/utils/memory.py``;
the reference's ``depth_anything_3/utils/memory.py``).

- ``get_device_memory_info``: one CUDA device's memory from
  ``torch.cuda.mem_get_info`` (free and total as CUDA reports them) and
  the caching allocator's statistics; keys as the reference's: total_gb,
  allocated_gb, reserved_gb, free_gb, utilization.
- ``cleanup_device_memory``: drop dead references and return the caching
  allocator's unused blocks (``torch.cuda.empty_cache``).
- ``check_memory_availability`` / ``estimate_memory_requirement``: the
  reference's go / no-go policy.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, Optional, Tuple

import torch


def get_device_memory_info(device=None) -> Optional[Dict[str, Any]]:
    """Memory snapshot of a CUDA device (default: the current one). None
    where there is no CUDA device or ``device`` is not one."""
    if not torch.cuda.is_available():
        return None
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    allocated = torch.cuda.memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    gb = 1024 ** 3
    return {
        "device": str(device),
        "total_gb": total / gb,
        "allocated_gb": allocated / gb,
        "reserved_gb": reserved / gb,
        "free_gb": free / gb,
        "utilization": (total - free) / total * 100.0,
    }


def cleanup_device_memory() -> None:
    """Collect garbage, then hand the caching allocator's free blocks back
    to CUDA, and print what was freed."""
    before = get_device_memory_info()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    after = get_device_memory_info()
    if before and after:
        freed = before["reserved_gb"] - after["reserved_gb"]
        print(f"device cleanup: freed {freed:.2f}GB, available: "
              f"{after['free_gb']:.2f}GB/{after['total_gb']:.2f}GB")
    else:
        print("device memory cleanup completed")


def check_memory_availability(required_gb: float = 2.0) -> Tuple[bool, str]:
    """(ok, message): does the current device have ``required_gb`` free?"""
    try:
        info = get_device_memory_info()
        if info is None:
            return True, "Cannot check memory, proceeding anyway"
        if info["free_gb"] < required_gb:
            return False, (
                f"Insufficient device memory: {info['free_gb']:.2f}GB available, "
                f"{required_gb:.2f}GB required. Total: {info['total_gb']:.2f}GB, "
                f"Used: {info['allocated_gb']:.2f}GB ({info['utilization']:.1f}%)")
        return True, (f"Memory check passed: {info['free_gb']:.2f}GB available, "
                      f"{required_gb:.2f}GB required")
    except Exception as e:  # the reference's policy: a failed check never blocks
        return True, f"Memory check failed: {e}, proceeding anyway"


def estimate_memory_requirement(num_images: int, process_res: int) -> float:
    """Heuristic GB for an inference request (the reference's: 2 GB base plus
    a per-image term quadratic in the resolution)."""
    base_memory = 2.0
    per_image_memory = (process_res / 504) ** 2 * 0.5
    return base_memory + num_images * per_image_memory * 0.1
