"""Build and load the port's CUDA kernels (``videogpa_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``; all sources compile at once, one
``nvcc`` process each. Libraries land in ``build/kernels/`` at the checkout
root, named by a hash of the source, the shared headers and the flags, so a
changed source rebuilds and an unchanged one is reused. Nothing here runs at
import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
_CSRC = _PKG / "csrc"
SOURCES = {
    "flash_attn_fwd": _CSRC / "flash_attn_fwd.cu",
    "flash_attn_bwd": _CSRC / "flash_attn_bwd.cu",
    "flash_attn_short": _CSRC / "flash_attn_short.cu",
    "flash_attn_fwd_d128": _CSRC / "flash_attn_fwd_d128.cu",
    "flash_attn_bwd_d128": _CSRC / "flash_attn_bwd_d128.cu",
    "zbuffer_scatter_min": _CSRC / "zbuffer_scatter_min.cu",
    "flash_attn_int8": _CSRC / "flash_attn_int8.cu",
    "flash_attn_bwd_f32": _CSRC / "flash_attn_bwd_f32.cu",
    "flash_attn_fwd_wide": _CSRC / "flash_attn_fwd_wide.cu",
    "flash_attn_fwd_wide_bf16": _CSRC / "flash_attn_fwd_wide_bf16.cu",
    "flash_attn_bwd_wide": _CSRC / "flash_attn_bwd_wide.cu",
    "flash_attn_bwd_wide_f32": _CSRC / "flash_attn_bwd_wide_f32.cu",
    "flash_attn_int8_f32": _CSRC / "flash_attn_int8_f32.cu",
}
HEADERS = (_CSRC / "wgmma_sm90.cuh",)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_F, _P]
# K3 and K7: q, k, v, o, do, lse, dq, dk, dv and the f32 scratch (lse2, delta,
# dq_acc, dk_part, dv_part); B, H, Nq, Nk, D, splits, query tiles per split;
# (b, n, h) strides of q, k, v, o, do, dq, dk, dv; scale; stream
_BWD_ARGS = [_P] * 14 + [_I] * 7 + [_LL] * 24 + [_F, _P]
# q8, sq, k8, sk, v, o; B, H, Nq, Nk, D; (b, n, h) strides of the six; stream.
# The kernel needs every query scale sq > 0, as quantize_qk_int8 makes them.
_INT8_ARGS = [_P] * 6 + [_I] * 5 + [_LL] * 18 + [_P]
# the CUDA-core backwards (f32, flash_attn_bwd_f32.cu and
# flash_attn_bwd_wide_f32.cu): q, k, v, o, do, lse, dq, dk, dv and the
# scratch (delta, dq_acc, turn counters); B, H, Nq, Nk, D; (b, n, h) strides
# of q, k, v, o, do, dq, dk, dv; scale; stream
_BWD_F32_ARGS = [_P] * 12 + [_I] * 5 + [_LL] * 24 + [_F, _P]
# the bf16 backward above head_dim 128: the same with one f32 scratch (LSE2,
# then delta)
_BWD_WIDE_ARGS = [_P] * 10 + [_I] * 5 + [_LL] * 24 + [_F, _P]
# entry point -> (source, C symbol, argtypes)
_SIGNATURES = {
    "flash_attn_fwd": ("flash_attn_fwd", "videogpa_flash_attn_fwd", _FWD_ARGS),
    "flash_attn_bwd": ("flash_attn_bwd", "videogpa_flash_attn_bwd", _BWD_ARGS),
    "flash_attn_bwd_d128": ("flash_attn_bwd_d128", "videogpa_flash_attn_bwd_d128", _BWD_ARGS),
    "flash_attn_short": (
        "flash_attn_short", "videogpa_flash_attn_short",
        [_P] * 4 + [_I] * 5 + [_LL] * 12 + [_F, _P],
    ),
    "flash_attn_fwd_d128_bf16": (
        "flash_attn_fwd_d128", "videogpa_flash_attn_fwd_d128_bf16", _FWD_ARGS),
    "flash_attn_fwd_f32": ("flash_attn_fwd_d128", "videogpa_flash_attn_fwd_f32", _FWD_ARGS),
    "scatter_min_u32": (
        "zbuffer_scatter_min", "videogpa_scatter_min_u32", [_P, _P, _P, _LL, _P]),
    "flash_attn_int8": ("flash_attn_int8", "videogpa_flash_attn_int8", _INT8_ARGS),
    "flash_attn_bwd_f32": ("flash_attn_bwd_f32", "videogpa_flash_attn_bwd_f32", _BWD_F32_ARGS),
    "flash_attn_bwd_wide_f32": (
        "flash_attn_bwd_wide_f32", "videogpa_flash_attn_bwd_wide_f32", _BWD_F32_ARGS),
    "flash_attn_bwd_wide_bf16": (
        "flash_attn_bwd_wide", "videogpa_flash_attn_bwd_wide_bf16", _BWD_WIDE_ARGS),
    "flash_attn_fwd_wide_f32": (
        "flash_attn_fwd_wide", "videogpa_flash_attn_fwd_wide_f32", _FWD_ARGS),
    "flash_attn_fwd_wide_bf16": (
        "flash_attn_fwd_wide_bf16", "videogpa_flash_attn_fwd_wide_bf16", _FWD_ARGS),
    "flash_attn_int8_f32": ("flash_attn_int8_f32", "videogpa_flash_attn_int8_f32", _INT8_ARGS),
    # reports, not kernels: registers a thread and dynamic shared memory a CTA
    "flash_attn_fwd_attrs": ("flash_attn_fwd", "videogpa_flash_attn_fwd_attrs", [_I, _P, _P]),
    "flash_attn_fwd_f32_attrs": (
        "flash_attn_fwd_d128", "videogpa_flash_attn_fwd_f32_attrs", [_I, _P, _P]),
    "flash_attn_short_attrs": (
        "flash_attn_short", "videogpa_flash_attn_short_attrs", [_I, _P, _P]),
    "flash_attn_bwd_d128_attrs": (
        "flash_attn_bwd_d128", "videogpa_flash_attn_bwd_d128_attrs", [_P, _P]),
    "flash_attn_bwd_attrs": ("flash_attn_bwd", "videogpa_flash_attn_bwd_attrs", [_I, _P, _P]),
    "flash_attn_fwd_d128_attrs": (
        "flash_attn_fwd_d128", "videogpa_flash_attn_fwd_d128_attrs", [_P, _P]),
    "flash_attn_int8_attrs": ("flash_attn_int8", "videogpa_flash_attn_int8_attrs", [_I, _P, _P]),
    "flash_attn_bwd_f32_attrs": (
        "flash_attn_bwd_f32", "videogpa_flash_attn_bwd_f32_attrs", [_I, _P, _P]),
    "flash_attn_bwd_wide_bf16_attrs": (
        "flash_attn_bwd_wide", "videogpa_flash_attn_bwd_wide_bf16_attrs", [_I, _I, _P, _P]),
    "flash_attn_fwd_wide_f32_attrs": (
        "flash_attn_fwd_wide", "videogpa_flash_attn_fwd_wide_f32_attrs", [_I, _P, _P]),
    "flash_attn_fwd_wide_bf16_attrs": (
        "flash_attn_fwd_wide_bf16", "videogpa_flash_attn_fwd_wide_bf16_attrs", [_I, _P, _P]),
    "flash_attn_bwd_wide_f32_attrs": (
        "flash_attn_bwd_wide_f32", "videogpa_flash_attn_bwd_wide_f32_attrs", [_I, _P, _P]),
    "flash_attn_int8_f32_attrs": (
        "flash_attn_int8_f32", "videogpa_flash_attn_int8_f32_attrs", [_I, _P, _P]),
    # the walk of the f32 wide backward's last launch (1 diagonal, 0 in
    # order) and its grid in clusters
    "flash_attn_bwd_wide_f32_walk": (
        "flash_attn_bwd_wide_f32", "videogpa_flash_attn_bwd_wide_f32_walk", [_P, _P]),
    "flash_attn_int8_d128": (
        "flash_attn_int8", "videogpa_flash_attn_int8_d128", _INT8_ARGS),
}

_loaded: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named source that has no library yet, all at once (one
    ``nvcc`` process per source). Returns each newly built kernel's compiler
    log (``-Xptxas -v`` register and shared-memory report). Raises on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def kernel(name: str) -> Callable[..., int]:
    """The C entry point ``name`` (a key of ``_SIGNATURES``), building its
    source first if needed."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = _SIGNATURES[name]
        build([source])
        fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def bwd_wide_f32_walk() -> Dict[str, int]:
    """The walk the f32 wide backward's last launch took (``diagonal`` 1: a
    cooperative launch of the whole grid; 0: in order) and its grid in
    clusters."""
    walk, clusters = ctypes.c_int(0), ctypes.c_int(0)
    kernel("flash_attn_bwd_wide_f32_walk")(ctypes.byref(walk), ctypes.byref(clusters))
    return {"diagonal": walk.value, "clusters": clusters.value}


def kernel_attrs(name: str, *args: int) -> Dict[str, int]:
    """Registers a thread and dynamic shared memory a CTA of a kernel with a
    report entry (``flash_attn_fwd``, ``flash_attn_fwd_f32``,
    ``flash_attn_short``, ``flash_attn_bwd``, ``flash_attn_bwd_f32``,
    ``flash_attn_bwd_wide_f32``, ``flash_attn_int8`` (K8 and K9),
    ``flash_attn_int8_f32``,
    ``flash_attn_fwd_wide_f32`` and ``flash_attn_fwd_wide_bf16`` at head dim
    ``args[0]``, ``flash_attn_bwd_wide_bf16`` at head dim ``args[0]`` (its
    dK/dV kernel with ``args[1]`` 1, its dQ kernel with 0),
    ``flash_attn_fwd_d128`` (its bf16 kernel), ``flash_attn_bwd_d128``), as the
    card reports them."""
    regs, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = kernel(f"{name}_attrs")(*args, ctypes.byref(regs), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed with cudaError {rc}")
    return {"registers": regs.value, "smem_bytes": smem.value}
