"""Build and load the port's CUDA kernels (``videogpa_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the checkout root, named by a hash of the source and
flags, so a changed source rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module.
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
SOURCES = {"flash_attn_fwd": _PKG / "csrc" / "flash_attn_fwd.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attn_fwd": (
        "videogpa_flash_attn_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_LL] * 12 + [_F, _P],
    ),
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
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named source that has no library yet. Returns each newly
    built kernel's compiler log (``-Xptxas -v`` register and shared-memory
    report). Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed: {name} (nvcc exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
        logs[name] = proc.stdout
    return logs


def kernel(name: str) -> Callable[..., int]:
    """The C entry point of kernel ``name``, building it first if needed."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
