#!/usr/bin/env python3
"""Time the port's K4 (``flash_attn_short``) and K7 (``flash_attn_bwd_d128``)
against another checkout's on one NVIDIA GPU, in one process.

    python3 kernel_ab.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/videogpa_torch/csrc/{flash_attn_short,
flash_attn_bwd_d128}.cu with this checkout's nvcc flags into build/ab/, then
times each kernel at its main-path shapes (K4 at VGGT's frame attention
(40, 1,374, 16, 64) from strided views of a packed projection; K7 at the
Wan2.2-TI2V-5B self- and cross-attention shapes from strided projection
views) in turns, other / this / this / other, with CUDA events on the same
operands. The other checkout's K7 takes delta = rowsum(O * dO) from its
caller (the C interface before the wgmma redesign): its time includes that
eager reduction, as its wrapper's did. Prints the card and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from videogpa_torch.ops import _kernels  # noqa: E402
from videogpa_torch.ops import attention as A  # noqa: E402

LOG2E = 1.4426950408889634
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_K7_ARGS = [_P] * 9 + [_I] * 5 + [_LL] * 21 + [_F, _P]


def _build(other: str, name: str, symbol: str, argtypes):
    src = os.path.join(other, "videogpa_torch", "csrc", f"{name}.cu")
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{name}.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", os.path.dirname(src),
                    "-o", lib, src], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _strides(layout, *xs):
    out = []
    for x in xs:
        out += A._dims(x, layout)[4:]
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = sys.argv[1]
    cs.log(cs.gpu_name_and_power())
    old_k4 = _build(other, "flash_attn_short", "videogpa_flash_attn_short",
                    _kernels._SIGNATURES["flash_attn_short"][2])
    old_k7 = _build(other, "flash_attn_bwd_d128", "videogpa_flash_attn_bwd_d128", OLD_K7_ARGS)
    _kernels.build(["flash_attn_short", "flash_attn_bwd_d128"])
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(91)
    res = {}

    def turns(tag, old, new, iters):
        """Both versions agree, then other / this / this / other."""
        for a, b in zip(old(), new()):
            if not torch.allclose(a.float(), b.float(), atol=2e-2, rtol=2e-2):
                raise SystemExit(f"kernel_ab: the two versions disagree at {tag}")
        t = [cs.cuda_ms(f, iters) for f in (old, new, new, old)]
        res[tag] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}

    # K4 at the VGGT frame shape
    q, k, v = torch.randn(40, 1374, 3, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)

    def k4_old():
        o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        rc = old_k4(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 40, 16, 1374, 1374,
                    64, *_strides("bnhd", q, k, v, o), 64 ** -0.5 * LOG2E, stream)
        assert rc == 0, rc
        return (o,)

    turns("k4_vggt_frame", k4_old, lambda: (A.flash_attn_short(q, k, v),), 50)
    del q, k, v

    # K7 at the Wan self and cross shapes
    B, N, H, D = 1, 18480, 24, 128
    q = cs._proj_views(gen, B, N, H, D)
    for tag, nk, iters in (("k7_wan_self", N, 5), ("k7_wan_cross", 512, 20)):
        k, v = cs._proj_views(gen, B, nk, H, D), cs._proj_views(gen, B, nk, H, D)
        o, lse = A.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
        do = cs._proj_views(gen, B, N, H, D).contiguous()

        def k7_old():
            delta = (o.float() * do.float()).sum(-1).contiguous()
            grads = [torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v)]
            rc = old_k7(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), *(g.data_ptr() for g in grads), B, H, N, nk, D,
                        *_strides("bhnd", q, k, v, do, *grads), D ** -0.5, stream)
            assert rc == 0, rc
            return grads

        turns(tag, k7_old, lambda: A.flash_attn_bwd_d128(q, k, v, o, lse, do, layout="bhnd"),
              iters)
        del k, v, o, lse, do
    cs.log("[ab] " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
