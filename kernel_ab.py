#!/usr/bin/env python3
"""Time the port's wgmma kernels K3 (``flash_attn_bwd``), K4
(``flash_attn_short``), K6 (``flash_attn_fwd_d128``, bf16) and K7
(``flash_attn_bwd_d128``) against another checkout's on one NVIDIA GPU, in
one process.

    python3 kernel_ab.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/videogpa_torch/csrc/{flash_attn_bwd, flash_attn_short,
flash_attn_fwd_d128, flash_attn_bwd_d128}.cu with this checkout's nvcc flags
into build/ab/, then times each kernel at its main-path shapes (K3 at the
CogVideoX-5B training shape (1, 17,776, 48, 64); K4 at VGGT's frame
attention (40, 1,374, 16, 64) from strided views of a packed projection; K6
without and with LSE and K7 at the Wan2.2-TI2V-5B self- and cross-attention
shapes from strided projection views) in turns, other / this / this / other,
with CUDA events on the same operands. A backward whose C interface takes
delta = rowsum(O * dO) from its caller (K3 and K7 before their wgmma
redesigns) is timed with that eager reduction, as its wrapper ran it. The
other checkout's sources must have this checkout's C interfaces or those
older ones. Prints the card and one JSON line.
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
# the backward C interface that took delta from its caller
OLD_BWD_ARGS = [_P] * 9 + [_I] * 5 + [_LL] * 21 + [_F, _P]


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
    old = {}
    for name in ("flash_attn_bwd", "flash_attn_short", "flash_attn_fwd_d128",
                 "flash_attn_bwd_d128"):
        src = open(os.path.join(other, "videogpa_torch", "csrc", f"{name}.cu")).read()
        if name == "flash_attn_fwd_d128":
            symbol, argtypes = "videogpa_flash_attn_fwd_d128_bf16", _kernels._FWD_ARGS
        else:
            symbol = f"videogpa_{name}"
            # the older backward interface has no O: its kernel does not take delta itself
            takes_o = name != "flash_attn_short" and "const void* o, const void* dout" in src
            argtypes = (_kernels._SIGNATURES[name][2] if name == "flash_attn_short" or takes_o
                        else OLD_BWD_ARGS)
        old[name] = (_build(other, name, symbol, argtypes), argtypes is OLD_BWD_ARGS)
    _kernels.build(list(old))
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

    def bwd_old(name, layout, q, k, v, o, lse, do):
        """The other checkout's backward ``name`` on the same operands."""
        fn, takes_delta = old[name]
        B, N, H, D, *_ = A._dims(q, layout)
        nk = A._dims(k, layout)[1]
        if not takes_delta:  # this checkout's interface: its wrapper, the other's entry
            wrapper = getattr(A, name)

            def swapped():
                mine = _kernels.kernel(name)
                _kernels._loaded[name] = fn
                try:
                    return wrapper(q, k, v, o, lse, do, layout=layout)
                finally:
                    _kernels._loaded[name] = mine

            return swapped

        def run():
            delta = (o.float() * do.float()).sum(-1)
            delta = (delta.transpose(1, 2) if layout == "bnhd" else delta).contiguous()
            grads = [torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v)]
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(g.data_ptr() for g in grads), B, H, N, nk, D,
                    *_strides(layout, q, k, v, do, *grads), D ** -0.5, stream)
            assert rc == 0, rc
            return grads

        return run

    # K3 at the CogVideoX-5B training shape
    B, N, H, D = 1, 17776, 48, 64
    q, k, v = cs._attn_case(gen, B, N, N, H, D, "bnhd")
    o, lse = A.flash_attn_fwd(q, k, v, layout="bnhd", with_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    turns("k3_cogvideox_train", bwd_old("flash_attn_bwd", "bnhd", q, k, v, o, lse, do),
          lambda: A.flash_attn_bwd(q, k, v, o, lse, do, layout="bnhd"), 5)
    del q, k, v, o, lse, do

    # K4 at the VGGT frame shape
    q, k, v = torch.randn(40, 1374, 3, 16, 64, generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)

    def k4_old():
        o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
        rc = old["flash_attn_short"][0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 40, 16, 1374, 1374, 64,
            *_strides("bnhd", q, k, v, o), 64 ** -0.5 * LOG2E, stream)
        assert rc == 0, rc
        return (o,)

    turns("k4_vggt_frame", k4_old, lambda: (A.flash_attn_short(q, k, v),), 50)
    del q, k, v

    # K6 (without and with LSE) and K7 at the Wan self and cross shapes
    B, N, H, D = 1, 18480, 24, 128
    q = cs._proj_views(gen, B, N, H, D)
    for tag, nk, iters in (("wan_self", N, 5), ("wan_cross", 512, 20)):
        k, v = cs._proj_views(gen, B, nk, H, D), cs._proj_views(gen, B, nk, H, D)
        for with_lse in (False, True):
            def k6_old():
                o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
                lse = (torch.empty((B, H, N), dtype=torch.float32, device="cuda") if with_lse
                       else None)
                rc = old["flash_attn_fwd_d128"][0](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), A._ptr(lse), B, H,
                    N, nk, D, *_strides("bhnd", q, k, v, o), D ** -0.5 * LOG2E, stream)
                assert rc == 0, rc
                return (o,) if lse is None else (o, lse)

            turns(f"k6_{tag}{'_lse' if with_lse else ''}", k6_old,
                  lambda: tuple(x for x in A.flash_attn_fwd_d128(q, k, v, layout="bhnd",
                                                                 with_lse=with_lse)
                                if x is not None), iters * 2)
        o, lse = A.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
        do = cs._proj_views(gen, B, N, H, D).contiguous()
        turns(f"k7_{tag}", bwd_old("flash_attn_bwd_d128", "bhnd", q, k, v, o, lse, do),
              lambda: A.flash_attn_bwd_d128(q, k, v, o, lse, do, layout="bhnd"), iters)
        del k, v, o, lse, do
    cs.log("[ab] " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
