#!/usr/bin/env python3
"""Time the port's wgmma kernels K1 (``flash_attn_fwd``), K3
(``flash_attn_bwd``), K4 (``flash_attn_short``), K6 (``flash_attn_fwd_d128``,
bf16), K7 (``flash_attn_bwd_d128``), K8 (``flash_attn_int8``) and K9
(``flash_attn_int8_d128``), and K6's float32 entry (``flash_attn_fwd_f32``),
against another checkout's on one NVIDIA GPU, in one process.

    python3 kernel_ab.py OTHER_CHECKOUT
    python3 kernel_ab.py --f32-bwd OTHER_CHECKOUT  # the f32 backward alone
    python3 kernel_ab.py --wide OTHER_CHECKOUT     # the entries above head_dim 128
    python3 kernel_ab.py --int8-f32 OTHER_CHECKOUT # the int8-QK forward with an f32 V
    python3 kernel_ab.py --variant NAME DEST   # a copy of this tree's kernels
                                               # with one design choice reverted

Builds OTHER_CHECKOUT/videogpa_torch/csrc/{flash_attn_fwd, flash_attn_bwd,
flash_attn_short, flash_attn_fwd_d128, flash_attn_bwd_d128,
flash_attn_int8}.cu with this checkout's nvcc flags into build/ab/ (all at
once), then times each kernel at its main-path shapes in turns, other /
this / this / other, with CUDA events on the same operands: K1 at the
CogVideoX-5B denoise shape (2, 17,776, 48, 64), its train shape with LSE and
the VGGT-1B global blocks' shape (4, 13,740, 16, 64); K3 at the CogVideoX-5B
training shape (1, 17,776, 48, 64); K4 at VGGT's frame attention (40, 1,374,
16, 64) from strided views of a packed projection; K6 without and with LSE
and K7 at the Wan2.2-TI2V-5B self- and cross-attention shapes from strided
projection views; K8 at the CogVideoX-5B denoise and VGGT-1B global shapes
and K9 at the Wan self-attention shape, on the same ``quantize_qk_int8``
operands; K6 f32 at the
camera head (4, 10, 16, 128), a call through this checkout's wrapper with
the other's C entry (and the kernel's own device time a call, by
torch.profiler), and at the f32 scorer's frame and global rows. When
OTHER_CHECKOUT holds the whole package, its own ``flash_attn_fwd_f32``
wrapper is also timed a call at the camera head, in a subprocess there, in
turns with this checkout's. A backward whose C interface takes delta =
rowsum(O * dO) from its caller (K3 and K7 before their wgmma redesigns) is
timed with that eager reduction, as its wrapper ran it. The other checkout's
sources must have this checkout's C interfaces or those older ones. Prints
the card and one JSON line.

``--f32-bwd`` times only the CUDA-core backward (``flash_attn_bwd_f32``:
``csrc/flash_attn_bwd_f32.cu``, at head_dim 128 ``csrc/flash_attn_bwd_wide_f32.cu``)
against OTHER_CHECKOUT's, in turns, at the camera head (4, 10, 16, 128), the
scorer's frame rows (40, 1,374, 16, 64), one long row (1, 4,096, 16, 64) and
B*H = 66,000 at N 24. The other side may have this interface or the one
before the kernel's redesign (three launches, delta taken as scratch, seven
products); its entry at head_dim 128 is ``videogpa_flash_attn_bwd_f32`` of
its ``flash_attn_bwd_f32.cu`` where it has no ``flash_attn_bwd_wide_f32.cu``.

``--wide`` times the entries above head_dim 128 (``flash_attn_fwd_wide``,
``flash_attn_bwd_wide``) in f32 and bf16 at (1, 4,096, 16, 256), and the f32
backward also at (1, 4,096, 8, 512), against OTHER_CHECKOUT's, in turns,
through this checkout's wrappers with the other's C entries: its bf16
entries in ``flash_attn_fwd_wide_bf16.cu`` / ``flash_attn_bwd_wide.cu`` where
it has them, else the CUDA-core ones of ``flash_attn_fwd_wide.cu`` /
``flash_attn_bwd_f32.cu`` (whose bf16 backward takes the CUDA-core
backward's scratch); its f32 backward in ``flash_attn_bwd_wide_f32.cu`` where
it has one, else in ``flash_attn_bwd_f32.cu``.

``--int8-f32`` times ``flash_attn_int8_f32`` at the f32 scorer's global rows
(4, 13,740, 16, 64), and at head_dim 16, 32 and 128 on the same rows,
against OTHER_CHECKOUT's C entry (in its ``flash_attn_int8_f32.cu``, else its
``flash_attn_fwd_wide.cu``) on the same ``quantize_qk_int8`` operands, in
turns.

``--variant`` writes DEST/videogpa_torch/csrc: this checkout's sources with
one of the design choices of ``VARIANTS`` reverted, for a run against it.
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
# the f32 backward's interface before its redesign: delta as the only scratch
OLD_BWD_F32_ARGS = [_P] * 10 + [_I] * 5 + [_LL] * 24 + [_F, _P]


# design choices of this tree, each reverted by regular-expression
# substitutions in one source: name -> (source, [(pattern, replacement)])
VARIANTS = {
    # K1 with two consumer warpgroups (128-query items, 232 registers)
    # instead of three (192-query items, 160 registers)
    "k1_two_consumer_wgs": ("flash_attn_fwd", [
        (r"constexpr int kConsumerWGs = \d+;", "constexpr int kConsumerWGs = 2;")]),
    # K1 with a two-stage K/V ring instead of four stages
    "k1_two_stages": ("flash_attn_fwd", [
        (r"constexpr int kStages = \d+;", "constexpr int kStages = 2;")]),
    # K8 / K9 converting the s32 scores by the integer-add trick (the bits
    # 0x4B400000 + s are the float 1.5 * 2^23 + s, exact for |s| < 2^22)
    # instead of one I2F
    "int8_magic": ("flash_attn_int8", [
        (r"static_cast<float>\(si\[4 \* c \+ e\]\)",
         "(__int_as_float(si[4 * c + e] + 0x4B400000) - 12582912.f)")]),
    # K8 with two consumer warpgroups (128-query items, 232 registers)
    # instead of three (192-query items, 160 registers)
    "int8_two_consumer_wgs": ("flash_attn_int8", [
        (r"constexpr int kConsumerWGs = \d+;", "constexpr int kConsumerWGs = 2;")]),
    # the f32 backward with 8 x 4 register micro-tiles for S^T and dP^T (two
    # passes over the query halves, 12 float4 loads per 128 FMAs) instead of
    # 8 x 8 (16 per 256)
    "f32_bwd_8x4_tiles": ("flash_attn_bwd_f32", [
        (r"constexpr int kQueriesPerPass = 8;", "constexpr int kQueriesPerPass = 4;")]),
    # the f32 backward at D = 64 with two cp.async stages and so one CTA an
    # SM, instead of one stage (issued before the dQ product) and two CTAs
    "f32_bwd_two_stages": ("flash_attn_bwd_f32", [
        (r"static constexpr int kStages = DC <= 32 \? 2 : 1;", "static constexpr int kStages = 2;")]),
    # the f32 backward issuing the next tile's copies at the top of the step
    # instead of before the dQ product
    "f32_bwd_late_issue": ("flash_attn_bwd_f32", [
        (r"static constexpr bool kEarly = kStages == 1;", "static constexpr bool kEarly = false;")]),
    # the f32 backward adding dQ's partials by scalar red.add instead of
    # 16-byte vector red.add
    "f32_bwd_scalar_red": ("flash_attn_bwd_f32", [
        (r"red_add4\(p, x\[0\], x\[1\], x\[2\], x\[3\]\);",
         "for (int e = 0; e < 4; ++e) red_add(p + e, x[e]);")]),
    # the f32 backward with the library exp2f instead of one ex2.approx.ftz
    "f32_bwd_exp2f": ("flash_attn_bwd_f32", [
        (r"exp2_ftz\(fmaf\(sacc", "exp2f(fmaf(sacc")]),
    # the f32 backward visiting a key tile's query tiles and adding dQ's
    # partials in order of the key tiles at every shape, instead of the
    # diagonal order while a head's key tiles fit the grid
    "f32_bwd_in_order": ("flash_attn_bwd_f32", [
        (r"p\.diag = p\.n_kt > 1 && p\.n_kt <= grid \? 1 : 0;", "p.diag = 0;")]),
    # the f32 wide backward visiting the query tiles and adding dQ's partials
    # in order of the key tiles at every shape, instead of the diagonal order
    # while a head's key tiles fit the grid of clusters
    "f32_bwd_wide_in_order": ("flash_attn_bwd_wide_f32", [
        (r"p\.diag = p\.n_kt > 1 && p\.n_kt <= grid \? 1 : 0;", "p.diag = 0;")]),
    # K8 f32 with two consumer warpgroups at head_dim <= 64 instead of three
    "int8_f32_two_consumer_wgs": ("flash_attn_int8_f32", [
        (r"static constexpr int kWGs = D == 128 \? 2 : 3;", "static constexpr int kWGs = 2;")]),
    # K8 f32 converting the s32 scores by the integer-add trick instead of
    # one I2F (exact: |s| < 2^22)
    "int8_f32_magic": ("flash_attn_int8_f32", [
        (r"static_cast<float>\(si\[4 \* c \+ e\]\)",
         "(__int_as_float(si[4 * c + e] + 0x4B400000) - 12582912.f)")]),
    # K8 f32 with a three-stage K8 / V ring at head_dim <= 64 instead of two
    "int8_f32_three_stages": ("flash_attn_int8_f32", [
        (r"static constexpr int kStages = 2;", "static constexpr int kStages = D == 128 ? 2 : 3;")]),
    # K6 f32 computing whole 64 x 64 tiles: no skip of rows past Nq or keys
    # past Nk (those rows are loaded as copies of the last live row, so their
    # values stay finite)
    "f32_whole_tiles": ("flash_attn_fwd_d128", [
        (r"if \(rows_live && cg < kn\)", "if (true)"),
        (r"key < \(rows_live \? kn : 0\)", "key < kF32Block"),
        (r"const int rows = min\(kF32Block, n - row0\);",
         "const int rows = kF32Block;\n  const int last = n - row0 - 1;"),
        (r"src \+ r \* sn \+ d", "src + min(r, last) * sn + d"),
    ]),
}


def make_variant(name: str, dest: str) -> None:
    """This checkout's csrc in DEST with the design choice ``name`` reverted."""
    import re
    import shutil

    source, subs = VARIANTS[name]
    csrc = os.path.join(dest, "videogpa_torch", "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "videogpa_torch", "csrc"), csrc)
    path = os.path.join(csrc, f"{source}.cu")
    text = open(path).read()
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n == 0:
            raise SystemExit(f"kernel_ab: variant {name}: {pattern!r} not found in {source}.cu")
    open(path, "w").write(text)


def _build_all(other: str, names):
    """Compile each other/.../csrc/<name>.cu into build/ab/<name>.so, all at
    once; returns the loaded libraries."""
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(other, "videogpa_torch", "csrc", f"{name}.cu")
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
             os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: building the other {name}.cu failed:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def _entry(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


# the other checkout's own f32 wrapper a call at the camera head's shape
_OTHER_F32_CALL = """
import json, torch
from videogpa_torch.ops import attention as A
g = torch.Generator(device="cuda").manual_seed(92)
q, k, v = (torch.randn(4, 10, 16, 128, generator=g, device="cuda") for _ in range(3))
for _ in range(3):
    A.flash_attn_fwd_f32(q, k, v)
s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
s.record()
for _ in range(200):
    A.flash_attn_fwd_f32(q, k, v)
e.record()
torch.cuda.synchronize()
print(json.dumps(s.elapsed_time(e) / 200))
"""


def _other_f32_call_ms(other: str) -> float:
    out = subprocess.run([sys.executable, "-c", _OTHER_F32_CALL], cwd=other, check=True,
                         capture_output=True, text=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _swapped(name: str, fn, call):
    """``call()`` with the C entry ``name`` replaced by ``fn``."""
    mine = _kernels.kernel(name)
    _kernels._loaded[name] = fn
    try:
        return call()
    finally:
        _kernels._loaded[name] = mine


def _f32_bwd_ab(other: str) -> dict:
    """``--f32-bwd``: this checkout's f32 backward against OTHER's, in turns
    (other / this / this / other) on the same operands; both must agree."""
    import torch

    from videogpa_torch.ops import attention as A

    csrc = os.path.join(other, "videogpa_torch", "csrc")
    has_wide = os.path.exists(os.path.join(csrc, "flash_attn_bwd_wide_f32.cu"))
    libs = _build_all(other, ("flash_attn_bwd_f32",) + (("flash_attn_bwd_wide_f32",)
                                                         if has_wide else ()))
    src = open(os.path.join(csrc, "flash_attn_bwd_f32.cu")).read()
    new_interface = "dq_acc" in src
    entry = _entry(libs["flash_attn_bwd_f32"], "videogpa_flash_attn_bwd_f32",
                   _kernels._BWD_F32_ARGS if new_interface else OLD_BWD_F32_ARGS)
    # the other's entry at head_dim 128
    entry_128 = (_entry(libs["flash_attn_bwd_wide_f32"], "videogpa_flash_attn_bwd_wide_f32",
                        _kernels._BWD_F32_ARGS) if has_wide else entry)
    _kernels.build(("flash_attn_bwd_f32", "flash_attn_bwd_wide_f32"))
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(93)
    res = {}
    bwd = A.flash_attn_bwd_f32
    cases = [("camera_head", (4, 10, 16, 128), 200), ("frame_rows", (40, 1374, 16, 64), 3),
             ("long_row", (1, 4096, 16, 64), 5), ("bh_66000", (2, 24, 33000, 64), 5)]
    for tag, (B, N, H, D), iters in cases:
        q, k, v, do = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(4))
        o, lse = A.flash_attn_fwd_f32(q, k, v, layout="bnhd", with_lse=True)
        if new_interface:  # this checkout's wrapper, the other's entry
            def old():
                if D < 128:
                    return _swapped("flash_attn_bwd_f32", entry,
                                    lambda: bwd(q, k, v, o, lse, do, layout="bnhd"))
                return _swapped("flash_attn_bwd_wide_f32", entry_128,
                                lambda: bwd(q, k, v, o, lse, do, layout="bnhd"))
        else:
            def old():
                delta = torch.empty((B * H, N), dtype=torch.float32, device="cuda")
                grads = [torch.empty_like(x) for x in (q, k, v)]
                rc = entry(*(x.data_ptr() for x in (q, k, v, o, do, lse, *grads, delta)), B, H,
                           N, N, D, *_strides("bnhd", q, k, v, o, do, *grads), D ** -0.5, stream)
                assert rc == 0, rc
                return grads

        def new():
            return bwd(q, k, v, o, lse, do, layout="bnhd")

        for a, b in zip(old(), new()):
            if not torch.allclose(a, b, atol=1e-4, rtol=1e-4):
                raise SystemExit(f"kernel_ab: the two f32 backwards disagree at {tag}")
        t = [cs.cuda_ms(f, iters) for f in (old, new, new, old)]
        res[tag] = {"shape_bnhd": [B, N, H, D], "other_ms": [t[0], t[3]],
                    "this_ms": [t[1], t[2]]}
        cs.log(f"[ab] f32 backward {tag} {(B, N, H, D)}: other "
               f"{t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms")
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return res


def _wide_ab(other: str) -> dict:
    """``--wide``: this checkout's entries above head_dim 128 against OTHER's,
    forward and backward in f32 and bf16 at (1, 4,096, 16, 256), in turns
    (other / this / this / other) on the same operands; both must agree."""
    import torch

    from videogpa_torch.ops import attention as A

    csrc = os.path.join(other, "videogpa_torch", "csrc")
    has = {n: os.path.exists(os.path.join(csrc, f"{n}.cu"))
           for n in ("flash_attn_fwd_wide_bf16", "flash_attn_bwd_wide", "flash_attn_bwd_wide_f32")}
    libs = _build_all(other, ("flash_attn_fwd_wide", "flash_attn_bwd_f32",
                              *(n for n, there in has.items() if there)))
    _kernels.build(("flash_attn_fwd_wide", "flash_attn_fwd_wide_bf16", "flash_attn_bwd_wide",
                    "flash_attn_bwd_wide_f32"))
    bwd_f32_lib = libs["flash_attn_bwd_wide_f32" if has["flash_attn_bwd_wide_f32"]
                       else "flash_attn_bwd_f32"]
    fwd_bf16_lib = libs["flash_attn_fwd_wide_bf16" if has["flash_attn_fwd_wide_bf16"]
                        else "flash_attn_fwd_wide"]
    others = {
        "flash_attn_fwd_wide_f32": _entry(libs["flash_attn_fwd_wide"],
                                          "videogpa_flash_attn_fwd_wide_f32", _kernels._FWD_ARGS),
        "flash_attn_fwd_wide_bf16": _entry(fwd_bf16_lib, "videogpa_flash_attn_fwd_wide_bf16",
                                           _kernels._FWD_ARGS),
        "flash_attn_bwd_wide_f32": _entry(bwd_f32_lib, "videogpa_flash_attn_bwd_wide_f32",
                                          _kernels._BWD_F32_ARGS),
    }
    if has["flash_attn_bwd_wide"]:
        others["flash_attn_bwd_wide_bf16"] = _entry(
            libs["flash_attn_bwd_wide"], "videogpa_flash_attn_bwd_wide_bf16",
            _kernels._BWD_WIDE_ARGS)
    else:  # the CUDA-core bf16 entry, with the CUDA-core backward's scratch
        _kernels._loaded["other:flash_attn_bwd_wide_bf16"] = _entry(
            libs["flash_attn_bwd_f32"], "videogpa_flash_attn_bwd_wide_bf16",
            _kernels._BWD_F32_ARGS)
    gen = torch.Generator(device="cuda").manual_seed(94)
    res = {}
    for dtype, suffix, (B, N, H, D), fwd_iters, bwd_iters in (
            (torch.bfloat16, "bf16", (1, 4096, 16, 256), 20, 10),
            (torch.float32, "f32", (1, 4096, 16, 256), 3, 2),
            (torch.float32, "f32", (1, 4096, 8, 512), 0, 1)):
        q, k, v, do = (torch.randn(B, N, H, D, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        fwd_entry, bwd_entry = f"flash_attn_fwd_wide_{suffix}", f"flash_attn_bwd_wide_{suffix}"

        def fwd_new():
            return A.flash_attn_fwd_wide(q, k, v, layout="bnhd", with_lse=True)

        def fwd_old():
            return _swapped(fwd_entry, others[fwd_entry], fwd_new)

        o, lse = fwd_new()

        def bwd_new():
            return A.flash_attn_bwd_wide(q, k, v, o, lse, do, layout="bnhd")

        if bwd_entry in others:
            def bwd_old():
                return _swapped(bwd_entry, others[bwd_entry], bwd_new)
        else:
            def bwd_old():
                return A._launch_bwd_f32("flash_attn_bwd_wide", "other:flash_attn_bwd_wide_bf16",
                                         A.WIDE_HEAD_DIMS, dtype, q, k, v, o, lse, do, "bnhd")

        cases = [(f"wide_{suffix}_d{D}", bwd_old, bwd_new, bwd_iters)]
        if fwd_iters:
            cases.insert(0, (f"wide_fwd_{suffix}_d{D}", fwd_old, fwd_new, fwd_iters))
        for tag, old, new, iters in cases:
            for a, b in zip(old(), new()):
                if not torch.allclose(a.float(), b.float(), atol=tol, rtol=tol):
                    raise SystemExit(f"kernel_ab: the two versions disagree at {tag}")
            t = [cs.cuda_ms(f, iters) for f in (old, new, new, old)]
            res[tag] = {"shape_bnhd": [B, N, H, D], "other_ms": [t[0], t[3]],
                        "this_ms": [t[1], t[2]]}
            cs.log(f"[ab] {tag} {(B, N, H, D)}: other {t[0]:.4f} / {t[3]:.4f} ms, this "
                   f"{t[1]:.4f} / {t[2]:.4f} ms")
        if dtype == torch.float32:
            res[f"wide_f32_d{D}"]["walk"] = _kernels.bwd_wide_f32_walk()
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return res


def _int8_f32_ab(other: str) -> dict:
    """``--int8-f32``: this checkout's ``flash_attn_int8_f32`` against
    OTHER's C entry at (4, 13,740, 16, D) for D = 64, 16, 32 and 128, in
    turns (other / this / this / other) on the same quantised operands; both
    must agree."""
    import torch

    from videogpa_torch.ops import attention as A

    source = ("flash_attn_int8_f32" if os.path.exists(os.path.join(
        other, "videogpa_torch", "csrc", "flash_attn_int8_f32.cu")) else "flash_attn_fwd_wide")
    other_entry = _entry(_build_all(other, (source,))[source], "videogpa_flash_attn_int8_f32",
                         _kernels._INT8_ARGS)
    _kernels.build(("flash_attn_int8_f32",))
    gen = torch.Generator(device="cuda").manual_seed(95)
    res = {}
    for D in (64, 16, 32, 128):
        B, N, H = 4, 13740, 16
        q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(3))
        ops = A.quantize_qk_int8(q, k + 0.5, "bnhd")

        def new():
            return (A.flash_attn_int8_f32(*ops, v, layout="bnhd"),)

        def old():
            return _swapped("flash_attn_int8_f32", other_entry, new)

        for a, b in zip(old(), new()):
            if not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
                raise SystemExit(f"kernel_ab: the two int8 f32 forwards disagree at D = {D}")
        t = [cs.cuda_ms(f, 3 if D <= 64 else 2) for f in (old, new, new, old)]
        cs.log(f"[ab] int8_f32 {(B, N, H, D)}: other {t[0]:.4f} / {t[3]:.4f} ms, this "
               f"{t[1]:.4f} / {t[2]:.4f} ms")
        res[f"int8_f32_d{D}"] = {"shape_bnhd": [B, N, H, D], "other_ms": [t[0], t[3]],
                                 "this_ms": [t[1], t[2]]}
        del q, k, v, ops
        torch.cuda.empty_cache()
    return res


def _strides(layout, *xs):
    out = []
    for x in xs:
        out += A._dims(x, layout)[4:]
    return out


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        make_variant(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--f32-bwd" and torch.cuda.is_available():
        cs.log(cs.gpu_name_and_power())
        cs.log("[ab] " + json.dumps({"f32_bwd": _f32_bwd_ab(sys.argv[2])}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--int8-f32" and torch.cuda.is_available():
        cs.log(cs.gpu_name_and_power())
        cs.log("[ab] " + json.dumps({"int8_f32": _int8_f32_ab(sys.argv[2])}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--wide" and torch.cuda.is_available():
        cs.log(cs.gpu_name_and_power())
        cs.log("[ab] " + json.dumps({"wide": _wide_ab(sys.argv[2])}))
        return 0
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = sys.argv[1]
    cs.log(cs.gpu_name_and_power())
    names = ("flash_attn_fwd", "flash_attn_bwd", "flash_attn_short", "flash_attn_fwd_d128",
             "flash_attn_bwd_d128", "flash_attn_int8")
    libs = _build_all(other, names)
    old = {}
    for name in names:
        src = open(os.path.join(other, "videogpa_torch", "csrc", f"{name}.cu")).read()
        if name == "flash_attn_fwd_d128":
            symbol, argtypes = "videogpa_flash_attn_fwd_d128_bf16", _kernels._FWD_ARGS
            old["flash_attn_fwd_f32"] = _entry(libs[name], "videogpa_flash_attn_fwd_f32",
                                               _kernels._FWD_ARGS)
        elif name == "flash_attn_fwd":
            symbol, argtypes = "videogpa_flash_attn_fwd", _kernels._FWD_ARGS
        elif name == "flash_attn_int8":
            symbol, argtypes = "videogpa_flash_attn_int8", _kernels._INT8_ARGS
            old["flash_attn_int8_d128"] = _entry(libs[name], "videogpa_flash_attn_int8_d128",
                                                 _kernels._INT8_ARGS)
        else:
            symbol = f"videogpa_{name}"
            # the older backward interface has no O: its kernel does not take delta itself
            takes_o = name != "flash_attn_short" and "const void* o, const void* dout" in src
            argtypes = (_kernels._SIGNATURES[name][2] if name == "flash_attn_short" or takes_o
                        else OLD_BWD_ARGS)
        old[name] = (_entry(libs[name], symbol, argtypes), argtypes is OLD_BWD_ARGS)
    _kernels.build(names)
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

    def fwd_old(entry, layout, q, k, v, with_lse):
        """The other checkout's forward C entry (K1's interface) on the same
        operands."""
        B, N, H, D, *_ = A._dims(q, layout)
        nk = A._dims(k, layout)[1]

        def run():
            o = torch.empty(q.shape, dtype=q.dtype, device="cuda")
            lse = (torch.empty((B, H, N), dtype=torch.float32, device="cuda") if with_lse
                   else None)
            rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), A._ptr(lse), B, H,
                       N, nk, D, *_strides(layout, q, k, v, o), D ** -0.5 * LOG2E, stream)
            assert rc == 0, rc
            return (o,) if lse is None else (o, lse)

        return run

    def fwd_new(fn, q, k, v, with_lse, layout="bnhd"):
        return lambda: tuple(x for x in fn(q, k, v, layout=layout, with_lse=with_lse)
                             if x is not None)

    # K1 at the CogVideoX-5B denoise and train shapes and the VGGT global
    # blocks' shape (v a strided view of the packed projection there)
    for tag, (B, N, H, D), with_lse in (("k1_cogvideox_denoise", (2, 17776, 48, 64), False),
                                        ("k1_cogvideox_train_lse", (1, 17776, 48, 64), True),
                                        ("k1_vggt_global", (4, 13740, 16, 64), False)):
        if tag == "k1_vggt_global":
            q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(
                torch.bfloat16).unbind(2)
            q, k = q.contiguous(), k.contiguous()
        else:
            q, k, v = cs._attn_case(gen, B, N, N, H, D, "bnhd")
        turns(tag, fwd_old(old["flash_attn_fwd"][0], "bnhd", q, k, v, with_lse),
              fwd_new(A.flash_attn_fwd, q, k, v, with_lse), 10)
        del q, k, v

    # K6 f32: the camera head a call (this checkout's wrapper, the other's C
    # entry swapped in) and the f32 scorer's frame and global rows
    B, N, H, D = 4, 10, 16, 128
    q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(3))

    def f32_swapped():
        mine = _kernels.kernel("flash_attn_fwd_f32")
        _kernels._loaded["flash_attn_fwd_f32"] = old["flash_attn_fwd_f32"]
        try:
            return A.flash_attn_fwd_f32(q, k, v)[:1]
        finally:
            _kernels._loaded["flash_attn_fwd_f32"] = mine

    def f32_this():
        return A.flash_attn_fwd_f32(q, k, v)[:1]

    turns("k6_f32_camera_call", f32_swapped, f32_this, 200)
    t = [cs._device_ms_per_call(f, 200, "attn_f32_kernel")
         for f in (f32_swapped, f32_this, f32_this, f32_swapped)]
    res["k6_f32_camera_device"] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
    if os.path.exists(os.path.join(other, "videogpa_torch", "ops", "attention.py")):
        this_call = lambda: cs.cuda_ms(lambda: A.flash_attn_fwd_f32(q, k, v), 200)  # noqa: E731
        t = [_other_f32_call_ms(other), this_call(), this_call(), _other_f32_call_ms(other)]
        res["k6_f32_camera_wrapper_call"] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
    del q, k, v
    for tag, (B, N, H, D), iters in (("k6_f32_frame", (40, 1374, 16, 64), 3),
                                     ("k6_f32_global", (4, 13740, 16, 64), 1)):
        q, k, v = (torch.randn(B, N, H, D, generator=gen, device="cuda") for _ in range(3))
        turns(tag, fwd_old(old["flash_attn_fwd_f32"], "bnhd", q, k, v, False),
              fwd_new(A.flash_attn_fwd_f32, q, k, v, False), iters)
        del q, k, v
    torch.cuda.empty_cache()

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
            turns(f"k6_{tag}{'_lse' if with_lse else ''}",
                  fwd_old(old["flash_attn_fwd_d128"][0], "bhnd", q, k, v, with_lse),
                  fwd_new(A.flash_attn_fwd_d128, q, k, v, with_lse, layout="bhnd"), iters * 2)
        o, lse = A.flash_attn_fwd_d128(q, k, v, layout="bhnd", with_lse=True)
        do = cs._proj_views(gen, B, N, H, D).contiguous()
        turns(f"k7_{tag}", bwd_old("flash_attn_bwd_d128", "bhnd", q, k, v, o, lse, do),
              lambda: A.flash_attn_bwd_d128(q, k, v, o, lse, do, layout="bhnd"), iters)
        del k, v, o, lse, do
    del q
    torch.cuda.empty_cache()

    # K8 at the CogVideoX-5B denoise and VGGT-1B global shapes, K9 at the
    # Wan self-attention shape: the other checkout's C entry (same interface)
    # on the same quantised operands
    for tag, entry, fn, (B, N, H, D), iters in (
            ("k8_cogvideox_denoise", old["flash_attn_int8"][0], A.flash_attn_int8,
             (2, 17776, 48, 64), 10),
            ("k8_vggt_global", old["flash_attn_int8"][0], A.flash_attn_int8,
             (4, 13740, 16, 64), 10),
            ("k9_wan_self", old["flash_attn_int8_d128"], A.flash_attn_int8_d128,
             (1, 18480, 24, 128), 5)):
        q, k, v = cs._int8_case(gen, B, N, N, H, D, "bnhd")
        ops = A.quantize_qk_int8(q, k, "bnhd")

        def int8_old(entry=entry, ops=ops, v=v, B=B, N=N, H=H, D=D):
            q8, sq, k8, sk = ops
            o = torch.empty(q8.shape, dtype=v.dtype, device="cuda")
            rc = entry(q8.data_ptr(), sq.data_ptr(), k8.data_ptr(), sk.data_ptr(), v.data_ptr(),
                       o.data_ptr(), B, H, N, N, D,
                       *_strides("bnhd", q8, sq.unsqueeze(-1), k8, sk.unsqueeze(-1), v, o),
                       stream)
            assert rc == 0, rc
            return (o,)

        turns(tag, int8_old, lambda fn=fn, ops=ops, v=v: (fn(*ops, v, layout="bnhd"),), iters)
        del q, k, v, ops
    cs.log("[ab] " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
