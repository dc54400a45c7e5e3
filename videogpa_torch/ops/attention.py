"""Multi-head attention: hand-written Hopper flash kernels + plain PyTorch versions.

Counterpart of ``videogpa_tpu/ops/attention.py``. Every attention in VideoGPA
is bidirectional (non-causal). Each kernel wrapper dispatches on the device
of its operands: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.

- ``flash_attn_fwd`` (K1, ``csrc/flash_attn_fwd.cu``): bf16 at head_dim
  16-64 on wgmma + TMA, a persistent grid, optional LSE.
- ``flash_attn_bwd`` (K3, ``csrc/flash_attn_bwd.cu``): its backward, on
  wgmma + TMA; computes delta = rowsum(O * dO) itself.
- ``flash_attn_short`` (K4, ``csrc/flash_attn_short.cu``): bf16 (B, N, H, D)
  rows of at most 2,048 keys, one-pass online softmax on wgmma + TMA,
  ``n_valid`` mask, inference only.
- ``flash_attn_fwd_d128`` (K6, ``csrc/flash_attn_fwd_d128.cu``): bf16 at
  head_dim 128 on wgmma + TMA, a persistent grid, optional LSE.
- ``flash_attn_bwd_d128`` (K7, ``csrc/flash_attn_bwd_d128.cu``): its backward,
  on wgmma + TMA; computes delta = rowsum(O * dO) itself.
- ``flash_attn_fwd_f32`` (K6's float32 entry, same source): float32 at
  head_dim 16-128 on CUDA cores, tiled (64-query CTAs on a flat grid, K and
  V staged in shared memory by 64-key tiles), for short and long rows.
- ``flash_attn_bwd_f32`` (the float32 entry of K3/K7): its backward at
  head_dim 16-128 on CUDA cores, a delta prologue and one fused kernel over
  key tiles (a persistent grid) that sums dQ across key tiles in a fixed
  order, so runs are bit-stable: ``csrc/flash_attn_bwd_f32.cu`` at 16-64,
  ``csrc/flash_attn_bwd_wide_f32.cu`` (one CTA of two 64-column slots) at
  128.
- ``flash_attn_fwd_wide`` and ``flash_attn_bwd_wide``: the forward and
  backward at any head_dim above 128 that is a multiple of 64. bf16 runs on
  wgmma + TMA (``csrc/flash_attn_fwd_wide_bf16.cu``: K6's persistent scheme
  with S computed once a key tile for slices of O of up to 256 columns;
  ``csrc/flash_attn_bwd_wide.cu``: a dK/dV kernel over key tiles and a dQ
  kernel over query tiles, bit-stable); float32 on the CUDA cores
  (``csrc/flash_attn_fwd_wide.cu``: S once a key tile for slices of up to
  256 columns; ``csrc/flash_attn_bwd_wide_f32.cu``: two 64-column slots a
  CTA, the CTAs of a key tile in a thread block cluster summing the slots'
  partial S and dP, so S and dP are computed once a tile pair).
- ``flash_attn_int8`` (K8) and ``flash_attn_int8_d128`` (K9), both in
  ``csrc/flash_attn_int8.cu``: the int8-QK forward on operands quantised by
  ``quantize_qk_int8``, inference only, at head_dim < 128 and at 128; QK^T
  on int8 wgmma, PV on bf16 wgmma, TMA, a persistent grid.
- ``flash_attn_int8_f32`` (``csrc/flash_attn_int8_f32.cu``): the same
  function with a float32 V at head_dim 16-128: QK^T on int8 wgmma, P and
  PV in f32 on the CUDA cores, TMA and cp.async, a persistent grid.

``attention`` routes as the JAX package does for bf16, and sends float32
operands to ``flash_attn_fwd_f32``, since the tensor-core kernels take bf16
and rounding f32 operands would move the f32 heads away from the JAX
package's.
It differentiates with a ``torch.autograd.Function`` whenever an operand
requires grad: through K1 and K3 at head_dim < 128, through K6 and K7 at
head_dim 128, through K6's and K3/K7's float32 entries for float32 operands,
through the wide entries above 128. On CUDA a head_dim between the kernels'
widths (16, 32, 64, 128, then every multiple of 64) is zero-padded to the
next one, with the softmax scale of the original head_dim passed to the
kernel and O sliced back: zero columns add nothing to QK^T or to PV, so the
function is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from videogpa_torch.ops import _kernels

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (16, 32, 64)
# the head dims some kernel takes up to 128; above it the wide entries take
# every multiple of WIDE_MULTIPLE, and ``attention`` pads any D up to one
HEAD_DIM_WIDTHS = (16, 32, 64, 128)
WIDE_MULTIPLE = 64


# the head dims of the wide entries: every multiple of 64 above 128
WIDE_HEAD_DIMS = range(128 + WIDE_MULTIPLE, 1 << 16, WIDE_MULTIPLE)


def _scale(D: int, softmax_scale: Optional[float]) -> float:
    return D ** -0.5 if softmax_scale is None else float(softmax_scale)


def padded_head_dim(D: int) -> int:
    """The least kernel width that holds head_dim ``D``: 16, 32, 64 or 128,
    and above 128 the next multiple of 64 (160 -> 192; 256 and 512 stay)."""
    for w in HEAD_DIM_WIDTHS:
        if D <= w:
            return w
    return _round_up(D, WIDE_MULTIPLE)


def _reference(q, k, v, n_valid=None, with_lse=False, softmax_scale=None):
    """(B, H, N, D) operands; f32 scores and softmax, P cast to V's dtype
    before PV with f32 accumulation (``videogpa_tpu/ops/attention.py:40``)."""
    scale = _scale(q.shape[-1], softmax_scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if n_valid is not None and n_valid != k.shape[2]:
        s[..., n_valid:] = _NEG_INF
    lse = torch.logsumexp(s, dim=-1) if with_lse else None
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, lse


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain attention. q, k, v: (B, H, N, D). Softmax in f32."""
    return _reference(q, k, v, n_valid)[0]


def flash_attn_fwd_reference(q, k, v, layout: str = "bnhd", with_lse: bool = False,
                             softmax_scale: Optional[float] = None):
    """Plain version of the kernel: same function, same layouts.

    Returns (O in the operands' layout, LSE (B, H, Nq) f32 natural log or None).
    """
    if layout == "bnhd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o, lse = _reference(q, k, v, with_lse=with_lse, softmax_scale=softmax_scale)
    if layout == "bnhd":
        o = o.transpose(1, 2).contiguous()
    return o, lse


def _dims(x: torch.Tensor, layout: str) -> Tuple[int, int, int, int, int, int, int]:
    """(B, N, H, D) and element strides (b, n, h) of a 4-D operand."""
    (B, n1, n2, D), (sb, s1, s2, _) = x.shape, x.stride()
    if layout == "bnhd":
        return B, n1, n2, D, sb, s1, s2
    return B, n2, n1, D, sb, s2, s1


def _misses_16_bytes(x: torch.Tensor) -> bool:
    """Whether ``x`` breaks the rule of TMA and of 16-byte copies: a base
    address and (b, n, h) strides that are multiples of 16 bytes. A traced
    operand (``traced``) has no address: only its strides are checked."""
    misaligned = not traced(x) and x.data_ptr() % 16
    return bool(misaligned or any(st * x.element_size() % 16 for st in x.stride()[:-1]))


def check_16_bytes(fn: str, name: str, x: torch.Tensor) -> None:
    """Raises ``ValueError`` where ``x`` breaks the 16-byte rule
    (``_misses_16_bytes``). Only the wide bf16 entries copy such an operand
    instead (``_tma_ready``); the other kernels never do."""
    if _misses_16_bytes(x):
        raise ValueError(
            f"{fn}: {name} must be 16-byte aligned with (b, n, h) strides that are "
            f"multiples of 16 bytes, got strides {tuple(x.stride())} of {x.element_size()}-byte "
            "elements"
        )


def _check_operands(fn: str, layout: str, q, k, v, dtype=torch.bfloat16,
                    head_dims=KERNEL_HEAD_DIMS, **like_q) -> Tuple[int, int, int, int, int]:
    """Validate CUDA kernel operands; ``like_q`` are named tensors shaped
    like q. bf16 kernels copy 16-byte chunks, so their operands must be
    16-byte aligned. Every kernel's grid takes any B*H. Returns (B, Nq, H,
    D, Nk)."""
    B, Nq, H, D, _, _, _ = _dims(q, layout)
    Bk, Nk, Hk, Dk, _, _, _ = _dims(k, layout)
    device = q.get_device()
    for name, x in {"q": q, "k": k, "v": v, **like_q}.items():
        if x.get_device() != device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs a contiguous last dim")
        if dtype == torch.bfloat16:
            check_16_bytes(fn, name, x)
    if ((Bk, Hk, Dk) != (B, H, D) or v.shape != k.shape
            or any(x.shape != q.shape for x in like_q.values())):
        shapes = {n: tuple(x.shape) for n, x in {"q": q, "k": k, "v": v, **like_q}.items()}
        raise ValueError(f"{fn}: shapes {shapes} do not match")
    if D not in head_dims:
        raise NotImplementedError(f"{fn}: head_dim {D} not in {head_dims} for {dtype}")
    if min(Nq, Nk) < 1:
        raise ValueError(f"{fn}: unsupported sizes B*H={B * H}, Nq={Nq}, Nk={Nk}")
    return B, Nq, H, D, Nk


def _call(fn_name: str, entry: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``entry`` on ``device``'s current stream (the
    stream is its last argument); raises if the launch failed. The C entry
    works on the current device: the wrapper switches to ``device`` only when
    it is another. The stream is read as a raw handle, as PyTorch's own
    Triton launcher reads it: ``current_stream().cuda_stream`` builds a
    Stream object on every call, which a short kernel's launch feels."""
    fn = _kernels.kernel(entry)
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed with cudaError {rc}")


def _on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper takes the card's route for ``x``: a CUDA tensor,
    or a traced one on ``meta`` (``traced``)."""
    return x.is_cuda or (x.is_meta and traced(x))


def traced(x: torch.Tensor) -> bool:
    """Whether ``x`` is a FakeTensor (a tensor of ``FakeTensorMode``: a
    shape, a dtype and a device, no storage). The wrappers of K1, K3, K4, K6
    and K7 and of the f32 and wide entries take a traced operand on the
    card's route with the same checks, but of addresses, and the same
    allocations of outputs and scratch, and launch and count nothing:
    ``train.memory`` reckons a step's peak so. A traced tensor sits on "cuda"
    where PyTorch is built with CUDA; a CPU-only build has no CUDA device for
    autograd to record, so there it sits on "meta" in the card's stead. A
    real CUDA tensor launches its kernel or raises."""
    return isinstance(x, FakeTensor)


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


# Launch geometry of the forward and CUDA-core backward wrappers by their
# operands' geometry (entry, layout, scale, dtypes, devices, shapes,
# strides): operands whose geometry passed the checks once pass them again,
# so a hit skips the checks and the stride arithmetic and checks only the
# base addresses anew (TMA's and the 16-byte copies' rule). The geometry is
# kept as ctypes values of the C entry's argument types, which a call passes
# without converting them. The camera head's f32 attention is a few
# microseconds on the card, so its wrapper's host path is what a launch
# costs.
_GEOMETRY: dict = {}
_GEOMETRY_MAX = 256
_FWD_GEOMETRY_TYPES = _kernels._FWD_ARGS[5:-1]  # B, H, Nq, Nk, D, 12 strides, scale


def _geometry(fn_name: str, entry: str, layout: str, softmax_scale, dtype, names, tensors,
              build):
    """The cached launch geometry of ``entry`` for ``tensors``, made by
    ``build()`` (which runs the checks) on a miss. On a hit, bf16 operands
    named in ``names`` (the first ``len(names)`` tensors) are held to the
    16-byte rule again."""
    key = (entry, layout, softmax_scale,
           *[(x.dtype, x.get_device(), x.shape, x.stride()) for x in tensors])
    geo = _GEOMETRY.get(key)
    if geo is None:
        geo = build()
        if len(_GEOMETRY) >= _GEOMETRY_MAX:
            _GEOMETRY.clear()
        _GEOMETRY[key] = geo
    elif dtype == torch.bfloat16:
        for name, x in zip(names, tensors):
            check_16_bytes(fn_name, name, x)
    return geo


def _launch_fwd(fn_name: str, entry: str, q, k, v, layout, with_lse, dtype, head_dims,
                softmax_scale=None):
    """Shared launch of a forward kernel with ``flash_attn_fwd``'s C interface
    (K1, K6 bf16, K6 f32: flat or persistent grids, any B*H)."""

    def build():
        B, Nq, H, D, Nk = _check_operands(fn_name, layout, q, k, v, dtype=dtype,
                                          head_dims=head_dims)
        # O is contiguous in the layout: its (b, n, h) strides follow from the shape
        o_strides = (Nq * H * D, H * D, D) if layout == "bnhd" else (H * Nq * D, D, Nq * D)
        args = (B, H, Nq, Nk, D, *_dims(q, layout)[4:], *_dims(k, layout)[4:],
                *_dims(v, layout)[4:], *o_strides, _scale(D, softmax_scale) * _LOG2E)
        return (B, H, Nq), tuple(t(x) for t, x in zip(_FWD_GEOMETRY_TYPES, args))

    lse_shape, args = _geometry(fn_name, entry, layout, softmax_scale, dtype, "qkv", (q, k, v),
                                build)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = q.new_empty(lse_shape, dtype=torch.float32) if with_lse else None
    if not traced(q):
        _call(fn_name, entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              _ptr(lse), *args)
    return o, lse


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: str = "bnhd", with_lse: bool = False,
                   softmax_scale: Optional[float] = None):
    """softmax(Q K^T * scale) V, non-causal, Nq may differ from Nk; the scale
    is ``softmax_scale``, by default 1 / sqrt(D).

    Args:
        q: (B, Nq, H, D) for ``layout="bnhd"`` or (B, H, Nq, D) for "bhnd".
        k, v: the same layout with Nk keys. Any strides for (b, n, h) as long
            as the last dim is contiguous: no copy is made.
        with_lse: also return the natural-log logsumexp (B, H, Nq) f32.

    Returns:
        (O, LSE or None); O is a new contiguous tensor in ``layout``.

    CPU tensors take the plain version. CUDA tensors must be bf16 with
    D in {16, 32, 64} and meet TMA's 16-byte rule (``check_16_bytes``), at
    any B*H; anything else raises. Each kernel launch adds one to
    ``flash_attn_fwd.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_fwd_reference(q, k, v, layout, with_lse, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd", "flash_attn_fwd", q, k, v, layout, with_lse,
                      torch.bfloat16, KERNEL_HEAD_DIMS, softmax_scale)
    if not traced(q):
        flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0


def _bwd_reference(q, k, v, o, lse, do, softmax_scale=None):
    """(B, H, N, D) operands. The formulas of ``_flash_bwd_T``
    (``videogpa_tpu/ops/attention.py:1022``): P = exp(S - LSE), dV = P^T dO,
    dS = P * (dO V^T - delta) with delta = rowsum(O * dO), dQ = dS K * scale,
    dK = dS^T Q * scale (scale 1 / sqrt(D) by default). f32 arithmetic; P
    and dS are cast to the operands' dtype before their products, as the
    kernels round them."""
    scale = _scale(q.shape[-1], softmax_scale)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    delta = (o.float() * dof).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_reference(q, k, v, o, lse, do, layout: str = "bnhd",
                             softmax_scale: Optional[float] = None):
    """Plain version of the backward kernels: same function, same layouts.

    Returns (dQ, dK, dV), each contiguous in the operands' layout."""
    if layout == "bnhd":
        q, k, v, o, do = (x.transpose(1, 2) for x in (q, k, v, o, do))
    grads = _bwd_reference(q, k, v, o, lse, do, softmax_scale)
    if layout == "bnhd":
        return tuple(g.transpose(1, 2).contiguous() for g in grads)
    return grads


def _check_bwd_operands(fn_name: str, layout: str, head_dims, q, k, v, o, lse, do,
                        dtype=torch.bfloat16):
    """``_check_operands`` for a backward kernel, and its natural-log LSE.
    Returns (B, Nq, H, D, Nk)."""
    B, Nq, H, D, Nk = _check_operands(fn_name, layout, q, k, v, dtype=dtype,
                                      head_dims=head_dims, o=o, do=do)
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, Nq) or not lse.is_contiguous()):
        raise ValueError(f"{fn_name}: lse must be a contiguous ({B}, {H}, {Nq}) "
                         f"float32 tensor on {q.device}")
    return B, Nq, H, D, Nk


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd",
                   softmax_scale: Optional[float] = None):
    """Gradients (dQ, dK, dV) of ``flash_attn_fwd`` given its output O, its
    natural-log LSE (B, H, Nq) f32 and the output gradient dO, at the
    forward's ``softmax_scale`` (default 1 / sqrt(D)).

    q, o and do share q's layout and shape; k, v as in ``flash_attn_fwd``.
    The gradients are new contiguous tensors in ``layout``. CPU tensors take
    the plain version. CUDA tensors must be bf16 with D in {16, 32, 64} and
    meet TMA's 16-byte rule (``check_16_bytes``), at any B*H; anything else
    raises. The kernel computes delta = rowsum(O * dO) itself. dK and dV are
    deterministic; dQ is summed over key tiles by f32 reduce-adds in the
    order the CTAs reach them, so its last bits vary from run to run. Each
    launch (a prologue, the main kernel and an epilogue) adds one to
    ``flash_attn_bwd.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    grads = _launch_bwd("flash_attn_bwd", KERNEL_HEAD_DIMS, BWD_QUERIES,
                        q, k, v, o, lse, do, layout, softmax_scale)
    if not traced(q):
        flash_attn_bwd.launches += 1
    return grads


flash_attn_bwd.launches = 0


# short-row eligibility (``videogpa_tpu/ops/attention.py:611-621``): the
# TPU kernel keeps the whole key row of K and V in VMEM. The same limits pick
# K4 here, so the same calls reach the same kernel.
_SHORT_SEQ_MAX = 2048
_SHORT_KV_VMEM_MAX = 16 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def short_eligible(Nk: int, H: int, D: int, itemsize: int) -> bool:
    Nk_pad = _round_up(Nk, 128)
    return Nk_pad <= _SHORT_SEQ_MAX and 2 * Nk_pad * H * D * itemsize <= _SHORT_KV_VMEM_MAX


def flash_attn_short_reference(q, k, v, n_valid: Optional[int] = None,
                               softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K4. q (B, Nq, H, D), k/v (B, Nk, H, D); keys at index
    >= n_valid score -inf and their V rows count as zero (so NaN there cannot
    reach O), as ``_flash_short``'s overwrite mask. Returns a contiguous
    (B, Nq, H, D) tensor."""
    Nk = k.shape[1]
    if n_valid is not None and n_valid < Nk:
        v = v.clone()
        v[:, n_valid:] = 0
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o, _ = _reference(q, k, v, n_valid=n_valid, softmax_scale=softmax_scale)
    return o.transpose(1, 2).contiguous()


def flash_attn_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: Optional[int] = None,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Short-row attention in the (B, N, H, D) layout, inference only.

    softmax(Q K^T * scale) V over keys [0, n_valid) (default: all Nk), the
    scale ``softmax_scale``, by default 1 / sqrt(D).
    CPU tensors take the plain version. CUDA tensors must be bf16 with D in
    {16, 32, 64}, any (b, n, h) strides with a contiguous last dim that meet
    TMA's 16-byte rule (``check_16_bytes``), and ``short_eligible`` key rows,
    at any B*H; anything else raises. Each kernel launch adds one to
    ``flash_attn_short.launches``.
    """
    n_valid = k.shape[1] if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= k.shape[1]:
        raise ValueError(f"flash_attn_short: n_valid {n_valid} outside [1, {k.shape[1]}]")
    if q.is_cpu:
        return flash_attn_short_reference(q, k, v, n_valid, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_short: unsupported device {q.device}")
    o = _launch_short(q, k, v, n_valid, softmax_scale)
    if not traced(q):
        flash_attn_short.launches += 1
    return o


def _launch_short(q, k, v, n_valid: int, softmax_scale=None) -> torch.Tensor:
    """Validate K4's operands and launch it (a flat grid: any B*H)."""
    B, Nq, H, D, Nk = _check_operands("flash_attn_short", "bnhd", q, k, v)
    if not short_eligible(Nk, H, D, q.element_size()):
        raise ValueError(f"flash_attn_short: key row of {Nk} x {H} heads x {D} is not short")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if traced(q):
        return o
    strides = []
    for x in (q, k, v, o):
        strides += _dims(x, "bnhd")[4:]
    _call("flash_attn_short", "flash_attn_short", q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), o.data_ptr(), B, H, Nq, n_valid, D, *strides,
          _scale(D, softmax_scale) * _LOG2E)
    return o


flash_attn_short.launches = 0


def flash_attn_fwd_d128(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhd", with_lse: bool = False,
                        softmax_scale: Optional[float] = None):
    """K1's function at head_dim 128 in bf16 (a persistent wgmma + TMA
    kernel). Same arguments and results as ``flash_attn_fwd``.

    CPU tensors take the plain version (``flash_attn_fwd_reference``). CUDA
    tensors must be bf16 with D = 128 and meet TMA's 16-byte rule
    (``check_16_bytes``), at any B*H; anything else raises. Each launch adds
    one to ``flash_attn_fwd_d128.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_fwd_reference(q, k, v, layout, with_lse, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_fwd_d128: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd_d128", "flash_attn_fwd_d128_bf16", q, k, v, layout,
                      with_lse, torch.bfloat16, (128,), softmax_scale)
    if not traced(q):
        flash_attn_fwd_d128.launches += 1
    return out


flash_attn_fwd_d128.launches = 0


def flash_attn_bwd_d128(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd",
                        softmax_scale: Optional[float] = None):
    """K3's function at head_dim 128 in bf16: gradients (dQ, dK, dV) of
    ``flash_attn_fwd_d128`` given its output O, its natural-log LSE and dO.
    Same arguments and results as ``flash_attn_bwd``; Nq may differ from Nk.

    CPU tensors take the plain version (``flash_attn_bwd_reference``). CUDA
    tensors must be bf16 with D = 128 and meet TMA's 16-byte rule
    (``check_16_bytes``), at any B*H; anything else raises. The kernel
    computes delta = rowsum(O * dO) itself. dK and dV are deterministic; dQ
    is summed over key tiles by f32 reduce-adds in the order the CTAs reach
    them, so its last bits vary from run to run. Each launch (a prologue,
    the main kernel and an epilogue) adds one to
    ``flash_attn_bwd_d128.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_bwd_d128: unsupported device {q.device}")
    grads = _launch_bwd("flash_attn_bwd_d128", (128,), BWD_D128_QUERIES,
                        q, k, v, o, lse, do, layout, softmax_scale)
    if not traced(q):
        flash_attn_bwd_d128.launches += 1
    return grads


flash_attn_bwd_d128.launches = 0

# The wgmma backward kernels' tiles: a CTA per 128 keys walks the query
# tiles, 128 queries a tile in K3 (csrc/flash_attn_bwd.cu) and 64 in K7
# (csrc/flash_attn_bwd_d128.cu), one CTA an SM. Short key rows split the
# query range so that the grid holds at least two CTAs for each of the H100's
# 132 SMs.
BWD_KEYS, BWD_QUERIES, BWD_D128_QUERIES, H100_SMS = 128, 128, 64, 132
BWD_MIN_CTAS = 2 * H100_SMS


def bwd_splits(bh: int, nq: int, nk: int, q_tile: int) -> Tuple[int, int]:
    """(splits, query tiles per split) of a wgmma backward kernel's grid for
    B*H = ``bh`` heads and query tiles of ``q_tile``.

    One split when the (key tile, head) grid has ``BWD_MIN_CTAS`` CTAs;
    otherwise the split count, among those that reach that many CTAs (or
    give every query tile its own split), with the least modelled time:
    waves of 132 CTAs times the query tiles a CTA walks, plus two tiles'
    worth for loading K and V and storing the partials. Every split is
    non-empty and every query tile falls in exactly one."""
    n_qt = -(-nq // q_tile)
    ctas = -(-nk // BWD_KEYS) * bh
    if ctas >= BWD_MIN_CTAS:
        return 1, n_qt
    best = None
    for want in range(1, n_qt + 1):
        if ctas * want < BWD_MIN_CTAS and want < n_qt:
            continue
        per = -(-n_qt // want)
        splits = -(-n_qt // per)
        cost = -(-ctas * splits // H100_SMS) * (per + 2)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def bwd_d128_splits(bh: int, nq: int, nk: int) -> Tuple[int, int]:
    """K7's ``bwd_splits`` (64-query tiles)."""
    return bwd_splits(bh, nq, nk, BWD_D128_QUERIES)


def _launch_bwd(fn_name: str, head_dims, q_tile: int, q, k, v, o, lse, do, layout,
                softmax_scale=None):
    """K3's and K7's launch (one C interface): the kernel computes delta
    itself from O and dO, so O is an operand; the wrapper allocates the
    kernel's f32 scratch (base-2 LSE and delta padded to whole query tiles,
    the dQ accumulator, and dK / dV partials when the query range is split)."""
    B, Nq, H, D, Nk = _check_bwd_operands(fn_name, layout, head_dims, q, k, v, o, lse, do)
    splits, per = bwd_splits(B * H, Nq, Nk, q_tile)
    nq_pad = _round_up(Nq, q_tile)
    nk_pad = _round_up(Nk, BWD_KEYS)
    f32 = dict(dtype=torch.float32, device=q.device)
    lse2, delta = torch.empty((B * H, nq_pad), **f32), torch.empty((B * H, nq_pad), **f32)
    dq_acc = torch.empty((B * H, nq_pad, D), **f32)  # zeroed by the kernel's prologue
    parts = ((torch.empty((splits, B * H, nk_pad, D), **f32) for _ in range(2)) if splits > 1
             else (None, None))
    dk_part, dv_part = parts
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if traced(q):
        return dq, dk, dv
    strides = []
    for x in (q, k, v, o, do, dq, dk, dv):
        strides += _dims(x, layout)[4:]
    _call(fn_name, fn_name, q.device, *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)),
          lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), _ptr(dk_part), _ptr(dv_part),
          B, H, Nq, Nk, D, splits, per, *strides, _scale(D, softmax_scale))
    return dq, dk, dv


F32_HEAD_DIMS = HEAD_DIM_WIDTHS


def flash_attn_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       layout: str = "bnhd", with_lse: bool = False,
                       softmax_scale: Optional[float] = None):
    """K1's function on float32 operands at head_dim 16-128, kept in f32 end
    to end on CUDA cores (the VGGT camera head's trunk runs in f32 at head_dim
    128, and so does every attention of the f32 scorer). Same arguments and
    results as ``flash_attn_fwd``.

    A tiled kernel: one CTA a 64-query tile of a head stages Q once and walks
    64-key tiles of K and V through shared memory, so long rows run at a
    share of the f32 FMA rate; f32 rows stay far slower than bf16 rows on the
    tensor cores.

    CPU tensors take the plain version (``flash_attn_fwd_reference``). CUDA
    tensors must be float32 with D in ``F32_HEAD_DIMS``, at any B*H; anything
    else raises. Each launch adds one to ``flash_attn_fwd_f32.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_fwd_reference(q, k, v, layout, with_lse, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_fwd_f32: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd_f32", "flash_attn_fwd_f32", q, k, v, layout, with_lse,
                      torch.float32, F32_HEAD_DIMS, softmax_scale)
    if not traced(q):
        flash_attn_fwd_f32.launches += 1
    return out


flash_attn_fwd_f32.launches = 0


def flash_attn_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd",
                       softmax_scale: Optional[float] = None):
    """K3's function on float32 operands at head_dim 16-128: the gradients
    (dQ, dK, dV) of ``flash_attn_fwd_f32`` given its output O, its
    natural-log LSE (B, H, Nq) f32 and dO, kept in f32 end to end on the CUDA
    cores (no TF32), as the JAX package differentiates f32 attention through
    the same Pallas backward kernels. Same arguments and results as
    ``flash_attn_bwd``; Nq may differ from Nk.

    Two launches: a prologue writes delta = rowsum(O * dO); one kernel takes
    (64-key tile, b*h) items on a persistent grid, walks the query tiles
    (five products: S, dP, dV, dK and dQ's partial) and adds dQ's partials of
    a query tile in a fixed order of the key tiles. Every gradient element is
    summed in the same order on every run, so two runs give the same bits.
    While a head's key tiles fit the grid, they walk the query tiles
    diagonally, which can make a key tile wait on a later one: that grid is
    started by a cooperative launch, which runs it only with every CTA
    resident (else the in-order walk runs, as it does for longer rows); the
    header of ``csrc/flash_attn_bwd_f32.cu`` has the order. At head_dim 128
    the item is one CTA of two 64-column slots
    (``csrc/flash_attn_bwd_wide_f32.cu``, as ``flash_attn_bwd_wide`` runs
    f32).

    CPU tensors take the plain version (``flash_attn_bwd_reference``). CUDA
    tensors must be float32 with D in ``F32_HEAD_DIMS``, at any B*H; anything
    else raises. Each call adds one to ``flash_attn_bwd_f32.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_bwd_f32: unsupported device {q.device}")
    entry = "flash_attn_bwd_f32" if q.shape[-1] < 128 else "flash_attn_bwd_wide_f32"
    grads = _launch_bwd_f32("flash_attn_bwd_f32", entry, F32_HEAD_DIMS, torch.float32, q, k, v,
                            o, lse, do, layout, softmax_scale)
    if not traced(q):
        flash_attn_bwd_f32.launches += 1
    return grads


flash_attn_bwd_f32.launches = 0

# The CUDA-core backwards' tiles (csrc/flash_attn_bwd_f32.cu and
# csrc/flash_attn_bwd_wide_f32.cu, float32 only): 64 keys a work item, 64
# queries a tile, and above head_dim 64 one CTA of a cluster for each
# 64-column chunk of the gradients, each chunk with its own dQ turns.
BWD_F32_BLOCK, BWD_F32_SLICE = 64, 64
# The bf16 wide backward's tiles (csrc/flash_attn_bwd_wide.cu): 64 rows on
# both sides; its LSE2 and delta cover the query rows padded to whole tiles.
BWD_WIDE_BLOCK = 64


def bwd_f32_slices(D: int) -> int:
    """The 64-column chunks of the CUDA-core (float32) backward's gradients at
    head_dim ``D``, each with its own dQ turn counters (one above 64)."""
    return 1 if D <= BWD_F32_SLICE else D // BWD_F32_SLICE


def flash_attn_bwd_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd",
                        softmax_scale: Optional[float] = None):
    """The backward at any head_dim above 128 that is a multiple of 64, in
    float32 or bf16: the gradients of ``flash_attn_fwd_wide`` given its
    output O, its natural-log LSE and dO (``_dq_kernel`` / ``_dkv_kernel``,
    which the JAX package runs at every D >= 128). Same arguments and
    results as ``flash_attn_bwd``; two runs give the same bits.

    bf16 (``csrc/flash_attn_bwd_wide.cu``): the JAX package's split on wgmma
    + TMA, a prologue (delta, the base-2 LSE), a dK/dV kernel over 64-key
    tiles and a dQ kernel over 64-query tiles, each recomputing S and dP
    (seven products) and summing nothing across CTAs; slices of at most 256
    gradient columns, each recomputing S and dP. P is rounded to bf16 before dV and dS
    before dQ and dK, as the JAX kernels round them. float32
    (``csrc/flash_attn_bwd_wide_f32.cu``): the fused kernel of
    ``flash_attn_bwd_f32`` with one 128-thread slot for each 64-column chunk
    of D, two a CTA, the CTAs of a key tile in a thread block cluster that
    sums the slots' partial S and dP in a fixed order, so S and dP are
    computed once a (key tile, query tile) pair: five products, 10 N^2 D
    operations up to D = 1,024 (clusters of at most 8 CTAs; above, groups of
    chunks each recompute S and dP).

    CPU tensors take the plain version (``flash_attn_bwd_reference``). CUDA
    tensors must be float32 or bf16 with D in ``WIDE_HEAD_DIMS``, at any
    B*H; anything else raises. A bf16 operand that misses TMA's 16-byte rule
    (``check_16_bytes``) is copied first. Each call adds one to
    ``flash_attn_bwd_wide.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_bwd_wide: unsupported device {q.device}")
    if q.dtype == torch.bfloat16:
        grads = _launch_bwd_wide(*(_tma_ready(x) for x in (q, k, v, o)), lse, _tma_ready(do),
                                 layout, softmax_scale)
    elif q.dtype == torch.float32:
        grads = _launch_bwd_f32("flash_attn_bwd_wide", "flash_attn_bwd_wide_f32",
                                WIDE_HEAD_DIMS, q.dtype, q, k, v, o, lse, do, layout,
                                softmax_scale)
    else:
        raise TypeError(f"flash_attn_bwd_wide: q must be float32 or bfloat16, got {q.dtype}")
    if not traced(q):
        flash_attn_bwd_wide.launches += 1
    return grads


flash_attn_bwd_wide.launches = 0


_BWD_F32_TYPES = _kernels._BWD_F32_ARGS[12:-1]  # B, H, Nq, Nk, D, 24 strides, scale
_BWD_WIDE_TYPES = _kernels._BWD_WIDE_ARGS[10:-1]  # the same


def _contiguous_strides(shape, layout):
    """The (b, n, h) element strides of a new contiguous tensor of ``shape``."""
    _, n1, n2, D = shape
    strides = (n1 * n2 * D, n2 * D, D)
    return strides if layout == "bnhd" else (strides[0], strides[2], strides[1])


def _bwd_strides(layout, q, k, v, o, do):
    """The (b, n, h) strides of q, k, v, o and do, then of new contiguous dQ,
    dK and dV, as the backward C interfaces take them."""
    strides = []
    for x in (q, k, v, o, do):
        strides += _dims(x, layout)[4:]
    for x in (q, k, v):  # dq, dk, dv
        strides += _contiguous_strides(x.shape, layout)
    return strides


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a new contiguous copy of it where it misses TMA's 16-byte
    rule (``_misses_16_bytes``): the wide bf16 entries copy such an operand
    rather than refuse it."""
    return x.clone(memory_format=torch.contiguous_format) if _misses_16_bytes(x) else x


def _launch_bwd_wide(q, k, v, o, lse, do, layout, softmax_scale=None):
    """Validate the bf16 wide backward's operands and launch it (a prologue
    and two flat grids: any B*H). The wrapper allocates the gradients and one
    f32 scratch, the base-2 LSE and then delta over the query rows padded to
    whole 64-row tiles, both written by the prologue."""
    fn_name, entry = "flash_attn_bwd_wide", "flash_attn_bwd_wide_bf16"

    def build():
        B, Nq, H, D, Nk = _check_bwd_operands(fn_name, layout, WIDE_HEAD_DIMS, q, k, v, o, lse,
                                              do)
        args = (B, H, Nq, Nk, D, *_bwd_strides(layout, q, k, v, o, do),
                _scale(D, softmax_scale))
        n_scratch = 2 * B * H * _round_up(Nq, BWD_WIDE_BLOCK)
        return n_scratch, tuple(t(x) for t, x in zip(_BWD_WIDE_TYPES, args))

    n_scratch, args = _geometry(fn_name, entry, layout, softmax_scale, torch.bfloat16,
                                ("q", "k", "v", "o", "do"), (q, k, v, o, do, lse), build)
    scratch = lse.new_empty(n_scratch)  # f32, on q's device
    dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    if traced(q):
        return dq, dk, dv
    _call(fn_name, entry, q.device, *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)),
          scratch.data_ptr(), *args)
    return dq, dk, dv


def _launch_bwd_f32(fn_name: str, entry: str, head_dims, dtype, q, k, v, o, lse, do, layout,
                    softmax_scale=None):
    """Validate the CUDA-core backward's operands and launch it (a
    persistent grid: any B*H). The wrapper allocates the gradients and one
    f32 scratch: delta, the dQ partial sums (only when a query tile has more
    than one key tile) and the int32 turn counters with the work counter
    after them, which the prologue zeroes."""

    def build():
        B, Nq, H, D, Nk = _check_bwd_operands(fn_name, layout, head_dims, q, k, v, o, lse,
                                              do, dtype=dtype)
        n_qt, n_kt = -(-Nq // BWD_F32_BLOCK), -(-Nk // BWD_F32_BLOCK)
        n_delta = _round_up(B * H * Nq, 4)  # the partial sums start on 16 bytes
        n_acc = B * H * n_qt * BWD_F32_BLOCK * D if n_kt > 1 else 0
        n_turn = B * H * bwd_f32_slices(D) * n_qt + 1
        args = (B, H, Nq, Nk, D, *_bwd_strides(layout, q, k, v, o, do),
                _scale(D, softmax_scale))
        return (n_delta, n_acc, n_turn), tuple(t(x) for t, x in zip(_BWD_F32_TYPES, args))

    (n_delta, n_acc, n_turn), args = _geometry(fn_name, entry, layout, softmax_scale, dtype,
                                               ("q", "k", "v", "o", "do"),
                                               (q, k, v, o, do, lse), build)
    scratch = lse.new_empty(n_delta + n_acc + n_turn)  # f32, on q's device
    dq, dk, dv = q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)
    if traced(q):
        return dq, dk, dv
    base = scratch.data_ptr()
    _call(fn_name, entry, q.device,
          *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)), base,
          base + 4 * n_delta if n_acc else None, base + 4 * (n_delta + n_acc), *args)
    return dq, dk, dv


def flash_attn_fwd_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhd", with_lse: bool = False,
                        softmax_scale: Optional[float] = None):
    """K6's function at any head_dim above 128 that is a multiple of 64, in
    float32 or bf16 (``_fwd_kernel``, which the JAX package runs at every D >=
    128). Same arguments and results as ``flash_attn_fwd``.

    O is cut into slices of at most 256 columns (one slice at D <= 256),
    each computing S once for every key tile. bf16
    (``csrc/flash_attn_fwd_wide_bf16.cu``): K6's scheme on wgmma + TMA, a
    persistent grid of 128-query items, Q kept in shared memory at D <= 256,
    64-key tiles, P rounded to bf16 before P V as the JAX kernel rounds it.
    float32 (``csrc/flash_attn_fwd_wide.cu``): a tiled kernel on the CUDA
    cores, one CTA per (64-query tile, slice, b*h) streaming 64-column
    chunks of Q and K for S and of V for P V.

    CPU tensors take the plain version (``flash_attn_fwd_reference``). CUDA
    tensors must be float32 or bf16 with D in ``WIDE_HEAD_DIMS``, at any
    B*H; anything else raises. A bf16 operand that misses TMA's 16-byte rule
    (``check_16_bytes``) is copied first. Each launch adds one to
    ``flash_attn_fwd_wide.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.is_cpu:
        return flash_attn_fwd_reference(q, k, v, layout, with_lse, softmax_scale)
    if not _on_card(q):
        raise ValueError(f"flash_attn_fwd_wide: unsupported device {q.device}")
    if q.dtype == torch.bfloat16:
        entry = "flash_attn_fwd_wide_bf16"
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    elif q.dtype == torch.float32:
        entry = "flash_attn_fwd_wide_f32"
    else:
        raise TypeError(f"flash_attn_fwd_wide: q must be float32 or bfloat16, got {q.dtype}")
    out = _launch_fwd("flash_attn_fwd_wide", entry, q, k, v, layout, with_lse, q.dtype,
                      WIDE_HEAD_DIMS, softmax_scale)
    if not traced(q):
        flash_attn_fwd_wide.launches += 1
    return out


flash_attn_fwd_wide.launches = 0


# ---------------------------------------------------------------------------
# int8-QK forward (SageAttention-style, inference only)
# ---------------------------------------------------------------------------
#
# K is centred on its mean over the keys (exact: a constant added to every
# score of a query row leaves its softmax unchanged), q is prescaled by
# log2(e) / sqrt(D), and both are quantised to int8 with one f32 scale per
# row. S = int32(q8 k8^T) * sq * sk is then in the base-2 log domain; the
# softmax stays f32 and PV takes P in V's dtype with f32 accumulation.

def _seq_dim(layout: str) -> int:
    return 1 if layout == "bnhd" else 2


def quantize_qk_int8(q: torch.Tensor, k: torch.Tensor, layout: str = "bhnd",
                     softmax_scale: Optional[float] = None):
    """The transform of ``_quantize_qk_int8``
    (``videogpa_tpu/ops/attention.py:685``) on 4-D operands in ``layout``;
    q is prescaled by log2(e) * ``softmax_scale`` (default 1 / sqrt(D)).

    Returns (q8, sq, k8, sk): new int8 tensors shaped like q and k (dense,
    in the memory order of the f32 images of q and k) and their f32 scales
    shaped like them without the last dim. All arithmetic is f32 on the
    operands as they are. The port never pads, so K's mean is over all of
    its keys.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    seq = _seq_dim(layout)
    D = q.shape[-1]
    kf = k.float()
    # divisors as 0-d tensors on the device: true IEEE divisions there, as on
    # the CPU (with a Python scalar the CUDA kernel multiplies by a reciprocal)
    n_keys, i127 = kf.new_full((), float(k.shape[seq])), kf.new_full((), 127.0)
    kc = kf - kf.sum(dim=seq, keepdim=True) / n_keys
    sk = kc.abs().amax(dim=-1, keepdim=True) / i127 + 1e-12
    k8 = torch.round(kc.div_(sk)).to(torch.int8)
    qf = q.float() * (_scale(D, softmax_scale) * _LOG2E)
    sq = qf.abs().amax(dim=-1, keepdim=True) / i127 + 1e-12
    q8 = torch.round(qf.div_(sq)).to(torch.int8)
    return q8, sq.squeeze(-1), k8, sk.squeeze(-1)


def _int8_scores(q8, sq, k8, sk) -> torch.Tensor:
    """S = int32(q8 k8^T) * sq * sk on (B, H, N, D) operands, (B, H, Nq, Nk)
    f32: an f32 product of int8 operands holds every term (< 2^14) and every
    partial sum (< 2^24 up to head_dim 1,040) as an integer, so the integer
    scores are exact; then the row scale, then the key scale."""
    if q8.shape[-1] * 127 * 127 >= 2 ** 24:
        raise ValueError("flash_attn_int8_reference: head_dim too large for exact f32 sums")
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
    return s.mul_(sq[..., :, None]).mul_(sk[..., None, :])  # in place: (Nq, Nk) f32 per head


def flash_attn_int8_reference(q8, sq, k8, sk, v, layout: str = "bnhd") -> torch.Tensor:
    """Plain version of K8 and K9: the same function, the same layouts.

    The integer scores are exact (``_int8_scores``). Then S = s * sq[row] *
    sk[col], exp2 against the row max, P cast to V's dtype, PV in f32,
    divided by the f32 row sum. Returns O in ``layout``, contiguous, in V's
    dtype."""
    if layout == "bnhd":
        q8, k8, v = (x.transpose(1, 2) for x in (q8, k8, v))
        sq, sk = sq.transpose(1, 2), sk.transpose(1, 2)
    s = _int8_scores(q8, sq, k8, sk)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp2_()
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(v.dtype)
    if layout == "bnhd":
        o = o.transpose(1, 2)
    return o.contiguous()


def _int8_forward(fn_name: str, head_dims, q8, sq, k8, sk, v, layout,
                  v_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8-QK wrappers: the plain version for CPU tensors, the entry
    point ``fn_name`` for CUDA tensors."""
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q8.is_cpu:
        return flash_attn_int8_reference(q8, sq, k8, sk, v, layout)
    if not _on_card(q8):
        raise ValueError(f"{fn_name}: unsupported device {q8.device}")
    return _launch_int8(fn_name, head_dims, q8, sq, k8, sk, v, layout, v_dtype)


def _launch_int8(fn_name: str, head_dims, q8, sq, k8, sk, v, layout,
                 v_dtype=torch.bfloat16) -> torch.Tensor:
    """Validate the int8-QK operands and launch the entry point ``fn_name``
    (K8, K9 and the f32-V entry share one C interface), at any B*H. A bf16 V
    meets TMA's rule; an f32 V is copied by 16 or 4 bytes as it is aligned."""
    B, Nq, H, D, _, _, _ = _dims(q8, layout)
    Bk, Nk, Hk, Dk, _, _, _ = _dims(k8, layout)
    for name, x, dtype in (("q8", q8, torch.int8), ("k8", k8, torch.int8),
                           ("sq", sq, torch.float32), ("sk", sk, torch.float32),
                           ("v", v, v_dtype)):
        if x.device != q8.device:
            raise ValueError(f"{fn_name}: {name} on {x.device}, q8 on {q8.device}")
        if x.dtype != dtype:
            raise TypeError(f"{fn_name}: {name} must be {dtype}, got {x.dtype}")
    # TMA's rule for q8, k8 and a bf16 v (``check_16_bytes``)
    for name, x in (("q8", q8), ("k8", k8), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{fn_name}: {name} needs a contiguous last dim")
        if x is not v or v_dtype == torch.bfloat16:
            check_16_bytes(fn_name, name, x)
    if ((Bk, Hk, Dk) != (B, H, D) or v.shape != k8.shape or sq.shape != q8.shape[:-1]
            or sk.shape != k8.shape[:-1]):
        shapes = {n: tuple(x.shape) for n, x in
                  (("q8", q8), ("sq", sq), ("k8", k8), ("sk", sk), ("v", v))}
        raise ValueError(f"{fn_name}: shapes {shapes} do not match")
    if D not in head_dims:
        raise NotImplementedError(f"{fn_name}: head_dim {D} not in {head_dims}")
    if min(Nq, Nk) < 1:
        raise ValueError(f"{fn_name}: unsupported sizes B*H={B * H}, Nq={Nq}, Nk={Nk}")
    o = torch.empty(q8.shape, dtype=v.dtype, device=v.device)
    strides = []
    for x in (q8, sq.unsqueeze(-1), k8, sk.unsqueeze(-1), v, o):
        strides += _dims(x, layout)[4:]
    _call(fn_name, fn_name, q8.device, q8.data_ptr(), sq.data_ptr(), k8.data_ptr(),
          sk.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Nq, Nk, D, *strides)
    return o


def flash_attn_int8(q8: torch.Tensor, sq: torch.Tensor, k8: torch.Tensor, sk: torch.Tensor,
                    v: torch.Tensor, layout: str = "bnhd") -> torch.Tensor:
    """K8: softmax2(int32(q8 k8^T) * sq * sk) V at head_dim < 128, inference
    only, on the operands of :func:`quantize_qk_int8`.

    Args:
        q8, k8: int8, (B, N, H, D) for ``layout="bnhd"`` or (B, H, N, D) for
            "bhnd"; Nq may differ from Nk.
        sq, sk: their f32 scales, shaped like them without the last dim.
            The kernel needs every sq > 0 (it takes the row max of the
            scores before the row scale), as ``quantize_qk_int8`` makes
            them; the plain version takes any sq.
        v: shaped like k8. Any (b, n, h) strides as long as the last dim is
            contiguous: no copy is made.

    Returns:
        O, a new contiguous tensor shaped like q8, in V's dtype.

    CPU tensors take the plain version. CUDA tensors must have V in bf16,
    D in {16, 32, 64} and q8, k8, v that meet TMA's 16-byte rule
    (``check_16_bytes``), at any B*H; anything else raises. A CUDA sq <= 0
    is not checked (that would cost a sync) and gives undefined rows. Each kernel
    launch adds one to ``flash_attn_int8.launches``.
    """
    o = _int8_forward("flash_attn_int8", KERNEL_HEAD_DIMS, q8, sq, k8, sk, v, layout)
    if not q8.is_cpu:
        flash_attn_int8.launches += 1
    return o


flash_attn_int8.launches = 0


def flash_attn_int8_d128(q8: torch.Tensor, sq: torch.Tensor, k8: torch.Tensor,
                         sk: torch.Tensor, v: torch.Tensor,
                         layout: str = "bnhd") -> torch.Tensor:
    """K9: :func:`flash_attn_int8` at head_dim 128 (the same kernel body).
    ``impl="flash_int8"`` at head_dim 128 takes the exact kernel, as in the
    JAX package; ``attention`` runs this one only for a head_dim of 65-127,
    zero-padded to 128 (the JAX package's int8 route at D < 128).

    CPU tensors take the plain version. CUDA tensors must have V in bf16,
    D = 128, every sq > 0 (as for K8) and q8, k8, v that meet TMA's 16-byte
    rule, at any B*H; anything else raises or, for sq <= 0, is undefined. Each kernel launch adds one to
    ``flash_attn_int8_d128.launches``.
    """
    o = _int8_forward("flash_attn_int8_d128", (128,), q8, sq, k8, sk, v, layout)
    if not q8.is_cpu:
        flash_attn_int8_d128.launches += 1
    return o


flash_attn_int8_d128.launches = 0


def flash_attn_int8_f32(q8: torch.Tensor, sq: torch.Tensor, k8: torch.Tensor,
                        sk: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhd") -> torch.Tensor:
    """K8's function with a float32 V (``_fwd_kernel_T8`` on f32 operands,
    which casts P to V's dtype): softmax2(int32(q8 k8^T) * sq * sk) V with P
    and P V in f32, at head_dim 16, 32, 64 or 128 (``attention`` pads 65-127
    to 128) (``csrc/flash_attn_int8_f32.cu``): the integer scores on int8
    wgmma (exact), an exact base-2 online softmax, P V in f32 on the CUDA
    cores (8 queries x D / 8 or D / 16 columns of O a thread), a persistent
    grid. Returns O in f32, a new contiguous tensor shaped like q8. Takes any
    sq.

    CPU tensors take the plain version. CUDA tensors must have V in float32
    and q8, k8 that meet TMA's 16-byte rule (``check_16_bytes``), at any B*H;
    anything else raises. Each kernel launch adds one to
    ``flash_attn_int8_f32.launches``.
    """
    o = _int8_forward("flash_attn_int8_f32", HEAD_DIM_WIDTHS, q8, sq, k8, sk, v, layout,
                      torch.float32)
    if not q8.is_cpu:
        flash_attn_int8_f32.launches += 1
    return o


flash_attn_int8_f32.launches = 0


def _card_f32(x) -> bool:
    """A float32 operand off the CPU: the card routes it to the f32 entries
    (on the CPU every wrapper takes its plain version, so there the route is
    picked by head_dim alone)."""
    return x.dtype == torch.float32 and not x.is_cpu


class _FlashAttention(torch.autograd.Function):
    """A forward kernel with LSE and its backward kernel: ``flash_attn_fwd``
    and ``flash_attn_bwd`` at head_dim < 128, ``flash_attn_fwd_d128`` and
    ``flash_attn_bwd_d128`` at head_dim 128, as ``_flash_fwd`` and
    ``_flash_bwd`` split in the JAX package; ``flash_attn_fwd_f32`` and
    ``flash_attn_bwd_f32`` for float32 operands up to 128, as the JAX
    ``_flash`` differentiates f32 through the same kernels;
    ``flash_attn_fwd_wide`` and ``flash_attn_bwd_wide`` above 128 in either
    dtype. The counterpart of the JAX ``_flash`` and ``_attention_bnhd_vjp``
    custom vjps."""

    @staticmethod
    def _pair(q):
        if q.shape[-1] > 128:
            return flash_attn_fwd_wide, flash_attn_bwd_wide
        if _card_f32(q):
            return flash_attn_fwd_f32, flash_attn_bwd_f32
        if q.shape[-1] >= 128:
            return flash_attn_fwd_d128, flash_attn_bwd_d128
        return flash_attn_fwd, flash_attn_bwd

    @staticmethod
    def forward(ctx, q, k, v, layout, softmax_scale):
        fwd = _FlashAttention._pair(q)[0]
        o, lse = fwd(q, k, v, layout=layout, with_lse=True, softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout, ctx.softmax_scale = layout, softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _FlashAttention._pair(q)[1]
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), layout=ctx.layout,
                         softmax_scale=ctx.softmax_scale)
        return dq, dk, dv, None, None


def _pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x zero-padded along its last dim to ``width``: a new contiguous tensor
    (so it meets ``check_16_bytes``); autograd slices the gradient back."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", layout: str = "bhnd") -> torch.Tensor:
    """Bidirectional multi-head attention (``videogpa_tpu/ops/attention.py:1342``).

    Args:
        q, k, v: (B, H, N, D), or (B, N, H, D) with ``layout="bnhd"`` (the
            projection-natural layout the models feed). k/v may be longer or
            shorter than q.
        impl: "auto" or "flash" -> the exact kernels on CUDA, their plain
            versions on CPU. "flash_int8" -> the int8-QK forward where it
            applies (below), inference only. "ring" -> sequence parallelism
            over the ambient mesh's ``seq`` axis
            (``ops.ring_attention.ring_attention_sharded``: each pair of
            shards through the kernels of the grad route below); raises
            ``ValueError`` without a mesh (``parallel.set_mesh``) that has
            that axis.

    On CUDA a head_dim D that no kernel takes (any D <= 128 outside 16, 32,
    64, 128, any D > 128 that is no multiple of 64) is zero-padded to
    ``padded_head_dim(D)``; the kernels get the softmax scale of D and O is
    sliced back to D columns (under grad the slice and the pad carry the
    gradients back). The routing below reads the padded D; the CPU takes any
    D unpadded.

    Routing, as ``attention(impl="flash")`` in the JAX package for bf16:

    - an operand requires grad (and grad is enabled) -> ``_FlashAttention``:
      D > 128 in either dtype, ``flash_attn_fwd_wide`` with LSE and
      ``flash_attn_bwd_wide``; float32, K6's f32 entry with LSE and the f32
      backward (``flash_attn_bwd_f32``); D < 128, K1 with LSE and K3
      backward; D = 128, K6 (``flash_attn_fwd_d128``) with LSE and K7
      (``flash_attn_bwd_d128``);
    - D > 128 -> ``flash_attn_fwd_wide`` (bf16 on the tensor cores, float32
      on the CUDA cores);
    - float32 operands -> ``flash_attn_fwd_f32`` (K6's f32 entry, tiled on
      the CUDA cores), at any length: the camera head's short rows and the
      f32 scorer's long ones, which run far slower than bf16 rows on the
      tensor cores;
    - D = 128 -> ``flash_attn_fwd_d128`` (K6);
    - bnhd rows that are ``short_eligible`` -> ``flash_attn_short`` (K4);
    - otherwise -> ``flash_attn_fwd`` (K1).

    ``impl="flash_int8"`` (``videogpa_tpu/ops/attention.py:1378-1401,
    1437-1448``) raises if an operand requires grad (the int8 forward has no
    backward), and otherwise differs from the above in one case only: an
    original D < 128 on rows that are not short bnhd rows goes through
    ``quantize_qk_int8`` and ``flash_attn_int8`` (K8), or, where D pads to
    128 (65-127), the same kernel body at width 128 (``flash_attn_int8_d128``,
    K9's entry); on CUDA float32 operands go to ``flash_attn_int8_f32``
    (f32 V, P and PV, at width 16-128). Short bnhd rows and D >= 128 take the
    exact kernels above.

    Returns:
        Output in the operands' layout, dtype of q.
    """
    if impl not in ("auto", "flash", "flash_int8", "ring"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if impl == "ring":
        from videogpa_torch.parallel.mesh import SEQ_AXIS, get_mesh

        mesh = get_mesh()
        if mesh is None or SEQ_AXIS not in (mesh.mesh_dim_names or ()):
            raise ValueError("attention(impl='ring') needs an ambient mesh with a 'seq' axis: "
                             "wrap the call in parallel.set_mesh(make_mesh(...))")
    if q.is_cpu:
        return _attention(q, k, v, impl, layout, q.shape[-1])
    return _attention_padded(q, k, v, impl, layout)


def _attention_padded(q, k, v, impl: str, layout: str) -> torch.Tensor:
    """``attention`` on the card's route: head_dim D zero-padded to
    ``padded_head_dim(D)`` where it is no kernel width, O sliced back."""
    D = q.shape[-1]
    width = padded_head_dim(D)
    if width == D:
        return _attention(q, k, v, impl, layout, D)
    qp, kp, vp = (_pad_head_dim(x, width) for x in (q, k, v))
    return _attention(qp, kp, vp, impl, layout, D)[..., :D]


def _attention(q, k, v, impl: str, layout: str, D: int) -> torch.Tensor:
    """``attention`` on operands of a width some kernel takes (on CUDA), for
    the original head_dim ``D`` (the softmax scale is D's)."""
    scale = None if q.shape[-1] == D else D ** -0.5
    if impl == "ring":
        from videogpa_torch.ops.ring_attention import ring_attention_sharded
        from videogpa_torch.parallel.mesh import get_mesh

        return ring_attention_sharded(q, k, v, get_mesh(), layout=layout, softmax_scale=scale)
    Dk = q.shape[-1]
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    short = layout == "bnhd" and short_eligible(k.shape[1], q.shape[2], Dk, q.element_size())
    if impl == "flash_int8":
        if needs_grad:
            raise RuntimeError("attention(impl='flash_int8') is inference only: it has no "
                               "backward; use impl='flash' under grad")
        if D < 128 and not short:
            if not q.is_cpu and q.dtype not in (torch.bfloat16, torch.float32):
                raise NotImplementedError(
                    f"attention(impl='flash_int8') on CUDA takes bf16 or float32 operands, "
                    f"got {q.dtype}")
            q8, sq, k8, sk = quantize_qk_int8(q, k, layout, softmax_scale=scale)
            if _card_f32(q):
                int8 = flash_attn_int8_f32
            else:
                int8 = flash_attn_int8_d128 if Dk == 128 else flash_attn_int8
            return int8(q8, sq, k8, sk, v, layout).to(q.dtype)
    if needs_grad:
        return _FlashAttention.apply(q, k, v, layout, scale)
    if Dk > 128:
        return flash_attn_fwd_wide(q, k, v, layout=layout, softmax_scale=scale)[0]
    if q.dtype == torch.float32:
        return flash_attn_fwd_f32(q, k, v, layout=layout, softmax_scale=scale)[0]
    if Dk == 128:
        return flash_attn_fwd_d128(q, k, v, layout=layout, softmax_scale=scale)[0]
    if short:
        return flash_attn_short(q, k, v, softmax_scale=scale)
    return flash_attn_fwd(q, k, v, layout=layout, softmax_scale=scale)[0]
