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
- ``flash_attn_int8`` (K8) and ``flash_attn_int8_d128`` (K9), both in
  ``csrc/flash_attn_int8.cu``: the int8-QK forward on operands quantised by
  ``quantize_qk_int8``, inference only, at head_dim < 128 and at 128; QK^T
  on int8 wgmma, PV on bf16 wgmma, TMA, a persistent grid.

``attention`` routes as the JAX package does for bf16, and sends float32
operands to ``flash_attn_fwd_f32``, since the tensor-core kernels take bf16
and rounding f32 operands would move the f32 heads away from the JAX
package's.
It differentiates with a ``torch.autograd.Function`` whenever an operand
requires grad: through K1 and K3 at head_dim < 128, through K6 and K7 at
head_dim 128.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videogpa_torch.ops import _kernels

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (16, 32, 64)


def _reference(q, k, v, n_valid=None, with_lse=False):
    """(B, H, N, D) operands; f32 scores and softmax, P cast to V's dtype
    before PV with f32 accumulation (``videogpa_tpu/ops/attention.py:40``)."""
    scale = q.shape[-1] ** -0.5
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


def flash_attn_fwd_reference(q, k, v, layout: str = "bnhd", with_lse: bool = False):
    """Plain version of the kernel: same function, same layouts.

    Returns (O in the operands' layout, LSE (B, H, Nq) f32 natural log or None).
    """
    if layout == "bnhd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o, lse = _reference(q, k, v, with_lse=with_lse)
    if layout == "bnhd":
        o = o.transpose(1, 2).contiguous()
    return o, lse


def _dims(x: torch.Tensor, layout: str) -> Tuple[int, int, int, int, int, int, int]:
    """(B, N, H, D) and element strides (b, n, h) of a 4-D operand."""
    (B, n1, n2, D), (sb, s1, s2, _) = x.shape, x.stride()
    if layout == "bnhd":
        return B, n1, n2, D, sb, s1, s2
    return B, n2, n1, D, sb, s2, s1


def check_16_bytes(fn: str, name: str, x: torch.Tensor) -> None:
    """The rule of TMA and of 16-byte copies: a base address and (b, n, h)
    strides that are multiples of 16 bytes. Raises ``ValueError`` otherwise;
    the kernels never copy an operand to meet it."""
    if x.data_ptr() % 16 or any(st * x.element_size() % 16 for st in x.stride()[:-1]):
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


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


# Launch geometry of the forward wrappers by their operands' geometry (entry,
# layout, dtypes, devices, shapes, strides): operands whose geometry passed
# ``_check_operands`` once pass it again, so a hit skips the checks and the
# stride arithmetic and checks only the base addresses anew (TMA's 16-byte
# rule). The geometry is kept as ctypes values of the C entry's argument
# types, which a call passes without converting them. The camera head's f32
# attention is a few microseconds on the card, so its wrapper's host path is
# what a launch costs.
_FWD_GEOMETRY: dict = {}
_FWD_GEOMETRY_MAX = 256
_FWD_GEOMETRY_TYPES = _kernels._FWD_ARGS[5:-1]  # B, H, Nq, Nk, D, 12 strides, scale


def _launch_fwd(fn_name: str, entry: str, q, k, v, layout, with_lse, dtype, head_dims):
    """Shared launch of a forward kernel with ``flash_attn_fwd``'s C interface
    (K1, K6 bf16, K6 f32: flat or persistent grids, any B*H)."""
    key = (entry, layout, q.dtype, k.dtype, v.dtype, q.get_device(), k.get_device(),
           v.get_device(), q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride())
    geo = _FWD_GEOMETRY.get(key)
    if geo is None:
        B, Nq, H, D, Nk = _check_operands(fn_name, layout, q, k, v, dtype=dtype,
                                          head_dims=head_dims)
        # O is contiguous in the layout: its (b, n, h) strides follow from the shape
        o_strides = (Nq * H * D, H * D, D) if layout == "bnhd" else (H * Nq * D, D, Nq * D)
        args = (B, H, Nq, Nk, D, *_dims(q, layout)[4:], *_dims(k, layout)[4:],
                *_dims(v, layout)[4:], *o_strides, D ** -0.5 * _LOG2E)
        geo = ((B, H, Nq), tuple(t(x) for t, x in zip(_FWD_GEOMETRY_TYPES, args)))
        if len(_FWD_GEOMETRY) >= _FWD_GEOMETRY_MAX:
            _FWD_GEOMETRY.clear()
        _FWD_GEOMETRY[key] = geo
    elif dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            check_16_bytes(fn_name, name, x)
    lse_shape, args = geo
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = q.new_empty(lse_shape, dtype=torch.float32) if with_lse else None
    _call(fn_name, entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          _ptr(lse), *args)
    return o, lse


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: str = "bnhd", with_lse: bool = False):
    """softmax(Q K^T / sqrt(D)) V, non-causal, Nq may differ from Nk.

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
        return flash_attn_fwd_reference(q, k, v, layout, with_lse)
    if not q.is_cuda:
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd", "flash_attn_fwd", q, k, v, layout, with_lse,
                      torch.bfloat16, KERNEL_HEAD_DIMS)
    flash_attn_fwd.launches += 1
    return out


flash_attn_fwd.launches = 0


def _bwd_reference(q, k, v, o, lse, do):
    """(B, H, N, D) operands. The formulas of ``_flash_bwd_T``
    (``videogpa_tpu/ops/attention.py:1022``): P = exp(S - LSE), dV = P^T dO,
    dS = P * (dO V^T - delta) with delta = rowsum(O * dO), dQ = dS K / sqrt(D),
    dK = dS^T Q / sqrt(D). f32 arithmetic; P and dS are cast to the
    operands' dtype before their products, as the kernels round them."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    delta = (o.float() * dof).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attn_bwd_reference(q, k, v, o, lse, do, layout: str = "bnhd"):
    """Plain version of the backward kernel: same function, same layouts.

    Returns (dQ, dK, dV), each contiguous in the operands' layout."""
    if layout == "bnhd":
        q, k, v, o, do = (x.transpose(1, 2) for x in (q, k, v, o, do))
    grads = _bwd_reference(q, k, v, o, lse, do)
    if layout == "bnhd":
        return tuple(g.transpose(1, 2).contiguous() for g in grads)
    return grads


def _check_bwd_operands(fn_name: str, layout: str, head_dims, q, k, v, o, lse, do):
    """``_check_operands`` for a backward kernel, and its natural-log LSE.
    Returns (B, Nq, H, D, Nk)."""
    B, Nq, H, D, Nk = _check_operands(fn_name, layout, q, k, v, head_dims=head_dims,
                                      o=o, do=do)
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, Nq) or not lse.is_contiguous()):
        raise ValueError(f"{fn_name}: lse must be a contiguous ({B}, {H}, {Nq}) "
                         f"float32 tensor on {q.device}")
    return B, Nq, H, D, Nk


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd"):
    """Gradients (dQ, dK, dV) of ``flash_attn_fwd`` given its output O, its
    natural-log LSE (B, H, Nq) f32 and the output gradient dO.

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
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")
    grads = _launch_bwd("flash_attn_bwd", KERNEL_HEAD_DIMS, BWD_QUERIES,
                        q, k, v, o, lse, do, layout)
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


def flash_attn_short_reference(q, k, v, n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain version of K4. q (B, Nq, H, D), k/v (B, Nk, H, D); keys at index
    >= n_valid score -inf and their V rows count as zero (so NaN there cannot
    reach O), as ``_flash_short``'s overwrite mask. Returns a contiguous
    (B, Nq, H, D) tensor."""
    Nk = k.shape[1]
    if n_valid is not None and n_valid < Nk:
        v = v.clone()
        v[:, n_valid:] = 0
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    o, _ = _reference(q, k, v, n_valid=n_valid)
    return o.transpose(1, 2).contiguous()


def flash_attn_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: Optional[int] = None) -> torch.Tensor:
    """Short-row attention in the (B, N, H, D) layout, inference only.

    softmax(Q K^T / sqrt(D)) V over keys [0, n_valid) (default: all Nk).
    CPU tensors take the plain version. CUDA tensors must be bf16 with D in
    {16, 32, 64}, any (b, n, h) strides with a contiguous last dim that meet
    TMA's 16-byte rule (``check_16_bytes``), and ``short_eligible`` key rows,
    at any B*H; anything else raises. Each kernel launch adds one to
    ``flash_attn_short.launches``.
    """
    n_valid = k.shape[1] if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= k.shape[1]:
        raise ValueError(f"flash_attn_short: n_valid {n_valid} outside [1, {k.shape[1]}]")
    if q.device.type == "cpu":
        return flash_attn_short_reference(q, k, v, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_short: unsupported device {q.device}")
    o = _launch_short(q, k, v, n_valid)
    flash_attn_short.launches += 1
    return o


def _launch_short(q, k, v, n_valid: int) -> torch.Tensor:
    """Validate K4's operands and launch it (a flat grid: any B*H)."""
    B, Nq, H, D, Nk = _check_operands("flash_attn_short", "bnhd", q, k, v)
    if not short_eligible(Nk, H, D, q.element_size()):
        raise ValueError(f"flash_attn_short: key row of {Nk} x {H} heads x {D} is not short")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = []
    for x in (q, k, v, o):
        strides += _dims(x, "bnhd")[4:]
    _call("flash_attn_short", "flash_attn_short", q.device, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), o.data_ptr(), B, H, Nq, n_valid, D, *strides, D ** -0.5 * _LOG2E)
    return o


flash_attn_short.launches = 0


def flash_attn_fwd_d128(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "bnhd", with_lse: bool = False):
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
        return flash_attn_fwd_reference(q, k, v, layout, with_lse)
    if not q.is_cuda:
        raise ValueError(f"flash_attn_fwd_d128: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd_d128", "flash_attn_fwd_d128_bf16", q, k, v, layout,
                      with_lse, torch.bfloat16, (128,))
    flash_attn_fwd_d128.launches += 1
    return out


flash_attn_fwd_d128.launches = 0


def flash_attn_bwd_d128(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd"):
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
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd_d128: unsupported device {q.device}")
    grads = _launch_bwd("flash_attn_bwd_d128", (128,), BWD_D128_QUERIES,
                        q, k, v, o, lse, do, layout)
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


def _launch_bwd(fn_name: str, head_dims, q_tile: int, q, k, v, o, lse, do, layout):
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
    strides = []
    for x in (q, k, v, o, do, dq, dk, dv):
        strides += _dims(x, layout)[4:]
    _call(fn_name, fn_name, q.device, *(x.data_ptr() for x in (q, k, v, o, do, lse, dq, dk, dv)),
          lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), _ptr(dk_part), _ptr(dv_part),
          B, H, Nq, Nk, D, splits, per, *strides, D ** -0.5)
    return dq, dk, dv


F32_HEAD_DIMS = (16, 32, 64, 128)


def flash_attn_fwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       layout: str = "bnhd", with_lse: bool = False):
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
        return flash_attn_fwd_reference(q, k, v, layout, with_lse)
    if not q.is_cuda:
        raise ValueError(f"flash_attn_fwd_f32: unsupported device {q.device}")
    out = _launch_fwd("flash_attn_fwd_f32", "flash_attn_fwd_f32", q, k, v, layout, with_lse,
                      torch.float32, F32_HEAD_DIMS)
    flash_attn_fwd_f32.launches += 1
    return out


flash_attn_fwd_f32.launches = 0


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


def quantize_qk_int8(q: torch.Tensor, k: torch.Tensor, layout: str = "bhnd"):
    """The transform of ``_quantize_qk_int8``
    (``videogpa_tpu/ops/attention.py:685``) on 4-D operands in ``layout``.

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
    qf = q.float() * (D ** -0.5 * _LOG2E)
    sq = qf.abs().amax(dim=-1, keepdim=True) / i127 + 1e-12
    q8 = torch.round(qf.div_(sq)).to(torch.int8)
    return q8, sq.squeeze(-1), k8, sk.squeeze(-1)


def flash_attn_int8_reference(q8, sq, k8, sk, v, layout: str = "bnhd") -> torch.Tensor:
    """Plain version of K8 and K9: the same function, the same layouts.

    The integer scores are exact: an f32 product of int8 operands holds every
    term (< 2^14) and every partial sum (< 2^24 up to head_dim 1,040) as an
    integer. Then S = s * sq[row] * sk[col], exp2 against the row max, P cast
    to V's dtype, PV in f32, divided by the f32 row sum. Returns O in
    ``layout``, contiguous, in V's dtype."""
    if q8.shape[-1] * 127 * 127 >= 2 ** 24:
        raise ValueError("flash_attn_int8_reference: head_dim too large for exact f32 sums")
    if layout == "bnhd":
        q8, k8, v = (x.transpose(1, 2) for x in (q8, k8, v))
        sq, sk = sq.transpose(1, 2), sk.transpose(1, 2)
    s = torch.matmul(q8.float(), k8.float().transpose(-1, -2))
    s.mul_(sq[..., :, None]).mul_(sk[..., None, :])  # in place: (Nq, Nk) f32 per head
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp2_()
    l = p.sum(dim=-1, keepdim=True)
    o = (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(v.dtype)
    if layout == "bnhd":
        o = o.transpose(1, 2)
    return o.contiguous()


def _int8_forward(fn_name: str, head_dims, q8, sq, k8, sk, v, layout) -> torch.Tensor:
    """Both int8-QK wrappers: the plain version for CPU tensors, the entry
    point ``fn_name`` for CUDA tensors."""
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q8.device.type == "cpu":
        return flash_attn_int8_reference(q8, sq, k8, sk, v, layout)
    if q8.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {q8.device}")
    return _launch_int8(fn_name, head_dims, q8, sq, k8, sk, v, layout)


def _launch_int8(fn_name: str, head_dims, q8, sq, k8, sk, v, layout) -> torch.Tensor:
    """Validate the int8-QK operands and launch the entry point ``fn_name``
    (K8 and K9 share one C interface), at any B*H."""
    B, Nq, H, D, _, _, _ = _dims(q8, layout)
    Bk, Nk, Hk, Dk, _, _, _ = _dims(k8, layout)
    for name, x, dtype in (("q8", q8, torch.int8), ("k8", k8, torch.int8),
                           ("sq", sq, torch.float32), ("sk", sk, torch.float32),
                           ("v", v, torch.bfloat16)):
        if x.device != q8.device:
            raise ValueError(f"{fn_name}: {name} on {x.device}, q8 on {q8.device}")
        if x.dtype != dtype:
            raise TypeError(f"{fn_name}: {name} must be {dtype}, got {x.dtype}")
    # TMA's rule for q8, k8 and v (``check_16_bytes``)
    for name, x in (("q8", q8), ("k8", k8), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{fn_name}: {name} needs a contiguous last dim")
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
    if q8.is_cuda:
        flash_attn_int8.launches += 1
    return o


flash_attn_int8.launches = 0


def flash_attn_int8_d128(q8: torch.Tensor, sq: torch.Tensor, k8: torch.Tensor,
                         sk: torch.Tensor, v: torch.Tensor,
                         layout: str = "bnhd") -> torch.Tensor:
    """K9: :func:`flash_attn_int8` at head_dim 128 (the same kernel body).
    ``attention`` does not dispatch it: ``impl="flash_int8"`` at head_dim 128
    takes the exact kernel, as in the JAX package.

    CPU tensors take the plain version. CUDA tensors must have V in bf16,
    D = 128, every sq > 0 (as for K8) and q8, k8, v that meet TMA's 16-byte
    rule, at any B*H; anything else raises or, for sq <= 0, is undefined. Each kernel launch adds one to
    ``flash_attn_int8_d128.launches``.
    """
    o = _int8_forward("flash_attn_int8_d128", (128,), q8, sq, k8, sk, v, layout)
    if q8.is_cuda:
        flash_attn_int8_d128.launches += 1
    return o


flash_attn_int8_d128.launches = 0


class _FlashAttention(torch.autograd.Function):
    """A forward kernel with LSE and its backward kernel: ``flash_attn_fwd``
    and ``flash_attn_bwd`` at head_dim < 128, ``flash_attn_fwd_d128`` and
    ``flash_attn_bwd_d128`` at head_dim >= 128, as ``_flash_fwd`` and
    ``_flash_bwd`` split in the JAX package. The counterpart of the JAX
    ``_flash`` and ``_attention_bnhd_vjp`` custom vjps."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        fwd = flash_attn_fwd_d128 if q.shape[-1] >= 128 else flash_attn_fwd
        o, lse = fwd(q, k, v, layout=layout, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attn_bwd_d128 if q.shape[-1] >= 128 else flash_attn_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), layout=ctx.layout)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", layout: str = "bhnd") -> torch.Tensor:
    """Bidirectional multi-head attention (``videogpa_tpu/ops/attention.py:1342``).

    Args:
        q, k, v: (B, H, N, D), or (B, N, H, D) with ``layout="bnhd"`` (the
            projection-natural layout the models feed). k/v may be longer or
            shorter than q.
        impl: "auto" or "flash" -> the exact kernels on CUDA, their plain
            versions on CPU. "flash_int8" -> the int8-QK forward where it
            applies (below), inference only. "ring" is not ported and raises.

    Routing, as ``attention(impl="flash")`` in the JAX package for bf16:

    - an operand requires grad (and grad is enabled) -> ``_FlashAttention``:
      D < 128, K1 with LSE and K3 backward; D >= 128, K6
      (``flash_attn_fwd_d128``) with LSE and K7 (``flash_attn_bwd_d128``);
    - float32 operands -> ``flash_attn_fwd_f32`` (K6's f32 entry, tiled on
      the CUDA cores), at any length: the camera head's short rows and the
      f32 scorer's long ones, which run far slower than bf16 rows on the
      tensor cores;
    - D >= 128 -> ``flash_attn_fwd_d128`` (K6);
    - bnhd rows that are ``short_eligible`` -> ``flash_attn_short`` (K4);
    - otherwise -> ``flash_attn_fwd`` (K1).

    ``impl="flash_int8"`` (``videogpa_tpu/ops/attention.py:1378-1401,
    1437-1448``) raises if an operand requires grad (the int8 forward has no
    backward), and otherwise differs from the above in one case only: D < 128
    on rows that are not short bnhd rows goes through ``quantize_qk_int8``
    and ``flash_attn_int8`` (K8). Short bnhd rows and D >= 128 take the exact
    kernels above. On CUDA K8 takes bf16 operands; float32 ones raise there.

    Returns:
        Output in the operands' layout, dtype of q.
    """
    if impl not in ("auto", "flash", "flash_int8"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (ring attention is a later slice)"
        )
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    D = q.shape[-1]
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if impl == "flash_int8":
        if needs_grad:
            raise RuntimeError("attention(impl='flash_int8') is inference only: it has no "
                               "backward; use impl='flash' under grad")
        seq = _seq_dim(layout)
        short = layout == "bnhd" and short_eligible(k.shape[seq], q.shape[2], D,
                                                    q.element_size())
        if D < 128 and not short:
            if q.is_cuda and q.dtype != torch.bfloat16:
                raise NotImplementedError(
                    f"attention(impl='flash_int8') on CUDA takes bf16 operands, got {q.dtype}")
            q8, sq, k8, sk = quantize_qk_int8(q, k, layout)
            return flash_attn_int8(q8, sq, k8, sk, v, layout).to(q.dtype)
    if needs_grad:
        return _FlashAttention.apply(q, k, v, layout)
    if q.dtype == torch.float32:
        return flash_attn_fwd_f32(q, k, v, layout=layout)[0]
    if D >= 128:
        return flash_attn_fwd_d128(q, k, v, layout=layout)[0]
    if layout == "bnhd" and short_eligible(k.shape[1], q.shape[2], D, q.element_size()):
        return flash_attn_short(q, k, v)
    return flash_attn_fwd(q, k, v, layout=layout)[0]
