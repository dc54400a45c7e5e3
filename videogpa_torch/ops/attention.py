"""Multi-head attention: hand-written Hopper flash kernels + plain PyTorch versions.

Counterpart of ``videogpa_tpu/ops/attention.py``. Every attention in VideoGPA
is bidirectional (non-causal). ``flash_attn_fwd`` and ``flash_attn_bwd``
dispatch on the device of their operands: a CPU tensor takes the plain
version (``flash_attn_fwd_reference`` / ``flash_attn_bwd_reference``), a CUDA
tensor launches the kernel (``csrc/flash_attn_fwd.cu`` /
``csrc/flash_attn_bwd.cu``) or raises. There is no fallback from one to the
other. ``attention`` differentiates through both with a
``torch.autograd.Function`` whenever an operand requires grad.
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
    if layout == "bnhd":
        B, N, H, D = x.shape
        sb, sn, sh = x.stride(0), x.stride(1), x.stride(2)
    else:
        B, H, N, D = x.shape
        sb, sh, sn = x.stride(0), x.stride(1), x.stride(2)
    return B, N, H, D, sb, sn, sh


def _check_operands(fn: str, layout: str, q, k, v, **like_q) -> Tuple[int, int, int, int, int]:
    """Validate CUDA kernel operands; ``like_q`` are named tensors shaped
    like q. Returns (B, Nq, H, D, Nk)."""
    B, Nq, H, D, _, _, _ = _dims(q, layout)
    Bk, Nk, Hk, Dk, _, _, _ = _dims(k, layout)
    for name, x in {"q": q, "k": k, "v": v, **like_q}.items():
        if x.device != q.device:
            raise ValueError(f"{fn}: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} must be bfloat16, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs a contiguous last dim")
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1]):
            raise ValueError(
                f"{fn}: {name} must be 16-byte aligned with (b, n, h) "
                "strides that are multiples of 8 elements"
            )
    if ((Bk, Hk, Dk) != (B, H, D) or v.shape != k.shape
            or any(x.shape != q.shape for x in like_q.values())):
        shapes = {n: tuple(x.shape) for n, x in {"q": q, "k": k, "v": v, **like_q}.items()}
        raise ValueError(f"{fn}: shapes {shapes} do not match")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{fn}: head_dim {D} not in {KERNEL_HEAD_DIMS} "
            "(head_dim >= 128 is a later kernel)"
        )
    if min(Nq, Nk) < 1 or B * H > 65535:
        raise ValueError(f"{fn}: unsupported sizes B*H={B * H}, Nq={Nq}, Nk={Nk}")
    return B, Nq, H, D, Nk


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
    D in {16, 32, 64}; anything else raises. Each kernel launch adds one to
    ``flash_attn_fwd.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.device.type == "cpu":
        return flash_attn_fwd_reference(q, k, v, layout, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")

    B, Nq, H, D, Nk = _check_operands("flash_attn_fwd", layout, q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = []
    for x in (q, k, v, o):
        strides += _dims(x, layout)[4:]
    fn = _kernels.kernel("flash_attn_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, H, Nq, Nk, D, *strides, D ** -0.5 * _LOG2E, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd: kernel launch failed with cudaError {rc}")
    flash_attn_fwd.launches += 1
    return o, lse


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


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, layout: str = "bnhd"):
    """Gradients (dQ, dK, dV) of ``flash_attn_fwd`` given its output O, its
    natural-log LSE (B, H, Nq) f32 and the output gradient dO.

    q, o and do share q's layout and shape; k, v as in ``flash_attn_fwd``.
    The gradients are new contiguous tensors in ``layout``. CPU tensors take
    the plain version. CUDA tensors must be bf16 with D in {16, 32, 64}, with
    the strides ``flash_attn_fwd`` takes; anything else raises. delta =
    rowsum(O * dO) is a PyTorch reduction, as in the JAX package. Each kernel
    launch adds one to ``flash_attn_bwd.launches``.
    """
    if layout not in ("bnhd", "bhnd"):
        raise ValueError(f"layout must be 'bnhd' or 'bhnd', got {layout!r}")
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, o, lse, do, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd: unsupported device {q.device}")

    B, Nq, H, D, Nk = _check_operands("flash_attn_bwd", layout, q, k, v, o=o, do=do)
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, Nq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attn_bwd: lse must be a contiguous ({B}, {H}, {Nq}) "
                         f"float32 tensor on {q.device}")
    delta = (o.float() * do.float()).sum(-1)
    if layout == "bnhd":
        delta = delta.transpose(1, 2)
    delta = delta.contiguous()  # (B, H, Nq), as the LSE

    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = []
    for x in (q, k, v, do, dq, dk, dv):
        strides += _dims(x, layout)[4:]
    fn = _kernels.kernel("flash_attn_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Nq, Nk, D, *strides, D ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd: kernel launch failed with cudaError {rc}")
    flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """``flash_attn_fwd`` with ``flash_attn_bwd`` as its backward: the
    counterpart of the JAX ``_flash`` and ``_attention_bnhd_vjp`` custom vjps."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        o, lse = flash_attn_fwd(q, k, v, layout=layout, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, o, lse, do.contiguous(), layout=ctx.layout)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", layout: str = "bhnd") -> torch.Tensor:
    """Bidirectional multi-head attention (``videogpa_tpu/ops/attention.py:1342``).

    Args:
        q, k, v: (B, H, N, D), or (B, N, H, D) with ``layout="bnhd"`` (the
            projection-natural layout the DiT feeds). k/v may be longer or
            shorter than q.
        impl: "auto" or "flash" -> the flash kernels on CUDA, their plain
            versions on CPU. Any other impl raises.

    Returns:
        Output in the operands' layout, dtype of q. Differentiable in both
        layouts: when grad is enabled and an operand requires grad, the
        forward keeps its LSE and the backward is ``flash_attn_bwd``.
    """
    if impl not in ("auto", "flash"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (flash_int8 and ring are later slices)"
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, layout)
    return flash_attn_fwd(q, k, v, layout=layout)[0]
