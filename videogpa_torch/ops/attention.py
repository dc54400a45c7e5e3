"""Multi-head attention: hand-written Hopper flash kernel + plain PyTorch version.

Counterpart of ``videogpa_tpu/ops/attention.py``. Every attention in VideoGPA
is bidirectional (non-causal). ``flash_attn_fwd`` dispatches on the device of
its operands: a CPU tensor takes the plain version (``flash_attn_fwd_reference``),
a CUDA tensor launches the kernel ``csrc/flash_attn_fwd.cu`` or raises. There
is no fallback from one to the other.
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

    B, Nq, H, D, q_sb, q_sn, q_sh = _dims(q, layout)
    Bk, Nk, Hk, Dk, k_sb, k_sn, k_sh = _dims(k, layout)
    Bv, Nv, Hv, Dv, v_sb, v_sn, v_sh = _dims(v, layout)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attn_fwd: {name} on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attn_fwd: {name} must be bfloat16, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attn_fwd: {name} needs a contiguous last dim")
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:-1]):
            raise ValueError(
                f"flash_attn_fwd: {name} must be 16-byte aligned with (b, n, h) "
                "strides that are multiples of 8 elements"
            )
    if (Bk, Hk, Dk) != (B, H, D) or (Bv, Nv, Hv, Dv) != (Bk, Nk, Hk, Dk):
        raise ValueError(
            f"flash_attn_fwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attn_fwd: head_dim {D} not in {KERNEL_HEAD_DIMS} "
            "(head_dim >= 128 is a later kernel)"
        )
    if min(Nq, Nk) < 1 or B * H > 65535:
        raise ValueError(f"flash_attn_fwd: unsupported sizes B*H={B * H}, Nq={Nq}, Nk={Nk}")

    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _, _, _, _, o_sb, o_sn, o_sh = _dims(o, layout)
    lse = (torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _kernels.kernel("flash_attn_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, H, Nq, Nk, D,
            q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh,
            D ** -0.5 * _LOG2E, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd: kernel launch failed with cudaError {rc}")
    flash_attn_fwd.launches += 1
    return o, lse


flash_attn_fwd.launches = 0


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "auto", layout: str = "bhnd") -> torch.Tensor:
    """Bidirectional multi-head attention (``videogpa_tpu/ops/attention.py:1342``).

    Args:
        q, k, v: (B, H, N, D), or (B, N, H, D) with ``layout="bnhd"`` (the
            projection-natural layout the DiT's inference path feeds). k/v
            may be longer or shorter than q.
        impl: "auto" or "flash" -> ``flash_attn_fwd`` (the kernel on CUDA, its
            plain version on CPU). Any other impl raises.

    Returns:
        Output in the operands' layout, dtype of q.
    """
    if impl not in ("auto", "flash"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (flash_int8 and ring are later slices)"
        )
    return flash_attn_fwd(q, k, v, layout=layout)[0]
