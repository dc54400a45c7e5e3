"""W8A8 dynamically quantised linear layers for inference
(``videogpa_tpu/ops/quant.py``).

Scheme (SmoothQuant-style dynamic W8A8, inference only):

- weights: symmetric int8 per OUTPUT channel, quantised once at load time
  (``quantize_linear`` / ``quantize_dit_int8`` and its siblings);
- activations: symmetric int8 per TOKEN, quantised on the fly (an abs-max
  reduction and a scale over the activation the product reads anyway);
- int32 accumulation, f32 rescale: y = (qx @ qw^T) * (sx * sw) + b.

The integer product is one library GEMM behind ``int8_matmul``
(``torch._int_mm``), as the JAX package leaves it to an XLA ``dot_general``
outside any kernel; the quantise and dequantise passes are plain PyTorch.

A quantised layer is a ``QuantLinear`` module in the place of the ``Linear``
it replaces, so every call site takes it unchanged. LoRA deltas stay on the
float path on top: they read the raw activations, not the int8 ones. The
order is ``merge_lora`` first, then quantise.

The ``quantize_*_int8`` functions work in place, layer by layer: each float
weight is freed as its int8 image is made, so a model never holds both
images of its weights at once (``quantize_on_device`` in the JAX package).
Quantise a model after it has its device and dtype: ``module.to(dtype)``
would cast the f32 scales too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


def _over_127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as a true IEEE division on every device. With a Python
    scalar PyTorch's CUDA kernel multiplies by the reciprocal, which moves a
    scale by an ulp and with it the integers that sit on a rounding tie."""
    return amax / amax.new_full((), 127.0)


def quantize_linear(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (..., out, in) -> (w_int8 (..., out, in) int8, w_scale (..., out) f32).

    The reduction is over ``in``, so a stack of layers gets one scale per
    (layer, output channel). ``torch.round`` rounds half to even, as
    ``jnp.round``.
    """
    w = weight.detach().float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    scale = _over_127(amax.clamp_min(1e-12))
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


# torch._int_mm on CUDA (cuBLASLt int8): more than 16 rows, inner and output
# widths multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def int8_matmul(qx: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """qx (M, K) int8 @ w_int8 (N, K)^T -> (M, N) int32, exact.

    One library integer GEMM (``torch._int_mm``). Raises on operands it does
    not take; there is no float product behind it.
    """
    if qx.dtype != torch.int8 or w_int8.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got {qx.dtype} and {w_int8.dtype}")
    if qx.dim() != 2 or w_int8.dim() != 2 or qx.shape[1] != w_int8.shape[1]:
        raise ValueError(f"int8_matmul: shapes {tuple(qx.shape)} and {tuple(w_int8.shape)} "
                         "are not (M, K) and (N, K)")
    if qx.device != w_int8.device:
        raise ValueError(f"int8_matmul: qx on {qx.device}, w_int8 on {w_int8.device}")
    M, K = qx.shape
    N = w_int8.shape[0]
    if qx.is_cuda and (M < _INT_MM_MIN_ROWS or K % _INT_MM_MULTIPLE or N % _INT_MM_MULTIPLE):
        raise ValueError(
            f"int8_matmul: the CUDA integer GEMM takes more than {_INT_MM_MIN_ROWS - 1} rows "
            f"and inner and output widths that are multiples of {_INT_MM_MULTIPLE}; got "
            f"M={M}, K={K}, N={N}")
    return torch._int_mm(qx.contiguous(), w_int8.t())


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) -> (qx int8, sx (..., 1) f32): per-token symmetric int8,
    the scale taken in f32 from the activation as it is."""
    xf = x.float()
    sx = _over_127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12))
    qx = torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
    return qx, sx


def linear_w8a8(x: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic per-token int8 activation x per-channel int8 weight product.

    x (..., K) in any float dtype, w_int8 (N, K), w_scale (N,), bias (N,) or
    None -> (..., N) in x's dtype. The rescale multiplies the f32 image of
    the int32 sums by sx, then by w_scale, in place: the (M, N) table of
    sx * w_scale is never built.
    """
    qx, sx = quantize_activations(x)
    acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), w_int8)
    y = acc.float().mul_(sx.reshape(-1, 1)).mul_(w_scale.float())
    if bias is not None:
        y.add_(bias.float())
    return y.to(x.dtype).reshape(*x.shape[:-1], w_int8.shape[0])


class QuantLinear(nn.Module):
    """An int8 image of a ``Linear``: buffers ``w_int8`` (out, in) int8 and
    ``w_scale`` (out,) f32, and the bias as it was. ``forward`` is
    :func:`linear_w8a8`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.zeros((out_features, in_features),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("w_scale", torch.ones((out_features,), dtype=torch.float32,
                                                   device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros((out_features,), device=device, dtype=dtype),
                                     requires_grad=False)
        else:
            self.register_parameter("bias", None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        q = cls(linear.in_features, linear.out_features, bias=False)
        q.w_int8, q.w_scale = quantize_linear(linear.weight)
        q.bias = linear.bias
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_w8a8(x, self.w_int8, self.w_scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def _quantize_children(parent: nn.Module, names) -> None:
    """Swap the named ``Linear`` children of ``parent`` for their int8
    images, one at a time, dropping each float weight as it goes."""
    for name in names:
        child = getattr(parent, name, None)
        if isinstance(child, nn.Linear):
            setattr(parent, name, QuantLinear.from_linear(child))


def _linear_children(parent: nn.Module):
    return [name for name, child in parent.named_children() if isinstance(child, nn.Linear)]


def quantize_dit_int8(model: nn.Module) -> nn.Module:
    """CogVideoX DiT: every block's to_q/to_k/to_v/to_out and ff.fc1/fc2
    become int8, in place. Embedders, AdaLN modulation and the output head
    stay as they are: they are small and sensitive to range."""
    for blk in model.blocks:
        _quantize_children(blk.attn1, ("to_q", "to_k", "to_v", "to_out"))
        _quantize_children(blk.ff, ("fc1", "fc2"))
    return model


def _quantize_vit_blocks(blocks) -> None:
    """One stack of ViT blocks: attn.qkv, attn.proj and every linear of the
    MLP (fc1/fc2, or the SwiGLU's)."""
    for blk in blocks:
        _quantize_children(blk.attn, ("qkv", "proj"))
        _quantize_children(blk.mlp, _linear_children(blk.mlp))


def quantize_vggt_int8(model: nn.Module) -> nn.Module:
    """VGGT: the aggregator's frame and global blocks become int8, in place
    (the scorer's bulk of matrix products). The DINOv2 patch embed, the
    camera head and the DPT heads stay as they are."""
    _quantize_vit_blocks(model.aggregator.frame_blocks)
    _quantize_vit_blocks(model.aggregator.global_blocks)
    return model


def quantize_wan_int8(model: nn.Module) -> nn.Module:
    """Wan DiT: every block's self- and cross-attention q/k/v/o and its FFN
    linears become int8, in place."""
    for blk in model.blocks:
        for attn in ("self_attn", "cross_attn"):
            _quantize_children(getattr(blk, attn), ("q", "k", "v", "o"))
        _quantize_children(blk.ffn, _linear_children(blk.ffn))
    return model


def quantize_da3_int8(model: nn.Module) -> nn.Module:
    """DA3: the AA-ViT's pre and alternating blocks become int8, in place.
    The patch embed, the camera encoder and decoder and the DualDPT stay as
    they are (the heads run f32, as the reference's autocast-off region)."""
    _quantize_vit_blocks(model.backbone.blocks_pre)
    _quantize_vit_blocks(model.backbone.blocks_alt)
    return model


def quantize_scorer_params(backbone: str, model: nn.Module) -> Tuple[nn.Module, str]:
    """The scorer's int8 mode: (the model quantised in place, the
    ``attn_impl`` to hand to ``VideoProcessor``)."""
    q = quantize_da3_int8 if backbone.lower() == "da3" else quantize_vggt_int8
    return q(model), "flash_int8"
