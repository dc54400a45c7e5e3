"""NN primitives with the JAX package's numerics (``videogpa_tpu/ops/layers.py``).

Plain tensor functions plus thin ``nn.Module`` holders whose ``forward`` calls
them. The semantics that differ from stock PyTorch modules:

- weights are cast to the activation dtype (a bf16 weight applied to an f32
  activation computes in f32, as the JAX time embedding does);
- products accumulate in f32 and the bias is added before the result is cast
  back to the activation dtype;
- layer-norm statistics are taken in f32 with the biased variance.

- float32 convolutions on the card stay in full f32: cuDNN would run them in
  TF32 by default (``torch.backends.cudnn.allow_tf32``), which keeps about
  three decimal digits, and the JAX package's f32 convolutions (LPIPS, an
  f32 DPT) are the reference.

Layouts: JAX's linear kernel is (in, out), torch's weight (out, in); JAX's
conv kernel is HWIO, torch's OIHW; JAX's transposed-conv kernel is HWIO too
(k, k, in, out), torch's ConvTranspose2d weight (in, out, k, k).
``videogpa_torch.convert`` maps between them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias; weight (out, in). bf16 products accumulate in f32
    and the bias joins in the f32 epilogue before the cast."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, weight.to(x.dtype), b)


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim, statistics in f32, biased variance."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) over the last dim in f32, times the optional
    scale, cast back (``videogpa_tpu/ops/layers.py:105``)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _full_f32_conv(x: torch.Tensor):
    """A float32 convolution on the card runs with cuDNN's TF32 off for the
    call (``torch.backends.cudnn.flags``), the other cuDNN flags as they are."""
    if x.dtype != torch.float32 or not x.is_cuda:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0) -> torch.Tensor:
    """NCHW convolution with an OIHW weight."""
    b = None if bias is None else bias.to(x.dtype)
    with _full_f32_conv(x):
        return F.conv2d(x, weight.to(x.dtype), b, stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """NCHW transposed conv with kernel_size == stride and padding 0
    (``videogpa_tpu/ops/layers.py:192``): each input pixel expands to a
    k x k block through the (unflipped) kernel. weight (in, out, k, k)."""
    if weight.shape[-2:] != (stride, stride):
        raise ValueError(f"kernel {tuple(weight.shape[-2:])} must equal the stride {stride}")
    b = None if bias is None else bias.to(x.dtype)
    with _full_f32_conv(x):
        return F.conv_transpose2d(x, weight.to(x.dtype), b, stride=stride)


def patch_conv3d(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NCDHW convolution whose stride equals its kernel and that has no
    padding (a video patch embed), as one product over the unfolded patches,
    so it accumulates in f32 and adds the bias before the cast, as ``linear``
    does. x (B, C, F, H, W), weight (O, C, pt, ph, pw). Returns the tokens
    (B, F/pt * H/ph * W/pw, O) in (f, h, w) order."""
    B, C, F_, H, W = x.shape
    O, _, pt, ph, pw = weight.shape
    f, h, w = F_ // pt, H // ph, W // pw
    patches = x[:, :, :f * pt, :h * ph, :w * pw].reshape(B, C, f, pt, h, ph, w, pw)
    patches = patches.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, f * h * w, C * pt * ph * pw)
    return linear(patches, weight.reshape(O, -1), bias)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def mlp(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """fc2(gelu(fc1(x))) with the exact GELU of the ViT blocks and heads."""
    return m.fc2(gelu(m.fc1(x)))


def swiglu(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """silu(x W1) * (x W2) -> W3 (``videogpa_tpu/ops/layers.py:159``)."""
    x1, x2 = m.w12(x).chunk(2, dim=-1)
    return m.w3(F.silu(x1) * x2)


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0) -> int:
    """SwiGLUFFNFused hidden width: 2/3 of the MLP hidden, rounded up to 8."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """Holder of ``rmsnorm``'s scale (the JAX tree's ``scale`` leaf)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class PatchConv3d(nn.Module):
    """Holder of a Conv3d weight (out, in, pt, ph, pw) and bias with
    kernel_size == stride and padding 0; ``forward`` is ``patch_conv3d``."""

    def __init__(self, in_channels: int, out_channels: int, patch_size, device=None,
                 dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels, *patch_size), **fk))
        self.bias = nn.Parameter(torch.empty((out_channels,), **fk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_conv3d(x, self.weight, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """kernel_size == stride, padding 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(x, self.weight, self.bias, self.stride[0])


def group(**children: nn.Module) -> nn.Module:
    """A bare module holding named children, one node of a JAX parameter tree."""
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


@torch.no_grad()
def kaiming_uniform_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear/Conv2d/Conv3d/ConvTranspose2d/LayerNorm/GroupNorm
    under ``module`` with the JAX initialisers' bounds
    (``videogpa_tpu/ops/layers.py:29-77``, the VAE's ``conv3d_init``):
    weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); norms ones/zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            # JAX builds the transposed conv with conv2d_init(in, out, k)
            fan_in = (m.weight.shape[0] * m.weight[0, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel())
            bound = fan_in ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)) and m.weight is not None:
            m.weight.fill_(1.0)
            m.bias.zero_()
