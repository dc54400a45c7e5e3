"""NN primitives with the JAX package's numerics (``videogpa_tpu/ops/layers.py``).

Plain tensor functions plus thin ``nn.Module`` holders whose ``forward`` calls
them. The semantics that differ from stock PyTorch modules:

- weights are cast to the activation dtype (a bf16 weight applied to an f32
  activation computes in f32, as the JAX time embedding does);
- products accumulate in f32 and the bias is added before the result is cast
  back to the activation dtype;
- layer-norm statistics are taken in f32 with the biased variance.

Layouts: JAX's linear kernel is (in, out), torch's weight (out, in); JAX's
conv kernel is HWIO, torch's OIHW. ``videogpa_torch.convert`` maps between
them.
"""

from __future__ import annotations

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


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0) -> torch.Tensor:
    """NCHW convolution with an OIHW weight."""
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride=stride, padding=padding)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


@torch.no_grad()
def kaiming_uniform_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear/Conv2d/LayerNorm under ``module`` with the JAX
    initialisers' bounds (``videogpa_tpu/ops/layers.py:29-77``): weight and
    bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); layer norms ones/zeros."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = fan_in ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.LayerNorm) and m.weight is not None:
            m.weight.fill_(1.0)
            m.bias.zero_()
