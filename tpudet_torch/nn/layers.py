"""Layer primitives (counterpart of ``tpudet/nn/layers.py``).

Layout is NCHW inside the port. Conventions kept from tpudet:

  * TF "SAME" padding, which is asymmetric: ``total = max((out-1)*stride +
    (k-1)*dilation + 1 - in, 0)``, ``lo = total // 2``, ``hi = total - lo``;
    max-pooling pads with ``-inf``;
  * glorot-uniform conv kernels and zero biases, drawn from a caller's
    ``torch.Generator``;
  * BatchNorm with epsilon 1e-3. This slice serves only, so :class:`BatchNorm`
    is the eval form ``(x - mean) * scale * rsqrt(var + eps) + bias``; its
    parameter and buffer names (``scale``, ``bias``, ``mean``, ``var``) are
    flax's, so weights transfer by name.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1):
    """``(lo, hi)`` padding of one spatial axis under TF "SAME"."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` so that a VALID window op gives TF "SAME" output."""
    top, bottom = same_pads(x.shape[-2], kernel, stride, dilation)
    left, right = same_pads(x.shape[-1], kernel, stride, dilation)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``tf.layers.max_pooling2d(padding='same')``: pads with ``-inf``."""
    return F.max_pool2d(pad_same(x, window, stride, value=-math.inf), window, stride)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with TF "SAME" padding, glorot-uniform kernel, zero bias."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, filters, kernel, stride=stride, dilation=dilation)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)
            self.bias.zero_()

    def reset_parameters(self):
        # nn.Conv2d's own init would draw from the global RNG; __init__ above
        # draws from the caller's generator instead
        pass

    def forward(self, x):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        top, bottom = same_pads(x.shape[-2], k, s, d)
        left, right = same_pads(x.shape[-1], k, s, d)
        if (top, left) != (bottom, right):  # asymmetric: pad by hand
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        return F.conv2d(x, self.weight, self.bias, self.stride, (top, left),
                        self.dilation)


class Conv(nn.Module):
    """Conv(+bias) -> optional activation (no norm)."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = SameConv2d(in_ch, filters, kernel, stride, dilation, generator)
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        return self.activation(x) if self.activation is not None else x


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over channels (dim 1), epsilon 1e-3."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm (batch statistics and flax's biased-variance "
                "update) comes with the SSD training slice; call .eval() to serve")
        mul = self.scale * torch.rsqrt(self.var + BN_EPS)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBN(nn.Module):
    """Conv(+bias) -> BatchNorm -> optional activation."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 dilation: int = 1, activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = SameConv2d(in_ch, filters, kernel, stride, dilation, generator)
        self.bn = BatchNorm(filters)
        self.activation = activation

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.activation(x) if self.activation is not None else x


class L2NormScale(nn.Module):
    """L2 normalisation over channels (norm clamped at 1e-12) times ONE learned
    scalar ``scale`` of shape ``[1]``."""

    def __init__(self, init: float = 20.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x):
        norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
        return x / torch.clamp(norm, min=1e-12) * self.scale
