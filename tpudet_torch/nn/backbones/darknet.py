"""DarkNet backbones (counterpart of ``tpudet/nn/backbones/darknet.py``), NCHW.

DarkNet-19: 18 ConvBN + LeakyReLU(0.1) layers (glorot-uniform kernels) with
five SAME 2x2 max-pools, stride 32; it also returns conv17, YOLOv2's
passthrough, at the same stride 32 (quirk Q14: no stride-16 layer, no
space-to-depth).

DarkNet-53: a stride-2 entry conv per stage and ``[1, 2, 8, 8, 4]`` residual
units (a 1x1 conv to half the width, a 3x3 back, an additive skip); every
conv is a :class:`_DarkConv` with flax's ``variance_scaling(2.0, "fan_in",
"truncated_normal")`` kernel. Returns ``(block5 /32, block4 /16, block3 /8)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpudet_torch.nn.layers import ConvBN, he_truncated_normal_, max_pool_same

LEAKY_SLOPE = 0.1


def leaky(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu(x, 0.1)``: ``where(x >= 0, x, 0.1 * x)``, with the
    slope in ``x``'s dtype (a bfloat16 ``x`` multiplies by bfloat16's 0.1, as
    JAX's weakly typed scalar does), and a gradient of 1 at 0."""
    return torch.where(x >= 0, x, x * torch.tensor(LEAKY_SLOPE, dtype=x.dtype))


# DarkNet-19's convs, (filters, kernel), with a max-pool after the ones marked
_DARKNET19 = ((32, 3, True), (64, 3, True), (128, 3, False), (64, 1, False),
              (128, 3, True), (256, 3, False), (128, 1, False), (256, 3, True),
              (512, 3, False), (256, 1, False), (512, 3, False), (256, 1, False),
              (512, 3, True), (1024, 3, False), (512, 1, False), (1024, 3, False),
              (512, 1, False), (1024, 3, False))


class DarkNet19(nn.Module):
    """Returns ``(conv18, conv17)``, both at stride 32 (Q14)."""

    out_channels = (1024, 512)

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_after = []
        in_ch = 3
        for i, (filters, kernel, pool) in enumerate(_DARKNET19):
            self.add_module(f"conv{i + 1}", ConvBN(in_ch, filters, kernel, activation=leaky,
                                                   generator=generator, dtype=dtype))
            self.pool_after.append(pool)
            in_ch = filters

    def forward(self, x):
        for i, pool in enumerate(self.pool_after[:17]):
            x = getattr(self, f"conv{i + 1}")(x)
            if pool:
                x = max_pool_same(x, 2, 2)
        return self.conv18(x), x


class _DarkConv(ConvBN):
    """SAME conv(+bias) -> BatchNorm (eps 1e-3, momentum 0.99) -> optional
    leaky ReLU, the kernel drawn by ``variance_scaling(2.0, "fan_in",
    "truncated_normal")``."""

    def __init__(self, in_ch: int, filters: int, kernel: int, stride: int = 1,
                 is_activation: bool = True, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, filters, kernel, stride,
                         activation=leaky if is_activation else None,
                         generator=generator, dtype=dtype)
        he_truncated_normal_(self.conv.weight, generator)


class _DarkBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, units: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.units = units
        self.down = _DarkConv(in_ch, filters, 3, 2, generator=generator, dtype=dtype)
        for i in range(units):
            self.add_module(f"unit{i + 1}_conv1", _DarkConv(
                filters, filters // 2, 1, generator=generator, dtype=dtype))
            self.add_module(f"unit{i + 1}_conv2", _DarkConv(
                filters // 2, filters, 3, generator=generator, dtype=dtype))

    def forward(self, x):
        x = self.down(x)
        for i in range(self.units):
            y = getattr(self, f"unit{i + 1}_conv1")(x)
            x = x + getattr(self, f"unit{i + 1}_conv2")(y)
        return x


class DarkNet53(nn.Module):
    """Returns ``(b5, b4, b3)`` at strides 32, 16 and 8."""

    out_channels = (1024, 512, 256)

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_conv = _DarkConv(3, 32, 3, generator=generator, dtype=dtype)
        in_ch = 32
        for i, (filters, units) in enumerate(((64, 1), (128, 2), (256, 8), (512, 8),
                                              (1024, 4))):
            self.add_module(f"block{i + 1}", _DarkBlock(in_ch, filters, units, generator,
                                                        dtype))
            in_ch = filters

    def forward(self, x):
        x = self.block2(self.block1(self.init_conv(x)))
        b3 = self.block3(x)
        b4 = self.block4(b3)
        return self.block5(b4), b4, b3
