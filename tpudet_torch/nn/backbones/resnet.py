"""Pre-activation ResNet (counterpart of ``tpudet/nn/backbones/resnet.py``).

tpudet's quirks, kept:
  * Q7: stage ``i`` is ``width_base * 2^i`` wide (``width_base`` 7 for
    RetinaNet), so the bottleneck stages put out 28/56/112/224 channels;
  * Q8: the bottleneck convolves its shortcut with a 3x3 even at stride 1;
    the basic block keeps the identity at stride 1.

``norm="gn"`` is FCOS's GroupNorm variant: every unit normalises with
GroupNorm, and the stem is a 7x7/2 conv with a bias (``init_conv``), a
GroupNorm (``init_gn``) and ReLU instead of a ConvBN+ReLU. Either stem ends
in a 3x3/2 SAME max-pool. Submodule names are flax's, so weights transfer by
name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpudet_torch.nn.layers import (BNActConv, ConvBN, GroupNorm, SameConv2d,
                                    he_truncated_normal_, max_pool_same)


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, norm: str = "bn",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(norm=norm, generator=generator, dtype=dtype)
        self.conv1 = BNActConv(in_ch, filters, 3, stride, **kw)
        self.conv2 = BNActConv(filters, filters, 3, 1, **kw)
        if stride != 1:
            self.shortcut = BNActConv(in_ch, filters, 3, stride, **kw)
        else:
            self.shortcut = None

    def forward(self, x):
        conv = self.conv2(self.conv1(x))
        return conv + (x if self.shortcut is None else self.shortcut(x))


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, norm: str = "bn",
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(norm=norm, generator=generator, dtype=dtype)
        self.conv1 = BNActConv(in_ch, filters, 1, 1, **kw)
        self.conv2 = BNActConv(filters, filters, 3, stride, **kw)
        self.conv3 = BNActConv(filters, filters * 4, 1, 1, **kw)
        # Q8: the shortcut is always convolved (3x3), even at stride 1
        self.shortcut = BNActConv(in_ch, filters * 4, 3, stride, **kw)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x))) + self.shortcut(x)


class PreActResNet(nn.Module):
    """The stem (7x7/2 ConvBN-ReLU, or conv-GroupNorm-ReLU with ``norm="gn"``)
    -> 3x3/2 max-pool -> pre-activation residual stages.

    Returns the last three stage outputs (strides 8, 16, 32 for four stages);
    ``out_channels`` lists their widths."""

    def __init__(self, block_list: Sequence[int], init_conv_filters: int = 16,
                 width_base: int = 7, is_bottleneck: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, norm: str = "bn"):
        super().__init__()
        self.norm = norm
        if norm == "bn":
            self.init_conv = ConvBN(3, init_conv_filters, 7, 2, activation=torch.relu,
                                    generator=generator, dtype=dtype)
        else:
            self.init_conv = SameConv2d(3, init_conv_filters, 7, 2, generator=generator,
                                        dtype=dtype)
            he_truncated_normal_(self.init_conv.weight, generator)
            self.init_gn = GroupNorm(init_conv_filters, dtype=dtype)
        block_cls = _Bottleneck if is_bottleneck else _BasicBlock
        self.stages = []  # the block names of each stage
        widths = []
        in_ch = init_conv_filters
        for si, reps in enumerate(block_list):
            width = width_base * 2 ** si  # Q7
            names = []
            for ui in range(reps):
                stride = 2 if (si > 0 and ui == 0) else 1
                names.append(f"block{si + 1}_unit{ui + 1}")
                self.add_module(names[-1],
                                block_cls(in_ch, width, stride, norm, generator, dtype))
                in_ch = width * block_cls.expansion
            self.stages.append(names)
            widths.append(in_ch)
        self.out_channels = widths[-3:]

    def forward(self, x):
        x = self.init_conv(x)
        if self.norm == "gn":
            x = torch.relu(self.init_gn(x))
        x = max_pool_same(x, 3, 2)
        endpoints = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            endpoints.append(x)
        return endpoints[-3], endpoints[-2], endpoints[-1]
