"""DLA-lite backbone and iterative deconvolution upsampling (counterpart of
``tpudet/nn/backbones/dla.py``).

Three stem ConvBN-ReLU (16 7x7, 16 3x3, 32 3x3/2), then four recursive DLA
stages (64/128/256/512), each followed by a 2x2/2 max-pool; stages 4-6 add a
1x1 ConvBN-ReLU of the previous stage, 2x2/2 average-pooled (flax's SAME
``avg_pool``, the padding counted). The neck fuses stages 4-6 down to
stride 4 through 4x4/2 transposed convolutions (flax's ``ConvTranspose``,
which does not flip its kernel: :class:`SameConvTranspose2d`).

Quirk kept: a basic block always runs its ``shortcut`` ConvBN, even where it
then takes the identity (the reference picks one with a runtime check
inside ``tf.cond``, so both branches exist). In train mode that BatchNorm's
running statistics still move, and its parameters still take weight decay
(and Adam's moments) with no loss gradient; the port computes it the same
way in train mode, and skips it in eval mode, where nothing reads it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpudet_torch.nn.layers import (BatchNorm, ConvBN, SameConvTranspose2d,
                                    avg_pool_same, max_pool_same)


def _conv_relu(in_ch, filters, kernel, stride=1, generator=None, dtype=torch.float32):
    return ConvBN(in_ch, filters, kernel, stride, activation=torch.relu,
                  generator=generator, dtype=dtype)


class _DeconvBN(nn.Module):
    """4x4/2 SAME transposed conv, BatchNorm, ReLU."""

    def __init__(self, in_ch: int, filters: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dconv = SameConvTranspose2d(in_ch, filters, 4, 2, generator, dtype)
        self.bn = BatchNorm(filters)

    def forward(self, x):
        return torch.relu(self.bn(self.dconv(x)))


class _BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv_relu(in_ch, filters, 3, generator=generator, dtype=dtype)
        self.conv2 = _conv_relu(filters, filters, 3, generator=generator, dtype=dtype)
        self.shortcut = _conv_relu(in_ch, filters, 1, generator=generator, dtype=dtype)
        self.identity = in_ch == filters

    def forward(self, x):
        conv = self.conv2(self.conv1(x))
        if not self.identity:
            return conv + self.shortcut(x)
        if self.training:
            self.shortcut(x)  # the quirk: its BatchNorm statistics still move
        return conv + x


class _DLATree(nn.Module):
    def __init__(self, in_ch: int, filters: int, levels: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        if levels == 1:
            self.names = ("block1", "block2")
            self.block1 = _BasicBlock(in_ch, filters, **kw)
            self.block2 = _BasicBlock(filters, filters, **kw)
        else:
            self.names = ("tree1", "tree2")
            self.tree1 = _DLATree(in_ch, filters, levels - 1, **kw)
            self.tree2 = _DLATree(filters, filters, levels - 1, **kw)
        self.aggregate = _conv_relu(filters, filters, 3, **kw)

    def forward(self, x):
        b1 = getattr(self, self.names[0])(x)
        b2 = getattr(self, self.names[1])(b1)
        return self.aggregate(b1 + b2)


class DLABackbone(nn.Module):
    """Returns ``(stage4 /8, stage5 /16, stage6 /32)``; ``out_channels`` lists
    their widths."""

    out_channels = (128, 256, 512)

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.stem1 = _conv_relu(3, 16, 7, **kw)
        self.stem2 = _conv_relu(16, 16, 3, **kw)
        self.stem3 = _conv_relu(16, 32, 3, 2, **kw)
        self.stage3 = _DLATree(32, 64, 1, **kw)
        self.stage4 = _DLATree(64, 128, 2, **kw)
        self.stage4_residual = _conv_relu(64, 128, 1, **kw)
        self.stage5 = _DLATree(128, 256, 2, **kw)
        self.stage5_residual = _conv_relu(128, 256, 1, **kw)
        self.stage6 = _DLATree(256, 512, 1, **kw)
        self.stage6_residual = _conv_relu(256, 512, 1, **kw)

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        s3 = max_pool_same(self.stage3(x), 2, 2)
        s4 = (max_pool_same(self.stage4(s3), 2, 2)
              + avg_pool_same(self.stage4_residual(s3), 2, 2))
        s5 = (max_pool_same(self.stage5(s4), 2, 2)
              + avg_pool_same(self.stage5_residual(s4), 2, 2))
        s6 = (max_pool_same(self.stage6(s5), 2, 2)
              + avg_pool_same(self.stage6_residual(s5), 2, 2))
        return s4, s5, s6


class DLAUp(nn.Module):
    """Iterative deconvolution fusion of stages 4-6 to a 256-wide stride-4
    map."""

    def __init__(self, in_channels=DLABackbone.out_channels,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        c4, c5, c6 = in_channels
        self.s6_proj = _conv_relu(c6, 256, 1, **kw)
        self.s6_up1 = _DeconvBN(256, 256, **kw)
        self.s6_up2 = _DeconvBN(256, 256, **kw)
        self.s6_up3 = _DeconvBN(256, 256, **kw)
        self.s5_proj = _conv_relu(c5, 256, 1, **kw)
        self.s5_fuse = _conv_relu(256, 256, 3, **kw)
        self.s5_up1 = _DeconvBN(256, 256, **kw)
        self.s5_up2 = _DeconvBN(256, 256, **kw)
        self.s4_proj = _conv_relu(c4, 256, 1, **kw)
        self.s4_fuse = _conv_relu(256, 256, 3, **kw)
        self.s4_up1 = _DeconvBN(256, 256, **kw)
        self.out_conv1 = _conv_relu(256, 256, 3, **kw)
        self.out_conv2 = _conv_relu(256, 256, 1, **kw)

    def forward(self, s4, s5, s6):
        s6 = self.s6_proj(s6)
        s6_5 = self.s6_up1(s6)
        s6_4 = self.s6_up2(s6_5)
        s6_3 = self.s6_up3(s6_4)
        s5_4 = self.s5_up1(self.s5_fuse(self.s5_proj(s5) + s6_5))
        s5_3 = self.s5_up2(s5_4)
        s4_3 = self.s4_up1(self.s4_fuse(self.s4_proj(s4) + s5_4 + s6_4))
        return self.out_conv2(self.out_conv1(s6_3 + s5_3 + s4_3))
