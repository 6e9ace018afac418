"""FPN top-down neck, RetinaNet's form (counterpart of ``tpudet/nn/necks/fpn.py``).

P5 is a 3x3 conv of C5. Going down, each level is a 1x1 lateral conv plus the
bilinearly upsampled running top-down sum, and a 3x3 conv of that sum is the
level's output: the raw sum, not the conv, feeds the next level. P6 and P7
are stride-2 3x3 convs stacked on P5. Every conv is a pre-activation
BN-ReLU-conv.

In bfloat16 the top-down sums are float32, as in tpudet: the upsampling's
float32 weights promote its bf16 input, and ``lateral + upsampled`` follows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpudet_torch.nn.layers import BNActConv, resize_bilinear


class RetinaFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], feature_size: int = 256,
                 num_extra_levels: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c3, c4, c5 = in_channels
        f = feature_size

        def unit(in_ch, kernel, stride=1):
            return BNActConv(in_ch, f, kernel, stride, generator=generator, dtype=dtype)

        # created in flax's order, so one generator draws the same sequence
        self.p5_conv = unit(c5, 3)
        self.p4_lateral = unit(c4, 1)
        self.p4_conv = unit(f, 3)
        self.p3_lateral = unit(c3, 1)
        self.p3_conv = unit(f, 3)
        self.num_extra_levels = num_extra_levels
        for i in range(num_extra_levels):
            self.add_module(f"p{6 + i}_conv", unit(f, 3, 2))

    def forward(self, c3, c4, c5):
        p5 = self.p5_conv(c5)
        lat4 = self.p4_lateral(c4)
        td4 = lat4 + resize_bilinear(p5, *lat4.shape[-2:])
        p4 = self.p4_conv(td4)
        lat3 = self.p3_lateral(c3)
        td3 = lat3 + resize_bilinear(td4, *lat3.shape[-2:])
        p3 = self.p3_conv(td3)
        levels = [p3, p4, p5]
        top = p5
        for i in range(self.num_extra_levels):
            top = getattr(self, f"p{6 + i}_conv")(top)
            levels.append(top)
        return levels
