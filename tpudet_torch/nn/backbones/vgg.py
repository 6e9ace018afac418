"""VGG-16 trunk + SSD extra stages (counterpart of ``tpudet/nn/backbones/vgg.py``).

conv1_1..conv5_3 are plain conv+bias+ReLU layers (TF-slim ``vgg_16`` weights
inject 1:1, see :mod:`tpudet_torch.runtime.pretrain`), pool5 is a stride-1 SAME
3x3 max-pool, conv6 is dilated by 2, and the extra stages are ConvBN+ReLU.
Submodule names are tpudet's, so flax weights transfer by name.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpudet_torch.nn.layers import Conv, ConvBN, max_pool_same

_VGG_CFG = (
    ("conv1", 64, 2),
    ("conv2", 128, 2),
    ("conv3", 256, 3),
    ("conv4", 512, 3),
    ("conv5", 512, 3),
)


class VGG16Trunk(nn.Module):
    """conv1_1 .. conv5_3 with 2x2 SAME max-pools after blocks 1-4.

    Returns ``(conv4_3, conv5_3)``: conv4_3 is pre-pool4 (stride 8), conv5_3 the
    block-5 output (stride 16). ``with_conv5=False`` stops after conv4_3 and
    returns ``(conv4_3, None)``: block 5's parameters stay in the module, as
    they stay in tpudet's tree when its output is dropped (PFPNet).
    """

    def __init__(self, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        in_ch = 3
        for block, width, reps in _VGG_CFG:
            for ri in range(reps):
                self.add_module(f"{block}_{ri + 1}",
                                Conv(in_ch, width, 3, activation=torch.relu,
                                     generator=generator, dtype=dtype))
                in_ch = width

    def forward(self, x, with_conv5: bool = True):
        endpoints = {"conv5_3": None}
        blocks = _VGG_CFG if with_conv5 else _VGG_CFG[:4]
        for bi, (block, _, reps) in enumerate(blocks):
            for ri in range(reps):
                x = getattr(self, f"{block}_{ri + 1}")(x)
            endpoints[f"{block}_{reps}"] = x
            if bi < len(blocks) - 1:
                x = max_pool_same(x, 2, 2)
        return endpoints["conv4_3"], endpoints["conv5_3"]


class SSDVGGExtractor(nn.Module):
    """VGG trunk + dilated conv6/conv7 + the extra stages.

    Each entry of ``extra_strides`` builds a 1x1 ConvBN bottleneck then a 3x3
    ConvBN with that stride (SSD300: strides (2, 2, 1, 2)). Returns the endpoint
    list ``[conv4_3, conv7, conv8_2, conv9_2, ...]``. Every conv computes in
    ``dtype``.
    """

    def __init__(self, extra_widths: Sequence[int] = (512, 256, 256, 256),
                 extra_strides: Sequence[int] = (2, 2, 1, 2),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vgg = VGG16Trunk(generator, dtype)
        self.conv6 = ConvBN(512, 1024, 3, dilation=2, activation=torch.relu,
                            generator=generator, dtype=dtype)
        self.conv7 = ConvBN(1024, 1024, 1, activation=torch.relu, generator=generator,
                            dtype=dtype)
        self.num_extras = len(extra_widths)
        in_ch = 1024
        for i, (width, stride) in enumerate(zip(extra_widths, extra_strides)):
            self.add_module(f"conv{8 + i}_1",
                            ConvBN(in_ch, width // 2, 1, activation=torch.relu,
                                   generator=generator, dtype=dtype))
            self.add_module(f"conv{8 + i}_2",
                            ConvBN(width // 2, width, 3, stride=stride,
                                   activation=torch.relu, generator=generator,
                                   dtype=dtype))
            in_ch = width
        self.out_channels = [512, 1024, *extra_widths]

    def forward(self, x):
        conv4_3, conv5_3 = self.vgg(x)
        x = max_pool_same(conv5_3, 3, 1)  # pool5, stride 1
        x = self.conv6(x)
        conv7 = self.conv7(x)
        feats = [conv4_3, conv7]
        x = conv7
        for i in range(self.num_extras):
            x = getattr(self, f"conv{8 + i}_1")(x)
            x = getattr(self, f"conv{8 + i}_2")(x)
            feats.append(x)
        return feats
