"""Pretrained VGG-16 weights (counterpart of ``tpudet/runtime/pretrain.py``).

``load_vgg16(path)`` reads a local ``.npz`` export of TF-slim's ``vgg_16.ckpt``
with the original variable names; nothing is fetched. ``inject_vgg16`` copies
``vgg_16/convN/convN_M/{weights,biases}`` (HWIO) into the trunk's
``convN_M.conv.{weight,bias}`` (OIHW). With no weights file, initialisation
stays random, as in tpudet.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

_VGG_BLOCKS = {"conv1": 2, "conv2": 2, "conv3": 3, "conv4": 3, "conv5": 3}


def load_vgg16(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """Read vgg_16 variables into ``{tf_name: array}``; None if no path or no file."""
    if path is None:
        return None
    if not os.path.exists(path):
        warnings.warn(f"pretraining weight {path!r} not found; using random init")
        return None
    if not path.endswith(".npz"):
        raise ValueError(f"only .npz exports of vgg_16 are read, got {path!r}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def inject_vgg16(trunk: torch.nn.Module, weights: Optional[Dict[str, np.ndarray]]):
    """Copy checkpoint tensors into a :class:`VGG16Trunk` in place."""
    if weights is None:
        return trunk
    with torch.no_grad():
        for block, reps in _VGG_BLOCKS.items():
            for i in range(1, reps + 1):
                layer = f"{block}_{i}"
                w = weights.get(f"vgg_16/{block}/{layer}/weights")
                b = weights.get(f"vgg_16/{block}/{layer}/biases")
                if w is None or b is None:
                    warnings.warn(f"vgg_16 tensor for {layer} missing; left at random init")
                    continue
                conv = getattr(trunk, layer).conv
                w = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(w, np.float32).transpose(3, 2, 0, 1)))
                if conv.weight.shape != w.shape:
                    raise ValueError(f"{layer}: kernel {tuple(w.shape)} does not fit "
                                     f"{tuple(conv.weight.shape)}")
                conv.weight.copy_(w)
                conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return trunk
