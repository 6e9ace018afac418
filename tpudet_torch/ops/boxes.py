"""Box geometry: format conversion, pairwise IoU, anchor box coding
(counterpart of ``tpudet/ops/boxes.py``).

Conventions: center form ``yx``/``hw``, corner form ``y1x1``/``y2x2``, pixel
units. The IoU has no epsilon by default: ``inter / (a + g - inter)``.
"""

from __future__ import annotations

import torch


def center_to_corners(yx: torch.Tensor, hw: torch.Tensor):
    """``(yx, hw) -> (y1x1, y2x2)``. Shapes ``[..., 2]``."""
    half = hw / 2.0
    return yx - half, yx + half


def corners_to_center(y1x1: torch.Tensor, y2x2: torch.Tensor):
    """``(y1x1, y2x2) -> (yx, hw)``. Shapes ``[..., 2]``."""
    return (y1x1 + y2x2) / 2.0, y2x2 - y1x1


def area(hw: torch.Tensor) -> torch.Tensor:
    """Box area from ``[..., 2]`` height/width."""
    return torch.prod(hw, dim=-1)


def pairwise_iou(g_y1x1, g_y2x2, a_y1x1, a_y2x2, eps: float = 0.0) -> torch.Tensor:
    """``[..., G, A]`` IoU between ``[..., G, 2]`` and ``[A, 2]`` (or
    ``[..., A, 2]``) corner sets."""
    inter_y1x1 = torch.maximum(g_y1x1[..., :, None, :], a_y1x1[..., None, :, :])
    inter_y2x2 = torch.minimum(g_y2x2[..., :, None, :], a_y2x2[..., None, :, :])
    inter = torch.prod(torch.clamp(inter_y2x2 - inter_y1x1, min=0.0), dim=-1)
    g_area = torch.prod(g_y2x2 - g_y1x1, dim=-1)[..., :, None]
    a_area = torch.prod(a_y2x2 - a_y1x1, dim=-1)[..., None, :]
    return inter / (g_area + a_area - inter + eps)


def iou_corner(b1: torch.Tensor, b2: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Elementwise IoU of ``[..., 4]`` (y1, x1, y2, x2) boxes (broadcasting)."""
    inter_y1 = torch.maximum(b1[..., 0], b2[..., 0])
    inter_x1 = torch.maximum(b1[..., 1], b2[..., 1])
    inter_y2 = torch.minimum(b1[..., 2], b2[..., 2])
    inter_x2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (torch.clamp(inter_y2 - inter_y1, min=0.0)
             * torch.clamp(inter_x2 - inter_x1, min=0.0))
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter + eps)


def encode(g_yx, g_hw, a_yx, a_hw):
    """Anchor-relative box target: ``t_yx = (g_yx - a_yx)/a_hw``,
    ``t_hw = log(g_hw/a_hw)``."""
    return (g_yx - a_yx) / a_hw, torch.log(g_hw / a_hw)


def decode(p_yx, p_hw, a_yx, a_hw):
    """Inverse of :func:`encode`: prediction + anchor -> box center form."""
    return p_yx * a_hw + a_yx, a_hw * torch.exp(p_hw)


def clip_corners(y1x1: torch.Tensor, y2x2: torch.Tensor, height: float, width: float):
    """Clip corner boxes to ``[0, h-1] x [0, w-1]``."""
    lim = torch.tensor([height - 1.0, width - 1.0], dtype=torch.float32,
                       device=y1x1.device)
    zero = torch.zeros_like(lim)
    return (torch.clamp(y1x1, min=zero, max=lim),
            torch.clamp(y2x2, min=zero, max=lim))
