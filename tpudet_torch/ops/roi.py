"""RoI feature extraction: ``tf.image.crop_and_resize`` (counterpart of
``tpudet/ops/roi.py``, its gather form).

Boxes are ``(y1, x1, y2, x2)`` in NORMALIZED image coordinates. For a crop size
``S > 1`` the sample grid is ``y_i = (y1 + i (y2 - y1) / (S - 1)) (H - 1)``,
bilinear between the four neighbouring cells, and a sample outside
``[0, H-1] x [0, W-1]`` is 0 as a whole (TF's ``extrapolation_value``).

tpudet's einsum form of the same crop is a TPU layout trick and has no
counterpart here.
"""

from __future__ import annotations

import torch


def _sample_axis(coords: torch.Tensor, limit: int):
    """Corner indices, the fraction and the in-frame mask along one axis. The
    fraction carries the gradient to the boxes; ``floor`` carries none."""
    in_range = (coords >= 0.0) & (coords <= limit - 1)
    c0 = torch.floor(coords)
    frac = coords - c0
    c0i = torch.clamp(c0.detach().long(), 0, limit - 1)
    c1i = torch.clamp(c0i + 1, 0, limit - 1)
    return c0i, c1i, frac, in_range


def crop_and_resize(feat: torch.Tensor, boxes: torch.Tensor, size: int) -> torch.Tensor:
    """Crops of NCHW ``feat [B, C, H, W]`` at ``boxes [B, N, 4]`` (image ``b``'s
    boxes crop image ``b``) -> ``[B, N, size, size, C]``, channels LAST: a
    crop flattens in (row, column, channel) order, as flax's RoI head
    flattens its NHWC crop.

    The four corners are gathered with ``index_select`` from the map
    flattened to ``[B*H*W, C]`` in float32 (its backward is an ``index_add``
    that accumulates in float32); the lerp runs in float32, as JAX promotes a
    bfloat16 feature times a float32 weight, and a bfloat16 map gives a
    bfloat16 result.
    """
    b, c, h, w = feat.shape
    n = boxes.shape[1]
    flat = feat.permute(0, 2, 3, 1).reshape(b * h * w, c).float()
    steps = torch.arange(size, dtype=torch.float32, device=boxes.device) / max(size - 1, 1)
    y1, x1, y2, x2 = boxes.float().unbind(-1)
    ys = (y1[..., None] + steps * (y2 - y1)[..., None]) * (h - 1)  # [B, N, S]
    xs = (x1[..., None] + steps * (x2 - x1)[..., None]) * (w - 1)
    y0, y1i, fy, vy = _sample_axis(ys, h)
    x0, x1i, fx, vx = _sample_axis(xs, w)
    base = (torch.arange(b, device=boxes.device) * (h * w)).view(b, 1, 1, 1)

    def gather(yi, xi):
        idx = base + yi[..., :, None] * w + xi[..., None, :]  # [B, N, S, S]
        return flat.index_select(0, idx.reshape(-1)).view(b, n, size, size, c)

    wx1 = fx[..., None, :, None]
    wx0 = 1 - fx[..., None, :, None]
    top = gather(y0, x0) * wx0 + gather(y0, x1i) * wx1
    bot = gather(y1i, x0) * wx0 + gather(y1i, x1i) * wx1
    out = top * (1 - fy)[..., :, None, None] + bot * fy[..., :, None, None]
    valid = (vy[..., :, None] & vx[..., None, :]).to(out.dtype)
    out = out * valid[..., None]
    return out.to(torch.bfloat16) if feat.dtype == torch.bfloat16 else out
