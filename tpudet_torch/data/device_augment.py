"""Augmentation inside the train step (counterpart of
``tpudet/data/device_augment.py``).

The host feed's flips and colour jitter run here on the batch the step
already holds on its device, so a device-resident feed moves only indices
and a few random draws a step. The semantics are tpudet's, keyed by the same
JAX PRNG (``prng``), so a seed and a step give tpudet's augmentation:

  * top-down, then left-right flips, with the centre remap
    ``c' = (dim - 1) - c`` on the valid gt rows;
  * brightness: add a per-image uniform ``[0, 0.3)`` delta (on 0-255 pixels,
    as tpudet keeps it);
  * contrast: scale by a uniform ``[0.8, 1.2)`` around the per-image
    per-channel mean over H and W;
  * hue: shift by a uniform ``[-0.1, 0.1)`` through tpudet's HSV.

``cfg`` is the model config's ``device_augment``: ``{"flip_prob": [td, lr],
"color_jitter_prob": p}``, either key optional. ``draws`` makes the random
values on the host in numpy; ``apply_draws`` applies them to float32 NCHW
images and ``gt [B, G, 5]`` rows ``[yc, xc, h, w, class_id]`` on any device.
Padding rows (-1) are left untouched. Colour follows tpudet's order of
operations, so float32 stays within rounding of it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpudet_torch.data import prng


def draws(key: np.ndarray, b: int, cfg) -> Dict[str, np.ndarray]:
    """The draws of ``tpudet.data.device_augment.apply(key, ...)`` for a batch
    of ``b``: ``td``, ``lr`` (bool ``[b]``) with ``flip_prob``; ``brightness``,
    ``contrast``, ``hue`` (float32 ``[b]``, the identity where an image's
    jitter is off) with ``color_jitter_prob``."""
    k_td, k_lr, k_jit, k_bri, k_con, k_hue = prng.split(key, 6)
    out = {}
    flip_prob = cfg.get("flip_prob")
    if flip_prob is not None:
        out["td"] = prng.uniform(k_td, (b,)) < np.float32(flip_prob[0])
        out["lr"] = prng.uniform(k_lr, (b,)) < np.float32(flip_prob[1])
    jitter = cfg.get("color_jitter_prob")
    if jitter is not None:
        do = prng.uniform(k_jit, (b, 3)) < np.float32(jitter)
        out["brightness"] = np.where(do[:, 0], prng.uniform(k_bri, (b,), 0.0, 0.3),
                                     np.float32(0.0))
        out["contrast"] = np.where(do[:, 1], prng.uniform(k_con, (b,), 0.8, 1.2),
                                   np.float32(1.0))
        out["hue"] = np.where(do[:, 2], prng.uniform(k_hue, (b,), -0.1, 0.1),
                              np.float32(0.0))
    return out


def to_device(d: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The draws as tensors on ``device``, copied without waiting for the
    device's queue (the arrays are a few hundred bytes)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in d.items()}


def rgb_to_hsv(rgb: torch.Tensor):
    """tpudet's ``_rgb_to_hsv`` over the channel axis 1 of NCHW images."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    v = torch.amax(rgb, 1)
    mn = torch.amin(rgb, 1)
    c = v - mn
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    s = torch.where(v > 0, c / torch.clamp_min(v, 1e-12), zero)
    safe = torch.clamp_min(c, 1e-12)
    hr = torch.where(c > 0, torch.remainder((g - b) / safe, 6.0), zero)
    hg = torch.where(c > 0, (b - r) / safe + 2.0, zero)
    hb = torch.where(c > 0, (r - g) / safe + 4.0, zero)
    h = torch.where(v == r, hr, torch.where(v == g, hg, hb)) / 6.0
    return h, s, v


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    """tpudet's ``_hsv_to_rgb``: ``[B, H, W]`` planes -> NCHW images."""
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.remainder(torch.floor(h6).to(torch.int32), 6)
    f = h6 - torch.floor(h6)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    choices = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros((h.shape[0], 3, *h.shape[1:]), dtype=h.dtype, device=h.device)
    for k, choice in enumerate(choices):
        out = torch.where((i == k)[:, None], torch.stack(choice, 1), out)
    return out


def flip_gt(gt: torch.Tensor, flip: torch.Tensor, dim_size: float, coord: int):
    """Remap the centre coordinate ``coord`` (0: yc, 1: xc) of the valid rows
    of the flipped images."""
    valid = gt[..., 0] >= 0
    c = gt[..., coord]
    c = torch.where(valid & flip[:, None], (dim_size - 1.0) - c, c)
    out = gt.clone()
    out[..., coord] = c
    return out


def apply_draws(images: torch.Tensor, gt, d: Dict[str, torch.Tensor], cfg):
    """Apply ``draws`` (as tensors on the images' device) to float32 NCHW
    ``images`` and to ``gt`` (or None). Returns ``(images, gt)``."""
    h, w = images.shape[2], images.shape[3]
    if cfg.get("flip_prob") is not None:
        td, lr = d["td"], d["lr"]
        images = torch.where(td[:, None, None, None], images.flip(2), images)
        images = torch.where(lr[:, None, None, None], images.flip(3), images)
        if gt is not None:
            gt = flip_gt(gt, td, float(h), 0)
            gt = flip_gt(gt, lr, float(w), 1)
    if cfg.get("color_jitter_prob") is not None:
        images = images + d["brightness"][:, None, None, None]
        factor = d["contrast"][:, None, None, None]
        mean = torch.sum(images, (2, 3), keepdim=True) * (1.0 / (h * w))
        images = (images - mean) * factor + mean
        hh, ss, vv = rgb_to_hsv(images)
        images = hsv_to_rgb(hh + d["hue"][:, None, None], ss, vv)
    return images, gt


def apply(key: np.ndarray, images: torch.Tensor, gt, cfg):
    """``tpudet.data.device_augment.apply`` on float32 NCHW images: the draws
    of ``key`` made on the host, moved to the images' device and applied."""
    return apply_draws(images, gt, to_device(draws(key, images.shape[0], cfg),
                                             images.device), cfg)
