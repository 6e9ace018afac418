"""Image augmentor: the reference's single augmentation contract in NumPy (counterpart
of ``tpudet/data/augment.py``: the same draws in the same order, the same float32
arithmetic, so the same outputs bit for bit).

Transcribes utils/image_augmentor.py:7-267 — resize (optionally keep-aspect + pad),
zoom + random/center crop, top-down / left-right flips with box remap, brightness/
contrast/hue jitter, small-angle rotation with box-corner remap, box clipping, center-
outside-frame box dropping, zero-box fallback, center-format conversion, -1 padding —
with these deliberate differences:

  * returns the AUGMENTED image (the reference returns the pre-augmentation
    ``image_copy`` when ``pad_truth_to`` is set — quirk Q2, a training-breaking bug);
  * randomness is explicit: pass a ``numpy.random.Generator``; the TF stateful RNG of
    the reference cannot be reproduced and parity tests inject fixed draws;
  * bilinear/nearest resizes reproduce TF1 ``align_corners=True`` exactly; BICUBIC
    approximates with OpenCV cubic (documented deviation);
  * ``tf.image.adjust_*`` semantics are kept even where odd on 0-255 floats (e.g.
    brightness adds a [0, 0.3) delta — effectively a no-op at 255 scale).

Returns ``(image [out_h, out_w, 3] f32, gt [pad_truth_to, 5])`` with gt rows
``[y_center, x_center, h, w, class_id]`` padded with -1, or just the image when
``ground_truth`` is None (the ImageNet pretraining path).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _resize_align_corners(img: np.ndarray, out_h: int, out_w: int, method: str):
    """TF1 resize with align_corners=True for BILINEAR/NEAREST_NEIGHBOR."""
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img.astype(np.float32)
    ys = (np.arange(out_h, dtype=np.float64) * ((in_h - 1) / (out_h - 1))
          if out_h > 1 else np.zeros(1))
    xs = (np.arange(out_w, dtype=np.float64) * ((in_w - 1) / (out_w - 1))
          if out_w > 1 else np.zeros(1))
    if method == "NEAREST_NEIGHBOR":
        yi = np.round(ys).astype(np.int64)
        xi = np.round(xs).astype(np.int64)
        return img[yi][:, xi].astype(np.float32)
    if method == "BICUBIC":
        import cv2

        return cv2.resize(img.astype(np.float32), (out_w, out_h),
                          interpolation=cv2.INTER_CUBIC)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def _resize_plain(img: np.ndarray, out_h: int, out_w: int):
    """tf.image.resize (v2 default, half-pixel, no align_corners) bilinear — used by
    the zero-box fallback (image_augmentor.py:264)."""
    in_h, in_w = img.shape[:2]
    ys = np.clip((np.arange(out_h) + 0.5) * in_h / out_h - 0.5, 0, in_h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * in_w / out_w - 0.5, 0, in_w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, in_h - 1)
    x1 = np.minimum(x0 + 1, in_w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def _rgb_to_hsv(rgb):
    # TF convention: h, s in [0,1], v = max (any scale)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.max(rgb, -1)
    mn = np.min(rgb, -1)
    c = v - mn
    s = np.where(v > 0, c / np.maximum(v, 1e-12), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        hr = np.where(c > 0, ((g - b) / np.maximum(c, 1e-12)) % 6.0, 0.0)
        hg = np.where(c > 0, (b - r) / np.maximum(c, 1e-12) + 2.0, 0.0)
        hb = np.where(c > 0, (r - g) / np.maximum(c, 1e-12) + 4.0, 0.0)
    h = np.where(v == rgb[..., 0], hr, np.where(v == rgb[..., 1], hg, hb)) / 6.0
    return h, s, v


def _hsv_to_rgb(h, s, v):
    h6 = (h % 1.0) * 6.0
    i = np.floor(h6).astype(np.int64) % 6
    f = h6 - np.floor(h6)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    choices = [
        np.stack([v, t, p], -1), np.stack([q, v, p], -1), np.stack([p, v, t], -1),
        np.stack([p, q, v], -1), np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ]
    out = np.zeros(v.shape + (3,), np.float32)
    for k in range(6):
        out = np.where((i == k)[..., None], choices[k], out)
    return out


def _rotate_image(img: np.ndarray, angle_rad: float):
    """tf.contrib.image.rotate(..., 'BILINEAR'): rotate about the image center,
    zero-fill outside."""
    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    ca, sa = np.cos(angle_rad), np.sin(angle_rad)
    # inverse mapping: output (y,x) samples input at rotation by -angle
    sx = ca * (xx - cx) - sa * (yy - cy) + cx
    sy = sa * (xx - cx) + ca * (yy - cy) + cy
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float32)
        return out * valid[..., None]

    out = (sample(y0, x0) * (1 - fx) * (1 - fy) + sample(y0, x0 + 1) * fx * (1 - fy)
           + sample(y0 + 1, x0) * (1 - fx) * fy + sample(y0 + 1, x0 + 1) * fx * fy)
    return out.astype(np.float32)


def _rotate_boxes(ymin, xmin, ymax, xmax, angle_rad, out_h, out_w):
    """Box corner remap under rotation (image_augmentor.py:236-260 convention)."""
    ang = -angle_rad
    cy, cx = (out_h - 1) / 2.0, (out_w - 1) / 2.0
    off_x = cx * (1 - np.cos(ang)) + cy * np.sin(ang)
    off_y = cy * (1 - np.cos(ang)) - cx * np.sin(ang)

    def rot(x, y):
        return (x * np.cos(ang) - y * np.sin(ang) + off_x,
                x * np.sin(ang) + y * np.cos(ang) + off_y)

    xs, ys = zip(rot(xmin, ymin), rot(xmax, ymax), rot(xmin, ymax), rot(xmax, ymin))
    xs = np.stack(xs, -1)
    ys = np.stack(ys, -1)
    return (ys.min(-1), xs.min(-1), ys.max(-1), xs.max(-1))


def image_augmentor(image, input_shape, data_format, output_shape, zoom_size=None,
                    crop_method=None, flip_prob=None, fill_mode="BILINEAR",
                    keep_aspect_ratios=False, constant_values=0.,
                    color_jitter_prob=None, rotate=None, ground_truth=None,
                    pad_truth_to=None, rng: Optional[np.random.Generator] = None):
    """See module docstring; parameter contract of image_augmentor.py:7-28."""
    if data_format not in ("channels_first", "channels_last"):
        raise Exception("data_format must in ['channels_first', 'channels_last']!")
    if fill_mode not in ("CONSTANT", "NEAREST_NEIGHBOR", "BILINEAR", "BICUBIC"):
        raise Exception(
            "fill_mode must in ['CONSTANT', 'NEAREST_NEIGHBOR', 'BILINEAR', 'BICUBIC']!")
    if zoom_size is not None:
        if not (zoom_size[0] >= output_shape[0] and zoom_size[1] >= output_shape[1]):
            raise Exception("output_shape can't greater that zoom_size!")
        if crop_method not in ("random", "center"):
            raise Exception("crop_method must in ['random', 'center']!")
    if color_jitter_prob is not None and not 0.0 <= color_jitter_prob <= 1.0:
        raise Exception("color_jitter_prob must be in [0, 1]")
    if flip_prob is not None and not (0.0 <= flip_prob[0] <= 1.0
                                      and 0.0 <= flip_prob[1] <= 1.0):
        raise Exception("flip_prob must be in [0, 1]")
    if rotate is not None:
        if len(rotate) != 3:
            raise Exception(
                'please provide "rotate" parameter as [rotate_prob, min_angle, max_angle]!')
        if not 0.0 <= rotate[0] <= 1.0:
            raise Exception("rotate prob must be in [0, 1]")
        if ground_truth is not None and not (-5.0 <= rotate[1] and rotate[2] <= 5.0):
            raise Exception("rotate range must be -5 to 5 degrees with ground truth")
        if rotate[1] > rotate[2]:
            raise Exception("rotate[1] can't be greater than rotate[2]")

    rng = rng or np.random.default_rng()
    image = np.asarray(image, np.float32)
    if data_format == "channels_first":
        image = image.transpose(1, 2, 0)
    input_h, input_w = int(input_shape[0]), int(input_shape[1])
    output_h, output_w = int(output_shape[0]), int(output_shape[1])
    out_hf, out_wf = float(output_h), float(output_w)

    orig_image = image
    if ground_truth is not None:
        gt = np.asarray(ground_truth, np.float32)
        ymin, ymax = gt[:, 0].copy(), gt[:, 1].copy()
        xmin, xmax = gt[:, 2].copy(), gt[:, 3].copy()
        class_id = gt[:, 4].copy()
        orig_center = np.stack([(ymin + ymax) / 2, (xmin + xmax) / 2,
                                ymax - ymin, xmax - xmin, class_id], -1)

    if fill_mode == "CONSTANT":
        keep_aspect_ratios = True
    zoom_h, zoom_w = (zoom_size if zoom_size is not None else output_shape)
    zoom_h, zoom_w = int(zoom_h), int(zoom_w)

    if keep_aspect_ratios:
        if fill_mode != "CONSTANT":
            ratio = min(zoom_h / input_h, zoom_w / input_w)
            if zoom_h / input_h < zoom_w / input_w:
                rh, rw = zoom_h, int(input_w * ratio)
            else:
                rh, rw = int(input_h * ratio), zoom_w
            image = _resize_align_corners(image, rh, rw, fill_mode)
            if ground_truth is not None:
                ymin, ymax = ymin * ratio, ymax * ratio
                xmin, xmax = xmin * ratio, xmax * ratio
            pad = np.full((zoom_h, zoom_w, image.shape[2]), constant_values, np.float32)
            pad[:rh, :rw] = image
            image = pad
        else:
            pad = np.full((zoom_h, zoom_w, image.shape[2]), constant_values, np.float32)
            pad[:input_h, :input_w] = image
            image = pad
    else:
        image = _resize_align_corners(image, zoom_h, zoom_w, fill_mode)
        if ground_truth is not None:
            ry, rx = zoom_h / input_h, zoom_w / input_w
            ymin, ymax = ymin * ry, ymax * ry
            xmin, xmax = xmin * rx, xmax * rx

    if zoom_size is not None:
        if crop_method == "random":
            rh_range, rw_range = zoom_h - output_h, zoom_w - output_w
            crop_h = int(rng.integers(0, rh_range)) if rh_range > 0 else 0
            crop_w = int(rng.integers(0, rw_range)) if rw_range > 0 else 0
        else:
            crop_h = (zoom_h - output_h) // 2
            crop_w = (zoom_w - output_w) // 2
        image = image[crop_h:crop_h + output_h, crop_w:crop_w + output_w]
        if ground_truth is not None:
            ymin, ymax = ymin - crop_h, ymax - crop_h
            xmin, xmax = xmin - crop_w, xmax - crop_w

    if flip_prob is not None:
        td, lr = rng.uniform(), rng.uniform()
        if td < flip_prob[0]:
            image = image[::-1]
            if ground_truth is not None:
                ymin, ymax = out_hf - ymax - 1.0, out_hf - ymin - 1.0
        if lr < flip_prob[1]:
            image = image[:, ::-1]
            if ground_truth is not None:
                xmin, xmax = out_wf - xmax - 1.0, out_wf - xmin - 1.0

    if color_jitter_prob is not None:
        bcs = rng.uniform(size=3)
        if bcs[0] < color_jitter_prob:
            image = image + rng.uniform(0.0, 0.3)
        if bcs[1] < color_jitter_prob:
            factor = rng.uniform(0.8, 1.2)
            mean = image.mean(axis=(0, 1), keepdims=True)
            image = (image - mean) * factor + mean
        if bcs[2] < color_jitter_prob:
            delta = rng.uniform(-0.1, 0.1)
            h, s, v = _rgb_to_hsv(image)
            image = _hsv_to_rgb(h + delta, s, v)

    if rotate is not None:
        if rng.uniform() < rotate[0]:
            ang = rng.uniform(rotate[1], rotate[2]) * 3.1415926 / 180.0
            image = _rotate_image(image, ang)
            if ground_truth is not None:
                ymin, xmin, ymax, xmax = _rotate_boxes(ymin, xmin, ymax, xmax,
                                                       ang, out_hf, out_wf)

    if ground_truth is not None:
        ymin = np.clip(ymin, 0.0, out_hf - 1.0)
        xmin = np.clip(xmin, 0.0, out_wf - 1.0)
        ymax = np.clip(ymax, 0.0, out_hf - 1.0)
        xmax = np.clip(xmax, 0.0, out_wf - 1.0)
        yc, xc = (ymin + ymax) / 2.0, (xmin + xmax) / 2.0
        keep = (yc > 0.0) & (yc < out_hf - 1.0) & (xc > 0.0) & (xc < out_wf - 1.0)
        gt_out = np.stack([yc, xc, ymax - ymin, xmax - xmin, class_id], -1)[keep]
        if gt_out.shape[0] == 0:
            # zero-box fallback (image_augmentor.py:219-224, 263-267)
            image = _resize_plain(orig_image, output_h, output_w)
            fact = np.asarray([out_hf / input_h, out_wf / input_w,
                               out_hf / input_h, out_wf / input_w, 1.0], np.float32)
            gt_out = orig_center * fact
        if pad_truth_to is not None:
            padded = -np.ones((pad_truth_to, 5), np.float32)
            n = min(pad_truth_to, gt_out.shape[0])
            padded[:n] = gt_out[:n]
            gt_out = padded
        if data_format == "channels_first":
            image = image.transpose(2, 0, 1)
        return image.astype(np.float32), gt_out.astype(np.float32)

    if data_format == "channels_first":
        image = image.transpose(2, 0, 1)
    return image.astype(np.float32)
