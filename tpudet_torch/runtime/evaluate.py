"""Detection evaluation: Pascal VOC mAP (07 11-point and area-under-curve metrics);
counterpart of ``tpudet/runtime/evaluate.py``.

The reference ships no evaluation at all (SURVEY.md §4); this supplies the VOC07 mAP
protocol named as the primary metric in BASELINE.md, operating on the
``test_one_image`` output contract ``[scores, boxes(y1x1y2x2), class_id]``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from tpudet_torch.data.augment import _resize_align_corners


def _iou_single(box, boxes):
    y1 = np.maximum(box[0], boxes[:, 0])
    x1 = np.maximum(box[1], boxes[:, 1])
    y2 = np.minimum(box[2], boxes[:, 2])
    x2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-12)


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = True):
    """AP from a PR curve; 11-point interpolation for the VOC07 protocol."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_detections(
    detections: Dict[int, List[Tuple[float, np.ndarray, int]]],
    ground_truths: Dict[int, np.ndarray],
    num_classes: int,
    iou_threshold: float = 0.5,
    use_07_metric: bool = True,
):
    """Compute per-class AP + mAP.

    Args:
      detections: image_id -> list of (score, box[y1x1y2x2], class_id).
      ground_truths: image_id -> [N, 5] rows [y1, x1, y2, x2, class_id].
      num_classes: number of foreground classes.

    Returns (mAP, {class_id: AP}).
    """
    aps = {}
    for c in range(num_classes):
        records = []
        npos = 0
        gt_per_image = {}
        for img, gts in ground_truths.items():
            sel = gts[gts[:, 4] == c][:, :4]
            gt_per_image[img] = (sel, np.zeros(len(sel), bool))
            npos += len(sel)
        for img, dets in detections.items():
            for score, box, cid in dets:
                if cid == c:
                    records.append((float(score), img, np.asarray(box, np.float64)))
        if npos == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for i, (score, img, box) in enumerate(records):
            gts, used = gt_per_image.get(img, (np.zeros((0, 4)), np.zeros(0, bool)))
            if len(gts) == 0:
                fp[i] = 1
                continue
            ious = _iou_single(box, gts)
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold and not used[j]:
                tp[i] = 1
                used[j] = True
            else:
                fp[i] = 1
        tp = np.cumsum(tp)
        fp = np.cumsum(fp)
        recall = tp / npos
        precision = tp / np.maximum(tp + fp, 1e-12)
        aps[c] = voc_ap(recall, precision, use_07_metric)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return mAP, aps


def eval_preprocess(image: np.ndarray, out_h: int, out_w: int,
                    keep_aspect_ratios: bool = False, fill_mode: str = "BILINEAR",
                    constant_values: float = 0.0):
    """Deterministic test-time preprocessing matching the training augmentor's
    geometry (image_augmentor.py:88-129: keep-aspect resize-and-pad, CONSTANT
    top-left placement, or plain align-corners resize).

    Returns ``(input_image [out_h, out_w, 3], unmap)`` where ``unmap(boxes)`` maps
    predicted ``[N, 4]`` y1x1y2x2 boxes in input pixels back to original pixels.
    """
    h, w = image.shape[:2]
    if fill_mode == "CONSTANT":
        keep_aspect_ratios = True
    if keep_aspect_ratios and fill_mode == "CONSTANT" and h <= out_h and w <= out_w:
        canvas = np.full((out_h, out_w, image.shape[2]), constant_values, np.float32)
        canvas[:h, :w] = image
        return canvas, lambda boxes: boxes
    if keep_aspect_ratios and fill_mode != "CONSTANT":
        ratio = min(out_h / h, out_w / w)
        if out_h / h < out_w / w:
            rh, rw = out_h, int(w * ratio)
        else:
            rh, rw = int(h * ratio), out_w
        resized = _resize_align_corners(image, rh, rw, fill_mode)
        canvas = np.full((out_h, out_w, image.shape[2]), constant_values, np.float32)
        canvas[:rh, :rw] = resized
        return canvas, lambda boxes: boxes / ratio
    mode = fill_mode if fill_mode != "CONSTANT" else "BILINEAR"
    resized = _resize_align_corners(image, out_h, out_w, mode)
    sy, sx = h / out_h, w / out_w
    scale = np.asarray([sy, sx, sy, sx], np.float64)
    return resized, lambda boxes: boxes * scale


def evaluate_model(model, records, use_07_metric: bool = True,
                   iou_threshold: float = 0.5, preprocess_config=None):
    """End-to-end eval loop over parsed VOC records.

    ``records``: iterable of (image [H,W,3] float, gt_corner [N,5]
    rows [ymin, ymax, xmin, xmax, class_id] — the raw VOC record layout).

    ``preprocess_config``: the model's ``image_augmentor_config`` dict (or any dict
    with ``keep_aspect_ratios`` / ``fill_mode`` / ``constant_values``) so evaluation
    preprocessing matches the training distribution — keep-aspect models
    (the reference FCOS/LH-RCNN driver configs) would otherwise be evaluated on
    stretched inputs. With None, plain align-corners bilinear resize is used.
    """
    cfg = preprocess_config or {}
    dets, gts = {}, {}
    h_in, w_in = model._data_shape_nhwc()[:2]
    for i, (image, gt) in enumerate(records):
        inp, unmap = eval_preprocess(
            image, h_in, w_in,
            keep_aspect_ratios=bool(cfg.get("keep_aspect_ratios", False)),
            fill_mode=cfg.get("fill_mode", "BILINEAR"),
            constant_values=float(cfg.get("constant_values", 0.0)))
        scores, boxes, cids = model.test_one_image(inp[None])
        dets[i] = [
            (s, np.asarray(unmap(np.asarray(b, np.float64))), int(c))
            for s, b, c in zip(scores, boxes, cids)
        ]
        # gt rows [ymin, ymax, xmin, xmax, cid] -> [y1, x1, y2, x2, cid]
        gts[i] = np.stack([gt[:, 0], gt[:, 2], gt[:, 1], gt[:, 3], gt[:, 4]], -1)
    nc = getattr(model, "raw_classes", None) or (model.num_classes - 1)
    return evaluate_detections(dets, gts, nc, iou_threshold, use_07_metric)
