"""RetinaNet (counterpart of ``tpudet/models/retinanet.py``), with the ImageNet
backbone-pretraining mode.

Extra config keys beyond the common set: ``data_shape`` (``[h, w, 3]``, or
``[3, h, w]`` for channels_first), ``is_bottleneck``, ``residual_block_list``,
``init_conv_filters``, ``is_pretraining``, ``alpha``, ``gamma``. Stage widths
are ``7 * 2^i`` (quirk Q7). In pretraining mode the "logits" are the float32
global mean of the last stage (as many as that stage's channels: 224 with the
bottleneck), trained with softmax cross-entropy on integer labels.

The backbone and FPN live under ``feature_extractor``, so a pretraining
checkpoint and a detection model share the backbone's names
(:meth:`RetinaNet.load_pretraining_weight`).
"""

from __future__ import annotations

import math
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from tpudet_torch.heads import retina as retina_head
from tpudet_torch.heads import ssd as ssd_head
from tpudet_torch.models.base import DetectorBase, data_shape_hw
from tpudet_torch.nn.backbones.resnet import PreActResNet
from tpudet_torch.nn.necks.fpn import RetinaFPN
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.runtime import checkpoint as ckpt
from tpudet_torch.runtime import mesh as mesh_lib
from tpudet_torch.runtime import transfer


class _RetinaExtractor(nn.Module):
    """The backbone, and the FPN unless ``with_fpn`` is False."""

    def __init__(self, block_list, init_conv_filters: int, is_bottleneck: bool,
                 with_fpn: bool = True, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = PreActResNet(block_list, init_conv_filters, 7, is_bottleneck,
                                     generator, dtype)
        self.fpn = (RetinaFPN(self.backbone.out_channels, generator=generator,
                              dtype=dtype) if with_fpn else None)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        if self.fpn is None:
            return c5
        return self.fpn(c3, c4, c5)


class RetinaDetectionNet(nn.Module):
    """Returns ``[(predc, predr)]`` for P3..P7, NCHW, in ``dtype``."""

    def __init__(self, num_classes_total: int, block_list, init_conv_filters: int,
                 is_bottleneck: bool, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_extractor = _RetinaExtractor(block_list, init_conv_filters,
                                                  is_bottleneck, True, generator, dtype)
        self.regressor = retina_head.RetinaSubnets(5, num_classes_total,
                                                   generator=generator, dtype=dtype)

    def forward(self, x):
        return self.regressor(self.feature_extractor(x))


class RetinaPretrainNet(nn.Module):
    """The backbone alone; the float32 global mean of its last stage."""

    def __init__(self, block_list, init_conv_filters: int, is_bottleneck: bool,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feature_extractor = _RetinaExtractor(block_list, init_conv_filters,
                                                  is_bottleneck, False, generator, dtype)

    def forward(self, x):
        return torch.mean(self.feature_extractor(x).float(), dim=(2, 3))


def _stage_shapes(h: int, w: int, num_stages: int):
    """Feature sizes of the stages under SAME padding: /4 after the stem and
    the pool, then /2 a stage."""
    hh, ww = math.ceil(h / 2), math.ceil(w / 2)
    hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
    out = [(hh, ww)]
    for _ in range(num_stages - 1):
        hh, ww = math.ceil(hh / 2), math.ceil(ww / 2)
        out.append((hh, ww))
    return out


def pyramid_shapes(h: int, w: int, num_stages: int):
    """P3..P7 sizes: the last three stages, then two stride-2 levels."""
    p3, p4, p5 = _stage_shapes(h, w, num_stages)[-3:]
    p6 = (math.ceil(p5[0] / 2), math.ceil(p5[1] / 2))
    p7 = (math.ceil(p6[0] / 2), math.ceil(p6[1] / 2))
    return [p3, p4, p5, p6, p7]


class RetinaNet(DetectorBase):
    def __init__(self, config, data_provider=None, device=None):
        self.data_shape_hw = data_shape_hw(config)
        self.is_pretraining = bool(config.get("is_pretraining", False))
        self.alpha = float(config.get("alpha", 0.25))
        self.gamma = float(config.get("gamma", 2.0))
        super().__init__(config, data_provider, device)

    def _build(self):
        cfg = self.config
        kwargs = dict(block_list=tuple(cfg["residual_block_list"]),
                      init_conv_filters=cfg.get("init_conv_filters", 16),
                      is_bottleneck=bool(cfg["is_bottleneck"]),
                      generator=self.generator, dtype=self.compute_dtype)
        if self.is_pretraining:
            self.net = RetinaPretrainNet(**kwargs)
            return
        self.net = RetinaDetectionNet(self.num_classes, **kwargs)
        h, w = self.data_shape_hw
        self.anchors = retina_head.build_anchors(
            h, pyramid_shapes(h, w, len(cfg["residual_block_list"])), device=self.device)

    # ------------------------------------------------------ detection hooks
    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        if self.is_pretraining:
            return loss_ops.weighted_mean(loss_ops.softmax_cross_entropy(outputs, gt))
        pconf, pyx, phw = retina_head.flatten_preds(outputs, self.num_classes)
        return retina_head.retina_loss(pconf, pyx, phw, self.anchors, gt,
                                       self.num_classes, self.alpha, self.gamma,
                                       sample_weight=sample_weight)

    def _decode_outputs(self, outputs):
        pconf, pyx, phw = retina_head.flatten_preds(outputs, self.num_classes)
        return ssd_head.ssd_decode(
            pconf[0], pyx[0], phw[0], self.anchors,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes)

    # ------------------------------------------------------ pretraining mode
    def _to_device(self, images, gt):
        if not self.is_pretraining:
            return super()._to_device(images, gt)
        images, gt = self._fit_host_batch(images, np.asarray(gt))
        labels = torch.from_numpy(np.ascontiguousarray(gt, np.int64))
        return self._images_to_device(images), labels.to(self.device)

    def train_step(self, images, gt, lr):
        """Detection: as :meth:`DetectorBase.train_step`. Pretraining: ``gt``
        holds integer labels and the step returns ``(loss, accuracy)`` as
        device scalars."""
        if not self.is_pretraining:
            return super().train_step(images, gt, lr)
        self.net.train()
        params = dict(self.net.named_parameters())
        with mesh_lib.over(self.mesh):
            logits = self.net(self._preprocess(images))
            loss = self._loss_from_outputs(logits, gt)
            acc = loss_ops.weighted_mean(
                (torch.argmax(logits.detach(), -1) == gt).to(torch.float32))
        grads, loss, (acc,) = self._step_grads(loss, params, acc)
        self._optimizer.update(dict(zip(params, grads)), self.opt_state, params, lr)
        self.global_step += 1
        return loss, acc

    def train_one_epoch(self, lr, writer=None):
        """Detection: the epoch's mean loss. Pretraining: ``(mean loss, mean
        accuracy)`` over ``num_train // batch_size`` steps."""
        if not self.is_pretraining:
            return super().train_one_epoch(lr, writer)
        if callable(self.train_initializer):
            self.train_initializer()
        num_iters = self.num_train // self.batch_size
        losses, accs = [], []
        for i in range(num_iters):
            images, labels = next(self.train_iterator)
            loss, acc = self.train_step(*self._to_device(images, labels), lr)
            losses.append(float(loss))
            accs.append(float(acc))
            if writer is not None:
                writer.add_summary(loss, global_step=self.global_step)
            sys.stdout.write(f"\r>> iters {i + 1}/{num_iters} loss {losses[-1]}")
            sys.stdout.flush()
        sys.stdout.write("\n")
        return float(np.mean(losses)), float(np.mean(accs))

    @torch.inference_mode()
    def test_one_image(self, images):
        """Detection: ``[scores, boxes, class_id]``. Pretraining: the argmax
        class of each image, as a numpy array."""
        if not self.is_pretraining:
            return super().test_one_image(images)
        self.net.eval()
        x = self._images_to_device(np.ascontiguousarray(images, np.float32),
                                   np.float32)
        return torch.argmax(self.net(self._preprocess(x)), -1).cpu().numpy()

    def save_weight(self, mode, path):
        """Pretraining saves the ``feature_extractor`` subtree and the step
        only (as tpudet does); detection saves everything. Rank 0 writes and
        the others wait."""
        if not self.is_pretraining:
            return super().save_weight(mode, path)
        if mode not in ("latest", "best"):
            raise ValueError(f"mode must be 'latest' or 'best', got {mode!r}")
        if self.mesh.rank == 0:
            state = {"state_dict": {k: v for k, v in self.net.state_dict().items()
                                    if k.startswith("feature_extractor.")},
                     "global_step": self.global_step}
            fname = ckpt.save_state(path, state, self.global_step)
            print(">> save", mode, "model in", fname, "successfully")
        mesh_lib.barrier(self.mesh, self.device)

    def load_pretraining_weight(self, path):
        """Copy the backbone's parameters and BatchNorm statistics from a
        pretraining checkpoint: tpudet's ``.tpudet`` or the port's ``.pt``
        (an exact file, a ``path-step`` prefix or a bare prefix). The FPN and
        the subnets keep theirs."""
        fname = ckpt.resolve(path)
        blob = ckpt.load_state(fname)
        if fname.endswith(ckpt.TPUDET_SUFFIX):
            fe = {c: {"feature_extractor": {
                "backbone": blob[c]["feature_extractor"]["backbone"]}}
                for c in ("params", "batch_stats")}
            state = transfer.from_flax(fe)
        else:
            state = blob["state_dict"]
        backbone = transfer.subtree(state, "feature_extractor.backbone")
        self.net.feature_extractor.backbone.load_state_dict(backbone, strict=True)
        print(">> load pretraining weight", fname, "successfully")
