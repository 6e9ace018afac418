"""Light-Head R-CNN (counterpart of ``tpudet/models/lhrcnn.py``).

Config keys beyond the common set: ``data_shape`` (``[h, w, 3]``, or ``[3, h,
w]`` for channels_first; the training script's is 700x1100), the phase
schedule ``rpn_first_step``, ``rcnn_first_step`` and ``rpn_second_step``, and
``post_nms_proposal`` (default 500).

Training alternates two phases by ``global_step`` (taken before the step):
the RPN phase (``step < rpn_first_step``, or ``rcnn_first_step <= step <
rpn_second_step``) differentiates ``rpn_loss + wd * l2(feature_extractor,
rpn)`` and updates only those scopes' parameters and Momentum velocities;
the RCNN phase differentiates ``rcnn_loss + wd * l2(rcnn)`` and updates only
``rcnn``'s. The other scopes stay bit for bit, as tpudet's ``where``-masked
update leaves them. Every BatchNorm runs in train mode in both phases, so
all running statistics move every step. Each phase computes only what its
loss reads: the RPN phase skips the RoI crop and head, and the RCNN phase
runs the trunk and the RPN without autograd (its loss's gradient reaches
only ``rcnn``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tpudet_torch.heads import lhrcnn as lh
from tpudet_torch.models.base import DetectorBase, data_shape_hw
from tpudet_torch.nn.layers import ConvBN
from tpudet_torch.ops import losses as loss_ops
from tpudet_torch.runtime import mesh as mesh_lib

RPN_SCOPES = ("feature_extractor", "rpn")
RCNN_SCOPES = ("rcnn",)
NUM_ANCHORS = len(lh.ANCHOR_SCALES) * len(lh.ANCHOR_RATIOS)


class _RPNHead(nn.Module):
    def __init__(self, in_ch, generator, dtype):
        super().__init__()
        self.rpn_conv = ConvBN(in_ch, 256, 3, activation=torch.relu, generator=generator,
                               dtype=dtype)
        self.rpn_conf = ConvBN(256, NUM_ANCHORS * 2, 3, generator=generator, dtype=dtype)
        self.rpn_pbbox = ConvBN(256, NUM_ANCHORS * 4, 3, generator=generator, dtype=dtype)

    def forward(self, c4):
        r = self.rpn_conv(c4)
        return self.rpn_conf(r), self.rpn_pbbox(r)


class _RCNNPart(nn.Module):
    def __init__(self, in_ch, num_classes_total, generator, dtype):
        super().__init__()
        thin = lh.THIN_CHANNELS
        self.state5_conv1_1 = lh.SeparableConvBN(in_ch, 256, (1, 15), generator, dtype)
        self.state5_conv1_2 = lh.SeparableConvBN(256, thin, (15, 1), generator, dtype)
        self.state5_conv2_1 = lh.SeparableConvBN(in_ch, 256, (1, 15), generator, dtype)
        self.state5_conv2_2 = lh.SeparableConvBN(256, thin, (15, 1), generator, dtype)
        self.head = lh.RoIHead(num_classes_total, thin, generator, dtype)

    def thin_feature(self, c4):
        b1 = self.state5_conv1_2(self.state5_conv1_1(c4))
        b2 = self.state5_conv2_2(self.state5_conv2_1(c4))
        return b1 + b2


class LHRCNNNet(nn.Module):
    """The trunk, the RPN head and the thin feature map: ``forward(x)`` gives
    NCHW ``(rpn_conf [B, 30, h, w], rpn_loc [B, 60, h, w], rcnn_feat [B, 490,
    h, w])``; :meth:`roi_head` takes channels-last crops."""

    def __init__(self, num_classes_total: int, generator=None, dtype=torch.float32):
        super().__init__()
        self.feature_extractor = lh.XceptionLite(generator, dtype)
        self.rpn = _RPNHead(576, generator, dtype)
        self.rcnn = _RCNNPart(576, num_classes_total, generator, dtype)

    def forward(self, x):
        c4 = self.feature_extractor(x)
        rpn_conf, rpn_loc = self.rpn(c4)
        return rpn_conf, rpn_loc, self.rcnn.thin_feature(c4)

    def roi_head(self, feats):
        return self.rcnn.head(feats)


class LHRCNN(DetectorBase):
    # tpudet's LH-RCNN augments inside its step always and ignores
    # device_augment_split
    NO_SCAN_KEYS = ("no_scan_epoch",)

    def __init__(self, config, data_provider=None, device=None):
        self.data_shape_hw = data_shape_hw(config)
        self.rpn_first_step = int(config["rpn_first_step"])
        self.rcnn_first_step = int(config["rcnn_first_step"])
        self.rpn_second_step = int(config["rpn_second_step"])
        self.post_nms_proposal = int(config.get("post_nms_proposal", 500))
        super().__init__(config, data_provider, device)

    def _build(self):
        self.net = LHRCNNNet(self.num_classes, self.generator, self.compute_dtype)
        h, w = self.data_shape_hw
        self.anchors, keep = lh.build_anchors(math.ceil(h / 32), math.ceil(w / 32), 32.0,
                                              h, w, device=self.device)
        self._keep_idx = torch.from_numpy(np.flatnonzero(keep)).to(self.device)

    def _preprocess(self, images):
        return images / 127.5 - 1.0

    def _split_rpn(self, rpn_conf, rpn_loc):
        """NCHW head maps -> float32 ``(pyx, phw [B, A, 2], pconf [B, A, 2])``
        over the kept anchors, numbered (row, column, prior) as flax's NHWC
        reshape numbers them."""
        b = rpn_conf.shape[0]

        def kept(t, k):  # index_select: its backward is an index_add
            return t.permute(0, 2, 3, 1).reshape(b, -1, k).float().index_select(
                1, self._keep_idx)

        loc = kept(rpn_loc, 4)
        return loc[..., :2], loc[..., 2:], kept(rpn_conf, 2)

    def is_rpn_step(self, step: int) -> bool:
        """Whether ``step`` (a ``global_step`` before its step) trains the RPN."""
        return step < self.rpn_first_step or (
            self.rcnn_first_step <= step < self.rpn_second_step)

    def phase_loss(self, images, gt, rpn_phase: bool):
        """The phase's loss without weight decay, from a train-mode forward
        of the whole net (every BatchNorm's statistics move)."""
        net = self.net.train()
        x = self._preprocess(images)
        with torch.set_grad_enabled(rpn_phase):
            c4 = net.feature_extractor(x)
            rpn_conf, rpn_loc = net.rpn(c4)
        with torch.set_grad_enabled(not rpn_phase):
            rcnn_feat = net.rcnn.thin_feature(c4)
        sample = lh.rpn_loss_and_sample(*self._split_rpn(rpn_conf, rpn_loc), self.anchors,
                                        gt)
        sample_weight = self._sample_weight()
        if rpn_phase:
            return loss_ops.weighted_mean(sample.rpn_loss, sample_weight)
        h, w = self.data_shape_hw
        return lh.rcnn_losses(net.roi_head, rcnn_feat, sample, float(h), float(w),
                              self.num_classes, sample_weight=sample_weight)

    def train_step(self, images: torch.Tensor, gt: torch.Tensor, lr: float):
        """One step of the phase ``global_step`` falls in: the device
        augmentation (with ``device_augment``), its loss plus
        ``weight_decay`` times the l2 of its scopes, the reduction over the
        ranks (:meth:`DetectorBase._step_grads`), and Momentum on those
        scopes alone. Returns the global loss as a device scalar."""
        images, gt = self._device_augment(images, gt, self.global_step)
        rpn_phase = self.is_rpn_step(self.global_step)
        scopes = RPN_SCOPES if rpn_phase else RCNN_SCOPES
        params = {k: p for k, p in self.net.named_parameters()
                  if k.split(".", 1)[0] in scopes}
        with mesh_lib.over(self.mesh):
            loss = self.phase_loss(images, gt, rpn_phase)
        grads, loss, _ = self._step_grads(loss, params)
        self._optimizer.update(dict(zip(params, grads)), self.opt_state, params, lr)
        self.global_step += 1
        return loss

    def _loss_label(self) -> str:
        # tpudet names the loss by the phase of global_step AFTER the step
        return "rpn_loss" if self.is_rpn_step(self.global_step) else "rcnn_loss"

    def _decode_outputs(self, outputs):
        rpn_conf, rpn_loc, rcnn_feat = outputs
        pyx, phw, pconf = self._split_rpn(rpn_conf, rpn_loc)
        h, w = self.data_shape_hw
        return lh.lhrcnn_decode(
            self.net.roi_head, rcnn_feat[0].float(), pyx[0], phw[0], pconf[0],
            self.anchors, float(h), float(w), self.num_classes, self.post_nms_proposal,
            self.nms_score_threshold, self.nms_iou_threshold, self.nms_max_boxes)

    def load_rpn_weight(self, path: str):
        """Restore the RPN stage (``feature_extractor`` and ``rpn``: parameters
        and BatchNorm statistics) from tpudet's ``.tpudet`` or the port's
        ``.pt`` (an exact file, a ``path-step`` prefix or a bare prefix)."""
        fname = self._load_scopes(path, RPN_SCOPES, with_stats=True)
        print(">> load rpn weight", fname, "successfully")

    def load_pretraining_weight(self, path: str):
        """Restore the ``feature_extractor`` scope's parameters."""
        fname = self._load_scopes(path, ("feature_extractor",), with_stats=False)
        print(">> load pretraining weight", fname, "successfully")
