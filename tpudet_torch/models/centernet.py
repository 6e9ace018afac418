"""CenterNet (counterpart of ``tpudet/models/centernet.py``).

Beyond the common skeleton: ``input_size`` (square), the input is ``x / 255``
normalised by ImageNet's mean and standard deviation, the optimizer is
TF-style Adam, test mode needs ``score_threshold`` and
``top_k_results_output`` (train mode defaults them to 0.1 and 100), and
decode takes the ``top_k`` heatmap peaks with no box NMS, so no kernel runs
in a step or a request. ``num_classes`` counts no background class.
``load_pretrained_weight`` (tpudet's spelling) restores the ``backone``
scope's parameters.
"""

from __future__ import annotations

import torch

from tpudet_torch.heads import centernet as center_head
from tpudet_torch.models.base import DetectorBase
from tpudet_torch.runtime import optim

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class CenterNet(DetectorBase):
    def __init__(self, config, data_provider=None, device=None):
        self.input_size = int(config["input_size"])
        if config["mode"] == "test":
            self.score_threshold = config["score_threshold"]
            self.top_k_results_output = config["top_k_results_output"]
        else:
            self.score_threshold = config.get("score_threshold", 0.1)
            self.top_k_results_output = config.get("top_k_results_output", 100)
        super().__init__(config, data_provider, device)
        self.num_classes = config["num_classes"]  # no background channel
        self._std = torch.tensor(IMAGENET_STD, device=self.device).reshape(1, 3, 1, 1)

    def _build(self):
        self.raw_classes = self.config["num_classes"]
        self.net = center_head.CenterNetNet(self.raw_classes, generator=self.generator,
                                            dtype=self.compute_dtype)

    def _make_optimizer(self):
        return optim.Adam()

    def _pixel_mean(self):
        """ImageNet's mean, of images scaled to [0, 1]."""
        return torch.tensor(IMAGENET_MEAN, dtype=torch.float32)

    def _preprocess(self, images):
        return (images / 255.0 - self._mean) / self._std

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        return center_head.centernet_loss(*outputs, gt, self.raw_classes,
                                          sample_weight=sample_weight)

    def _decode_outputs(self, outputs):
        keypoints, offset, size = (t[0] for t in outputs)
        return center_head.centernet_decode(keypoints, offset, size, self.score_threshold,
                                            int(self.top_k_results_output))

    def load_pretrained_weight(self, path: str):
        """Restore the ``backone`` scope's parameters (its BatchNorm
        statistics stay, as in tpudet) from tpudet's ``.tpudet`` or the port's
        ``.pt`` (an exact file, a ``path-step`` prefix or a bare prefix)."""
        fname = self._load_scopes(path, ("backone",), with_stats=False)
        print("load pretrained weight", fname, "successfully")
