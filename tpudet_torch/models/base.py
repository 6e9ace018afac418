"""DetectorBase: the shared model lifecycle (counterpart of
``tpudet/models/base.py``), serving only in this slice.

Config keys as in tpudet: mode, data_format, num_classes, weight_decay,
keep_prob (accepted, unused), batch_size, nms_score_threshold, nms_max_boxes,
nms_iou_threshold, pretraining_weight, compute_dtype, seed. ``mode: "train"``
and ``compute_dtype: "bfloat16"`` raise ``NotImplementedError``: they come
with the SSD training slice of the port.

Weights are initialised from a ``torch.Generator`` seeded with the config's
``seed`` on the CPU and then moved to the model's device, so a seed gives the
same weights on every device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from tpudet_torch import device as device_lib
from tpudet_torch.runtime import checkpoint as ckpt
from tpudet_torch.runtime import config as config_lib

_NEXT_SLICE = ("the SSD training slice of the port (ssd_loss, train-mode "
               "BatchNorm, Momentum, bf16)")


class DetectorBase:
    """Subclasses set ``input_size`` and implement ``_build`` (create
    ``self.net`` from ``self.generator`` and any static tables) and
    ``_decode_outputs``, and optionally ``_load_pretraining``.

    ``data_provider`` is accepted for tpudet's ``Model(config, data_provider)``
    signature; serving does not read it."""

    input_size: int = None

    def __init__(self, config: Dict[str, Any], data_provider: Optional[Dict] = None,
                 device: str | torch.device | None = None):
        model_name = type(self).__name__
        config_lib.validate(
            config, model_name if model_name in config_lib._MODEL_REQUIRED else None)
        if config["mode"] == "train":
            raise NotImplementedError(f"mode 'train' comes with {_NEXT_SLICE}")
        if config.get("compute_dtype", "float32") == "bfloat16":
            raise NotImplementedError(f"compute_dtype 'bfloat16' comes with {_NEXT_SLICE}")
        self.device = device_lib.resolve(device)
        self.config = config
        self.data_format = config["data_format"]
        self.num_classes = config["num_classes"] + 1  # + background
        self.nms_score_threshold = config.get("nms_score_threshold", 0.5)
        self.nms_max_boxes = config.get("nms_max_boxes", 20)
        self.nms_iou_threshold = config.get("nms_iou_threshold", 0.5)
        self.global_step = 0
        self.generator = torch.Generator().manual_seed(int(config.get("seed", 0)))

        self._build()
        self._load_pretraining()
        self.net.to(self.device).eval()
        self._mean = self._pixel_mean().to(self.device).reshape(1, 3, 1, 1)

    # ------------------------------------------------------------- hooks
    def _build(self):
        raise NotImplementedError

    def _decode_outputs(self, outputs):
        """Single-image decode: outputs -> (scores, boxes, class_id, valid)."""
        raise NotImplementedError

    def _load_pretraining(self):
        pass

    def _pixel_mean(self):
        """Per-channel RGB mean; 103.979 is the reference's value."""
        return torch.tensor([123.68, 116.779, 103.979], dtype=torch.float32)

    def _preprocess(self, images):
        """NCHW float32 images minus the pixel mean."""
        return images - self._mean

    # ------------------------------------------------------------ public API
    @torch.inference_mode()
    def test_one_image(self, images):
        """images: ``[1, H, W, 3]`` (or ``[1, 3, H, W]`` for channels_first).
        Returns ``[scores, bbox (y1x1y2x2 pixels), class_id]`` as numpy arrays
        with padding stripped."""
        images = np.ascontiguousarray(images, np.float32)
        if self.data_format == "channels_last":
            images = images.transpose(0, 3, 1, 2)  # the net runs NCHW
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        outputs = self.net(self._preprocess(x))
        scores, bbox, cid, valid = self._decode_outputs(outputs)
        valid = valid.cpu().numpy()
        return [scores.cpu().numpy()[valid], bbox.cpu().numpy()[valid],
                cid.cpu().numpy()[valid]]

    def save_weight(self, mode: str, path: str):
        if mode not in ("latest", "best"):
            raise ValueError(f"mode must be 'latest' or 'best', got {mode!r}")
        state = {"state_dict": self.net.state_dict(), "global_step": self.global_step}
        fname = ckpt.save_state(path, state, self.global_step)
        print("save", mode, "model in", fname, "successfully")

    def load_weight(self, path: str):
        blob = ckpt.load_state(path, map_location=self.device)
        self.net.load_state_dict(blob["state_dict"], strict=True)
        self.global_step = int(blob.get("global_step", 0))
        print("load weight", path, "successfully")
