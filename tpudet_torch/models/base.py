"""DetectorBase: the shared model lifecycle (counterpart of
``tpudet/models/base.py``): training through ``train_one_epoch`` and serving
through ``test_one_image``.

Config keys as in tpudet: mode, data_format, num_classes, weight_decay,
keep_prob (accepted, unused), batch_size, nms_score_threshold, nms_max_boxes,
nms_iou_threshold, pretraining_weight, compute_dtype ("float32" or "bfloat16"),
input_dtype ("uint8" sends images to the device as bytes), loss_sync_every,
seed, and the device-resident feed's: device_augment (flips and colour
jitter inside the step, keyed as tpudet keys them), no_scan_epoch and
device_augment_split. tpudet's split moves its augmentation into a dispatch
of its own and so turns its scanned epoch off; eager PyTorch has no such
dispatch, so here the key turns the scanned epoch off as no_scan_epoch does
and the augmentation stays in the step (the same numbers). The keys of
tpudet's trainer that the port does not have yet raise
``NotImplementedError`` (:data:`UNPORTED_KEYS`).

Weights are initialised from a ``torch.Generator`` seeded with the config's
``seed`` on the CPU and then moved to the model's device, so a seed gives the
same weights on every device.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from tpudet_torch import device as device_lib
from tpudet_torch.data import device_augment, prng
from tpudet_torch.data.device_dataset import DeviceDataset
from tpudet_torch.runtime import checkpoint as ckpt
from tpudet_torch.runtime import config as config_lib
from tpudet_torch.runtime import optim
from tpudet_torch.runtime import transfer

UNPORTED_KEYS = {"dcn_size": "ROADMAP.md queue 1, data parallelism"}


def data_shape_hw(config: Dict[str, Any]):
    """``(h, w)`` of ``config["data_shape"]``: ``[h, w, 3]``, or ``[3, h, w]``
    for channels_first."""
    shape = config["data_shape"]
    if len(shape) != 3:
        raise ValueError(f"data_shape must have 3 entries, got {shape}")
    return (tuple(shape[:2]) if config["data_format"] == "channels_last"
            else tuple(shape[1:]))


def global_l2(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sum(p^2) / 2`` over every parameter (tf.nn.l2_loss summed)."""
    return sum(0.5 * torch.sum(torch.square(p.float())) for p in params)


class DetectorBase:
    """Subclasses implement ``_build`` (create ``self.net`` from
    ``self.generator`` and any static tables), ``_loss_from_outputs`` and
    ``_decode_outputs``, and optionally ``_load_pretraining``,
    ``_make_optimizer`` (Momentum 0.9 unless overridden) and
    ``_preprocess``.

    ``data_provider`` is tpudet's: ``num_train`` and ``train_generator``, either
    an ``(initializer, iterator)`` pair or an iterator with an optional
    ``reset``; it yields numpy ``(images [B, H, W, 3] or [B, 3, H, W],
    gt [B, G, 5])`` batches, or tensors already on the model's device
    (``images [B, H, W, 3]`` whatever the data format, as a
    :class:`~tpudet_torch.data.device_dataset.DeviceDataset` yields them)."""

    # the config keys that turn the scanned epoch off
    NO_SCAN_KEYS = ("no_scan_epoch", "device_augment_split")

    def __init__(self, config: Dict[str, Any], data_provider: Optional[Dict] = None,
                 device: str | torch.device | None = None):
        model_name = type(self).__name__
        config_lib.validate(
            config, model_name if model_name in config_lib._MODEL_REQUIRED else None)
        for key, item in UNPORTED_KEYS.items():
            if config.get(key):
                raise NotImplementedError(
                    f"config key {key!r} is not ported yet ({item})")
        self.device = device_lib.resolve(device)
        self.config = config
        self.mode = config["mode"]
        self.data_format = config["data_format"]
        self.num_classes = config["num_classes"] + 1  # + background
        self.weight_decay = float(config.get("weight_decay", 0.0))
        self.batch_size = config["batch_size"] if self.mode == "train" else 1
        self.nms_score_threshold = config.get("nms_score_threshold", 0.5)
        self.nms_max_boxes = config.get("nms_max_boxes", 20)
        self.nms_iou_threshold = config.get("nms_iou_threshold", 0.5)
        self.compute_dtype = (torch.bfloat16 if config.get("compute_dtype") == "bfloat16"
                              else torch.float32)
        # 'uint8' sends a quarter of the bytes to the device; the cast to
        # float32 happens there
        self.input_dtype = np.uint8 if config.get("input_dtype") == "uint8" else np.float32
        if self.mode == "train" and data_provider is not None:
            self.num_train = data_provider["num_train"]
            gen = data_provider.get("train_generator")
            if isinstance(gen, tuple):  # tpudet's (initializer, iterator) shape
                self.train_initializer, self.train_iterator = gen
            else:
                self.train_initializer = getattr(gen, "reset", None)
                self.train_iterator = gen
        self.global_step = 0
        self.generator = torch.Generator().manual_seed(int(config.get("seed", 0)))
        self._augment_key = prng.key(int(config.get("seed", 0)) ^ 0x5EED)

        self._build()
        self._load_pretraining()
        self.net.to(self.device).eval()
        self._mean = self._pixel_mean().to(self.device).reshape(1, 3, 1, 1)
        self._optimizer = self._make_optimizer()
        self.opt_state = (self._optimizer.init(dict(self.net.named_parameters()))
                          if self.mode == "train" else None)

    @property
    def velocity(self):
        """Momentum's state (``opt_state["velocity"]``), keyed like
        ``named_parameters()``; None in test mode or under Adam."""
        return None if self.opt_state is None else self.opt_state.get("velocity")

    # ------------------------------------------------------------- hooks
    def _build(self):
        raise NotImplementedError

    def _loss_from_outputs(self, outputs, gt, sample_weight=None):
        """Batch loss; ``sample_weight`` masks batch-padding rows (None: none)."""
        raise NotImplementedError

    def _decode_outputs(self, outputs):
        """Single-image decode: outputs -> (scores, boxes, class_id, valid)."""
        raise NotImplementedError

    def _load_pretraining(self):
        pass

    def _make_optimizer(self):
        return optim.Momentum(0.9)

    def _pixel_mean(self):
        """Per-channel RGB mean; 103.979 is the reference's value."""
        return torch.tensor([123.68, 116.779, 103.979], dtype=torch.float32)

    def _preprocess(self, images):
        """NCHW float32 images minus the pixel mean."""
        return images - self._mean

    def _sample_weight(self):
        """The mask of real batch rows: one device never pads the batch."""
        return None

    def _loss_label(self) -> str:
        """The loss's name on the progress line."""
        return "loss"

    def _data_shape_nhwc(self):
        """``(h, w, 3)`` of the net's input (the evaluation's resize target):
        ``data_shape_hw`` where the model has one, else the square
        ``input_size``."""
        hw = getattr(self, "data_shape_hw", None)
        if hw is not None:
            return (*hw, 3)
        return (self.input_size, self.input_size, 3)

    # ------------------------------------------------------------ training
    def _images_to_device(self, images, dtype=None):
        """numpy ``images`` (NHWC, or NCHW for channels_first) -> float32 NCHW
        images on ``self.device``, sent as ``dtype`` (default ``input_dtype``).
        The layout change and the cast to float32 happen on the device."""
        if not isinstance(images, np.ndarray):
            raise ValueError(f"a host batch must be numpy arrays, got {type(images)}")
        x = torch.from_numpy(np.ascontiguousarray(images, dtype or self.input_dtype))
        x = x.to(self.device)
        if self.data_format == "channels_last":
            x = x.permute(0, 3, 1, 2)
        return x.to(torch.float32, memory_format=torch.contiguous_format)

    def _to_device(self, images, gt):
        """numpy ``images`` and ``gt [B, G, 5]`` -> float32 NCHW images and
        float32 gt on ``self.device``. Tensors (a device-resident feed's
        batch) must already be there: NHWC images of any dtype become float32
        NCHW on the device, with no host copy."""
        if isinstance(images, torch.Tensor) or isinstance(gt, torch.Tensor):
            return self._resident_batch(images, gt)
        if not isinstance(gt, np.ndarray):
            raise ValueError(f"a host batch must be numpy arrays, got {type(gt)}")
        gt = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(self.device)
        return self._images_to_device(images), gt

    def _resident_batch(self, images, gt):
        for name, t in (("images", images), ("gt", gt)):
            if not isinstance(t, torch.Tensor) or not device_lib.same(t.device,
                                                                      self.device):
                where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
                raise ValueError(f"a device batch's {name} must be a tensor on "
                                 f"{self.device}, got {where}; it is not moved")
        if self.mode == "train" and images.shape[0] != self.batch_size:
            raise ValueError(f"the device batch has {images.shape[0]} rows; the model's "
                             f"batch_size is {self.batch_size}")
        x = images.permute(0, 3, 1, 2).to(torch.float32,
                                          memory_format=torch.contiguous_format)
        return x, gt.to(torch.float32)

    def _device_augment(self, images, gt, step: int):
        """tpudet's device augmentation (config key ``device_augment``) of
        float32 NCHW images and their gt, keyed by
        ``fold_in(key(seed ^ 0x5EED), step)``; the identity without the key."""
        cfg = self.config.get("device_augment")
        if not cfg:
            return images, gt
        return device_augment.apply(prng.fold_in(self._augment_key, step), images, gt, cfg)

    def train_step(self, images: torch.Tensor, gt: torch.Tensor, lr: float):
        """One step on a device batch: the device augmentation (with
        ``device_augment``, keyed by ``global_step``), forward in train mode
        (which updates the BN running statistics), the loss plus
        ``weight_decay * global_l2``, backward, and the optimizer. Returns the
        loss as a device scalar."""
        images, gt = self._device_augment(images, gt, self.global_step)
        self.net.train()
        params = dict(self.net.named_parameters())
        outputs = self.net(self._preprocess(images))
        loss = self._loss_from_outputs(outputs, gt, self._sample_weight())
        loss = loss + self.weight_decay * global_l2(params.values())
        grads = torch.autograd.grad(loss, list(params.values()))
        self._optimizer.update(dict(zip(params, grads)), self.opt_state, params, lr)
        self.global_step += 1
        return loss.detach()

    def train_one_epoch(self, lr, writer=None) -> float:
        """One epoch of ``num_train // batch_size`` steps; an optional ``writer``
        gets each step's loss through ``add_summary``.

        A :class:`DeviceDataset` of ``batch_size`` rows feeds the scanned
        epoch (tpudet's ``lax.scan`` over one dispatch) when the epoch has more
        than one step and no key of ``NO_SCAN_KEYS`` is set: the epoch's
        indices are drawn at once by ``scan_indices`` (a chunked dataset pins
        its next chunk first), and each step gathers its row. Else each step
        takes ``next`` of the feed. Either way losses stay on the device
        behind a window of ``loss_sync_every`` (config, default 16) steps:
        each step prints the loss of the step that many iterations back, so
        the ``\\r`` progress line lags slightly. The returned epoch mean is
        exact."""
        if callable(self.train_initializer):
            self.train_initializer()
        num_iters = self.num_train // self.batch_size
        ds = self.train_iterator
        if (isinstance(ds, DeviceDataset) and num_iters > 1 and ds.batch == self.batch_size
                and not any(self.config.get(k) for k in self.NO_SCAN_KEYS)):
            batches = (ds.gather(row) for row in ds.scan_indices(num_iters))
        else:
            batches = (next(ds) for _ in range(num_iters))
        sync_every = max(1, int(self.config.get("loss_sync_every", 16)))
        losses = []
        shown = float("nan")
        for i, batch in enumerate(batches):
            loss = self.train_step(*self._to_device(*batch), lr)
            losses.append(loss)
            if i >= sync_every or i + 1 == num_iters:
                shown = float(losses[-1] if i + 1 == num_iters else losses[i - sync_every])
            sys.stdout.write(f"\r>> iters {i}/{num_iters} {self._loss_label()} {shown}")
            sys.stdout.flush()
            if writer is not None:
                writer.add_summary(loss, global_step=self.global_step)
        sys.stdout.write("\n")
        if not losses:
            return float("nan")
        return float(np.mean(torch.stack(losses).cpu().numpy()))

    # ------------------------------------------------------------ public API
    @torch.inference_mode()
    def test_one_image(self, images):
        """images: ``[1, H, W, 3]`` (or ``[1, 3, H, W]`` for channels_first).
        Returns ``[scores, bbox (y1x1y2x2 pixels), class_id]`` as numpy arrays
        with padding stripped. Puts the net in eval mode; a later ``train_step``
        puts it back in train mode."""
        self.net.eval()
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
        """Write ``{path}-{global_step}.pt``: the net's state, the optimizer's
        (training) and ``global_step``, so a run resumes identically."""
        if mode not in ("latest", "best"):
            raise ValueError(f"mode must be 'latest' or 'best', got {mode!r}")
        state = {"state_dict": self.net.state_dict(), "global_step": self.global_step,
                 "opt_state": self.opt_state or {}}
        fname = ckpt.save_state(path, state, self.global_step)
        print("save", mode, "model in", fname, "successfully")

    def load_weight(self, path: str):
        """Restore the net, the optimizer's state (training) and
        ``global_step`` from a checkpoint of the port's (``.pt``) or of
        tpudet's ``save_weight`` (``.tpudet``: ``params`` and ``batch_stats``
        go through ``transfer.from_flax``, ``opt_state`` through
        ``transfer.opt_state_from_flax``). ``path`` is a file, a ``path-step``
        prefix or a bare prefix (the newest step)."""
        fname = ckpt.resolve(path)
        blob = ckpt.load_state(fname, map_location=self.device)
        if fname.endswith(ckpt.TPUDET_SUFFIX):
            state = transfer.from_flax({"params": blob["params"],
                                        "batch_stats": blob.get("batch_stats", {})})
            opt_state = blob.get("opt_state")
            opt_state = transfer.opt_state_from_flax(opt_state) if opt_state else None
        else:
            state, opt_state = blob["state_dict"], blob.get("opt_state")
        self.net.load_state_dict(state, strict=True)
        if self.opt_state is not None and opt_state:
            _copy_state(self.opt_state, opt_state)
        self.global_step = int(blob.get("global_step", 0))
        print("load weight", fname, "successfully")

    def _load_scopes(self, path: str, scopes, with_stats: bool):
        """Restore the net's top-level modules ``scopes`` (e.g. ``("backone",)``)
        from tpudet's ``.tpudet`` or the port's ``.pt`` (an exact file, a
        ``path-step`` prefix or a bare prefix): their parameters, and their
        BatchNorm statistics where ``with_stats`` and the file has them.
        Returns the file's name."""
        fname = ckpt.resolve(path)
        blob = ckpt.load_state(fname)
        if fname.endswith(ckpt.TPUDET_SUFFIX):
            collections = ("params", "batch_stats") if with_stats else ("params",)
            state = transfer.from_flax({c: {s: blob[c][s] for s in scopes
                                            if s in blob.get(c, {})}
                                        for c in collections})
        else:
            state = blob["state_dict"]
        for scope in scopes:
            module = getattr(self.net, scope)
            sub = transfer.subtree(state, scope)
            if not with_stats:
                names = dict(module.named_parameters())
                sub = {k: v for k, v in sub.items() if k in names}
            missing, unexpected = module.load_state_dict(sub, strict=False)
            if unexpected or any(not k.endswith((".mean", ".var")) for k in missing):
                raise KeyError(f"the checkpoint's {scope} does not match the net's: "
                               f"missing {missing}, unexpected {unexpected}")
        return fname


def _copy_state(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy an optimizer state ``src`` into ``dst`` in place; the two must
    hold the same keys at every level."""
    if dst.keys() != src.keys():
        raise KeyError(f"the checkpoint's optimizer state {sorted(src)} does not match "
                       f"the model's {sorted(dst)}")
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_state(dst[k], v)
        else:
            dst[k].copy_(v)
