"""Per-model serve phase profiler of the port on one NVIDIA GPU (the
counterpart of ``scripts/profile_decode.py``, with its specs, image and
phases).

Splits one request, ``test_one_image`` on a batch-1 image of uniform pixels
from seed 0 at the spec's input size and config in ``mode: "test"``, into:

    transfer   ``torch.from_numpy`` of the [1, H, W, 3] image to the card,
               a sum, ``.item()``
    forward    the net in eval mode on the image already on the card
    decode     ``_decode_outputs`` on head outputs computed in advance
               (LH-RCNN's too: the port has one)
    fused      forward and decode on the image already on the card, with no
               copy to the host
    full       ``test_one_image`` (the copy in, forward, decode, the copies out)

Each phase's figures are ``scripts/profile_model_torch.py``'s, with
``host_ms`` the p50 of ``n`` calls, each ended by ``torch.cuda.synchronize``,
after ``warmup``; ``launches`` are a request's.

Run from the root of a checkout:  python scripts/profile_decode_torch.py [model ...]
(default RetinaNet YOLOv3 FCOS LHRCNN SSD300, as tpudet's). Writes each
family's record under its ``serve`` key in PROFILE_TORCH.json at the root of
the checkout, merged into what is there. A family that fails records its
error, the rest go on, and the script exits 1.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from profile_model_torch import OUT, empty_cache, run_all, run_phases  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402

FAMILIES = ["RetinaNet", "YOLOv3", "FCOS", "LHRCNN", "SSD300"]


def serve_phases(model, img) -> dict:
    """label -> one call of that phase on the numpy image ``img`` [1, H, W,
    3]; each returns what its phase computes."""
    import torch

    dev = model.device
    images = img.transpose(0, 3, 1, 2) if model.data_format == "channels_last" else img
    x = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    net = model.net.eval()

    @torch.inference_mode()
    def forward():
        return net(model._preprocess(x))

    outputs = forward()

    @torch.inference_mode()
    def decode():
        return model._decode_outputs(outputs)

    @torch.inference_mode()
    def fused():
        return model._decode_outputs(net(model._preprocess(x)))

    return {"transfer": lambda: torch.from_numpy(img).to(dev).sum().item(),
            "forward": forward, "decode": decode, "fused": fused,
            "full": lambda: model.test_one_image(img)}


def serve_model(name, spec, device=None):
    """The family's model in ``mode: "test"`` from seeded random weights and
    tpudet's image: ``(model, img)``."""
    from tpudet_torch import models

    h, w = spec["shape"]
    cfg = dict(spec["config"], mode="test")
    model = getattr(models, name)(cfg, None, device=device_lib.resolve(device))
    img = np.random.default_rng(0).uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    return model, img


def profile_decode(name, spec, n=15, warmup=3, device=None) -> dict:
    """One family's serve phases; ``device=None`` is the card."""
    h, w = spec["shape"]
    print(f"=== {name} (test @ {h}x{w}) building...", flush=True)
    model, img = serve_model(name, spec, device)
    phases = run_phases(model, serve_phases(model, img), n, warmup, p50=True)
    dev = model.device
    record = {"shape": [h, w], "n": n, "warmup": warmup, "phases": phases,
              "device": device_lib.card_line(dev)}
    del model
    empty_cache(dev)
    return record


def main(argv=None, out=OUT, device=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or FAMILIES
    return run_all(lambda name, spec: profile_decode(name, spec, device=device), names, out,
                   key="serve")


if __name__ == "__main__":
    sys.exit(main())
