"""The port's entry point (the counterpart of ``__graft_entry__.py``).

``entry(device=None)`` returns the flagship model's forward pass, SSD300's
``SSDNet`` (20 classes + background, eval mode, on the card unless the caller
passes ``device="cpu"``), and its example args: one ``[1, 3, 300, 300]``
float32 zero image, NCHW because the port's net runs NCHW.

``python entry_torch.py`` runs that forward once on the card and prints the
output shapes: the counterpart of tpudet's compile check.

tpudet's ``dryrun_multichip`` (one data-parallel step over a device mesh)
has no counterpart yet: it comes with the port's data parallelism
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from tpudet_torch import device as device_lib  # noqa: E402
from tpudet_torch.heads.ssd import SSDNet  # noqa: E402


def entry(device=None):
    """SSD300's forward (feature extractor + heads) and example args."""
    dev = device_lib.resolve(device)
    net = SSDNet(num_classes_total=21, generator=torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    example_args = (torch.zeros((1, 3, 300, 300), dtype=torch.float32, device=dev),)
    return net, example_args


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        outputs = fn(*args)
    torch.cuda.synchronize()
    for i, out in enumerate(outputs):
        print(f"level {i}: {tuple(out.shape)} {out.dtype}")
    print("entry() ran OK on", torch.cuda.get_device_name(0))
