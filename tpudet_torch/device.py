"""The port's device rule.

Model constructors take ``device=None``, which means the GPU (``"cuda"``). Without
a card that raises: the port never moves to the CPU on its own. A caller that
wants the CPU (the tests, for instance) says so with ``device="cpu"``.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def same(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` without an index is
    the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None
                                                          else b.index)


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (the line every
    measurement is kept with); ``"cpu"`` for the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
