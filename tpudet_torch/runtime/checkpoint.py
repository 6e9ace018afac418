"""Checkpoints (counterpart of ``tpudet/runtime/checkpoint.py``), torch-native.

``save_state(path, state, step)`` writes ``{path}-{step}.pt`` (tf.train.Saver's
``path-{global_step}`` convention). ``load_state`` accepts an exact file path, a
``path-step`` prefix, or a bare prefix, which resolves to the newest step.
The models' state holds the net's ``state_dict``, the Momentum ``velocity``
(keyed like ``named_parameters()``) and ``global_step``. tpudet's ``.tpudet``
msgpack files are not read here yet.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict

import torch

SUFFIX = ".pt"


def save_state(path: str, state: Dict[str, Any], step: int) -> str:
    d = os.path.dirname(path)
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)
        print(d, "does not exist, create it done")
    fname = f"{path}-{step}{SUFFIX}"
    torch.save(state, fname)
    return fname


def _resolve(path: str) -> str:
    if os.path.isfile(path):
        return path
    if os.path.isfile(path + SUFFIX):
        return path + SUFFIX
    cands = glob.glob(glob.escape(path) + "-*" + SUFFIX)
    if not cands:
        raise FileNotFoundError(f"no checkpoint matching {path!r}")

    def step_of(p):
        m = re.search(r"-(\d+)" + re.escape(SUFFIX) + r"$", p)
        return int(m.group(1)) if m else -1

    return max(cands, key=step_of)


def load_state(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """Load a state written by :func:`save_state` (tensors only, no pickled code)."""
    return torch.load(_resolve(path), map_location=map_location, weights_only=True)
