"""Momentum with a runtime learning rate (counterpart of
``tpudet/runtime/optim.py``).

Training divides ``lr`` by 10 at fixed epochs, so the learning rate is a plain float
argument of every update. The state is a dict of tensors keyed like
``named_parameters()``, so it saves, loads and transfers by name. Adam comes
with CenterNet.
"""

from __future__ import annotations

from typing import Dict

import torch

State = Dict[str, torch.Tensor]


class Momentum:
    """``v = momentum * v + g``; ``p -= lr * v`` (TF's MomentumOptimizer)."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum

    def init(self, params: Dict[str, torch.Tensor]) -> State:
        return {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], velocity: State,
               params: Dict[str, torch.Tensor], lr: float) -> None:
        """Update ``velocity`` and ``params`` in place (tpudet donates the same
        buffers to its jitted step; in place keeps one copy of each)."""
        names = list(params)
        v = [velocity[k] for k in names]
        p = [params[k] for k in names]
        torch._foreach_mul_(v, self.momentum)
        torch._foreach_add_(v, [grads[k] for k in names])
        torch._foreach_sub_(p, torch._foreach_mul(v, float(lr)))
