"""Momentum and TF-style Adam with a runtime learning rate (counterpart of
``tpudet/runtime/optim.py``).

Training divides ``lr`` by 10 at fixed epochs, so the learning rate is a plain float
argument of every update. A state is a dict: Momentum's ``{"velocity": ...}``,
Adam's ``{"count": ..., "mu": ..., "nu": ...}``, with tpudet's field names;
each tree is a dict of tensors keyed like ``named_parameters()``, so the
state saves, loads and transfers by name. Updates are in place (tpudet
donates the same buffers to its jitted step; in place keeps one copy of each).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Tree = Dict[str, torch.Tensor]
State = Dict[str, Any]


class Momentum:
    """``v = momentum * v + g``; ``p -= lr * v`` (TF's MomentumOptimizer)."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum

    def init(self, params: Tree) -> State:
        return {"velocity": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Tree, state: State, params: Tree, lr: float) -> None:
        """Update ``state`` and ``params`` in place."""
        names = list(params)
        v = [state["velocity"][k] for k in names]
        p = [params[k] for k in names]
        torch._foreach_mul_(v, self.momentum)
        torch._foreach_add_(v, [grads[k] for k in names])
        torch._foreach_sub_(p, torch._foreach_mul(v, float(lr)))


class Adam:
    """TF's AdamOptimizer: ``lr_t = lr sqrt(1 - b2^t) / (1 - b1^t)``,
    ``p -= lr_t m / (sqrt(v) + eps)`` with eps outside the square root.

    Every operation is tpudet's, in its order and types: ``b1^t``, ``b2^t`` and
    ``lr_t`` are float32 tensors (Python doubles round otherwise), ``(1 - b)
    g`` and ``(1 - b2) g g`` multiply left to right, so one step on float32
    equals tpudet's bit for bit on the CPU."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> State:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Tree, state: State, params: Tree, lr: float) -> None:
        """Update ``state`` and ``params`` in place."""
        names = list(params)
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        p = [params[k] for k in names]
        state["count"].add_(1)
        t = state["count"].to(torch.float32)
        f32 = dict(dtype=torch.float32, device=t.device)
        b1t = torch.pow(torch.tensor(self.b1, **f32), t)
        b2t = torch.pow(torch.tensor(self.b2, **f32), t)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        g2 = torch._foreach_mul(g, 1 - self.b2)
        torch._foreach_mul_(g2, g)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        lr_t = torch.tensor(lr, **f32) * torch.sqrt(1.0 - b2t) / (1.0 - b1t)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_mul(mu, lr_t)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(p, step)
