"""Loss primitives of the SSD family (counterpart of ``tpudet/ops/losses.py``).

Same formulas as tpudet's, written out rather than taken from ``torch.nn``
(``torch.log_softmax`` sums in another way): elementwise and rowwise functions,
with the reductions left to the callers. The focal and IoU losses live with
the families that use them.
"""

from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """``0.5 x^2`` for ``|x| < 1`` else ``|x| - 0.5``."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    m = torch.amax(logits, dim=-1)
    return m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Stable log-softmax over the last axis; one serves several CE readouts."""
    return logits - _logsumexp(logits)[..., None]


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` row by row, with ``jnp.take_along_axis``'s semantics:
    an index in ``[-C, C)`` wraps as in numpy, any other gives NaN and passes
    no gradient back. Nothing raises, so a bad class id on the card makes the
    loss NaN, as in tpudet, instead of a device-side assert."""
    c = x.shape[-1]
    idx = idx.long()
    in_range = (idx >= -c) & (idx < c)
    safe = torch.where(in_range, torch.remainder(idx, c), 0)
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    return torch.where(in_range, picked, float("nan"))


def ce_from_log_probs(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-log_probs[..., label]``."""
    return -take_last(log_probs, labels)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax CE per row: ``logits [..., C]``, ``labels [...]`` int."""
    return _logsumexp(logits) - take_last(logits, labels)


def jnp_abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient at 0, which is 1 (``torch.abs``'s
    is 0): ``where(x >= 0, x, -x)``."""
    return torch.where(x >= 0, x, -x)


def sigmoid_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x t + log1p(exp(-|x|))`` elementwise
    (``tf.nn.sigmoid_cross_entropy_with_logits``), spelled as tpudet spells it,
    with JAX's gradients at ``x = 0``: ``torch.maximum`` splits a tie as
    ``jnp.maximum`` does, and ``|x|`` is :func:`jnp_abs`."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-jnp_abs(logits))))


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows with ``jax.nn.one_hot``'s semantics: a label
    outside ``[0, num_classes)``, a negative one included, gives a row of
    zeros. (``F.one_hot`` raises on the CPU and asserts on the card.)"""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None].long() == classes).to(torch.float32)


def weighted_mean(per_sample: torch.Tensor, sample_weight=None) -> torch.Tensor:
    """Mean over the real samples of a batch; ``sample_weight`` is 1 for real
    rows and 0 for padding rows (None: a plain mean)."""
    if sample_weight is None:
        return torch.mean(per_sample)
    w = sample_weight.to(per_sample.dtype)
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)
