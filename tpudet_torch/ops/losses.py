"""Loss primitives shared by the heads (counterpart of ``tpudet/ops/losses.py``).

Same formulas as tpudet's, written out rather than taken from ``torch.nn``
(``torch.log_softmax`` sums in another way): elementwise and rowwise functions,
with the reductions left to the callers. The heads that need a focal or IoU
term in another layout (RetinaNet's rows, CenterNet's planes, FCOS's masked
sums) spell it beside their loss.
"""

from __future__ import annotations

import torch

from tpudet_torch.runtime import mesh as mesh_lib


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


def softmax_focal(logits: torch.Tensor, labels: torch.Tensor, alpha: float,
                  gamma: float) -> torch.Tensor:
    """RetinaNet's softmax focal loss per row: ``alpha (1 - p)^gamma (-log p)``,
    ``p`` the softmax probability of the true class."""
    ce = softmax_cross_entropy(logits, labels)
    p = torch.exp(-ce)
    return alpha * torch.pow(1.0 - p, gamma) * ce


def penalty_reduced_focal(sigmoid_hm: torch.Tensor, gaussian_gt: torch.Tensor,
                          pos_mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """CenterNet's keypoint focal loss per location: ``-(1 - s)^2 log(s)`` where
    ``pos_mask``, else ``-(1 - g)^4 s^2 log(1 - s)``; the caller divides by
    the number of objects."""
    s = sigmoid_hm
    pos = -torch.square(1.0 - s) * torch.log(s + eps)
    neg = -torch.pow(1.0 - gaussian_gt, 4.0) * torch.square(s) * torch.log(1.0 - s + eps)
    return torch.where(pos_mask, pos, neg)


def neg_log_iou(p_tlbr: torch.Tensor, g_tlbr: torch.Tensor,
                eps: float = 1e-12) -> torch.Tensor:
    """FCOS's regression loss ``-log(IoU)`` of predicted and target (top, left,
    bottom, right) distances at the same location."""
    pt, pl, pb, pr = p_tlbr.unbind(-1)
    gt_, gl, gb, gr = g_tlbr.unbind(-1)
    p_area = (pt + pb) * (pl + pr)
    g_area = (gt_ + gb) * (gl + gr)
    inter = ((torch.minimum(pt, gt_) + torch.minimum(pb, gb))
             * (torch.minimum(pl, gl) + torch.minimum(pr, gr)))
    iou = inter / (p_area + g_area - inter + eps)
    return -torch.log(iou + eps)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows with ``jax.nn.one_hot``'s semantics: a label
    outside ``[0, num_classes)``, a negative one included, gives a row of
    zeros. (``F.one_hot`` raises on the CPU and asserts on the card.)"""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None].long() == classes).to(torch.float32)


def weighted_mean(per_sample: torch.Tensor, sample_weight=None) -> torch.Tensor:
    """Mean over the real samples of a batch; ``sample_weight`` is 1 for real
    rows and 0 for padding rows (None: a plain mean).

    Under an active mesh of R ranks, each holding its rows of the batch, this
    rank's share of the global mean: its own numerator over the global
    denominator (the mask summed over the ranks; without a mask, R times its
    rows), so the shares of the ranks sum to tpudet's mean over the whole
    device batch."""
    world = mesh_lib.active_world()
    if sample_weight is None:
        mean = torch.mean(per_sample)
        return mean if world == 1 else mean * (1.0 / world)
    w = sample_weight.to(per_sample.dtype)
    return torch.sum(per_sample * w) / torch.clamp(mesh_lib.all_reduce_sum(torch.sum(w)),
                                                   min=1.0)
