"""Batched greedy NMS: the CUDA kernels' wrapper and the pre-top-k pool
(counterpart of ``tpudet/ops/pallas/nms_kernel.py``).

:func:`nms_rows` runs ``csrc/nms.cu`` on CUDA tensors and the plain
:func:`tpudet_torch.ops.nms.batched_greedy_nms` on CPU tensors; any other device
raises. On the card it takes one of two designs by the number of candidates a
row holds (:func:`scan_path`): the sorted bitmask scan up to
``SORTED_SCAN_MAX_WIDTH``, one block per row beyond. Both stand in for both
Pallas kernels of tpudet (the lockstep ``_kernel_xb`` and the per-image
``_kernel``), so there is no kernel switch.

``launches`` counts the wrapper's calls that launched a kernel in this process,
and ``launches_by_path`` splits them by design; callers that need to show a path
went through the kernels set them to 0 and read them back.
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.ops import nms as nms_ops

SORTED_SCAN_MAX_WIDTH = 1024  # the scan kernel's limit: one 64-bit word per lane

launches = 0
launches_by_path = {"sorted_scan": 0, "per_pick": 0}

_ARGTYPES = {
    "tpudet_nms_rows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p],
    "tpudet_nms_sorted": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
}


def _library(entry: str = "tpudet_nms_sorted"):
    from tpudet_torch.ops.cuda import build

    fn = getattr(build.load("nms"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return fn


def mask_stride(p: int) -> int:
    """64-bit words a sorted position takes in the scan's mask: one per 64
    positions, padded to an even count so every mask row is 16-byte aligned
    (``mask_stride`` of ``csrc/nms.cu``, which reads the mask so)."""
    words = -(-p // 64)
    return words + words % 2


def scan_path(width: int) -> str:
    """The design that takes rows of ``width`` candidates on the card."""
    return "sorted_scan" if width <= SORTED_SCAN_MAX_WIDTH else "per_pick"


def stable_order(scores: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` int32: each row's indices in descending score order, NaN first
    and ties in index order (the greedy pick order of the plain version).

    The keys are made canonical first (every NaN the same positive NaN, -0.0 as
    +0.0), so a radix sort that orders by bits agrees with ``>``.
    """
    key = torch.where(torch.isnan(scores), float("nan"), scores + 0.0)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return order.to(torch.int32)


def _check(boxes, scores, num_select, order=None):
    if scores.dim() != 2:
        raise ValueError(f"scores must be [B, N], got {tuple(scores.shape)}")
    b, n = scores.shape
    if boxes.shape not in ((n, 4), (b, n, 4)):
        raise ValueError(f"boxes must be [N, 4] or [B, N, 4] with B={b}, N={n}; "
                         f"got {tuple(boxes.shape)}")
    if tuple(num_select.shape) != (b,):
        raise ValueError(f"num_select must be [{b}], got {tuple(num_select.shape)}")
    tensors = (boxes, scores, num_select) + (() if order is None else (order,))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"NMS inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if scores.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"NMS takes float32 boxes and scores, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if num_select.dtype != torch.int32:
        raise TypeError(f"NMS takes int32 num_select, got {num_select.dtype}")
    if order is not None:
        if order.dim() != 2 or order.shape[0] != b or order.shape[1] > n:
            raise ValueError(f"order must be [{b}, P] with P <= {n}, got "
                             f"{tuple(order.shape)}")
        if order.shape[1] > SORTED_SCAN_MAX_WIDTH:
            raise ValueError(f"an order of {order.shape[1]} positions exceeds the "
                             f"sorted scan's {SORTED_SCAN_MAX_WIDTH}")
        if order.dtype != torch.int32:
            raise TypeError(f"NMS takes an int32 order, got {order.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("NMS takes contiguous boxes, scores, num_select and order")
    if boxes.data_ptr() % 16:
        raise ValueError("NMS takes boxes aligned to 16 bytes (whole boxes)")


def _count(path: str):
    global launches
    launches += 1
    launches_by_path[path] += 1


def _launch_per_pick(boxes, scores, num_select, max_out: int, iou_threshold: float):
    b, n = scores.shape
    if n >= 2 ** 31 // 4:
        raise ValueError(f"row width {n} exceeds the kernel's int32 indexing")
    dev = scores.device
    sel = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    work = torch.empty((b, n), dtype=torch.float32, device=dev)
    row_stride = 0 if boxes.dim() == 2 else n * 4
    fn = _library("tpudet_nms_rows")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(scores.data_ptr(), work.data_ptr(), boxes.data_ptr(), row_stride,
                 num_select.data_ptr(), b, n, max_out, iou_threshold,
                 sel.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    _count("per_pick")
    return sel, valid


def _launch_sorted(boxes, scores, num_select, order, max_out: int,
                   iou_threshold: float):
    b, n = scores.shape
    p = order.shape[1]
    dev = scores.device
    sel = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    mask = torch.empty((b, p, mask_stride(p)), dtype=torch.int64, device=dev)
    row_stride = 0 if boxes.dim() == 2 else n * 4
    fn = _library("tpudet_nms_sorted")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(scores.data_ptr(), boxes.data_ptr(), row_stride, order.data_ptr(),
                 num_select.data_ptr(), b, n, p, max_out, iou_threshold,
                 mask.data_ptr(), sel.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    _count("sorted_scan")
    return sel, valid


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor, num_select: torch.Tensor,
             max_out: int, iou_threshold: float, order: torch.Tensor | None = None):
    """Batched greedy NMS (see ``csrc/nms.cu``).

    Args:
      boxes: ``[N, 4]`` shared or ``[B, N, 4]`` per-row corner boxes, float32.
      scores: ``[B, N]`` float32, inactive entries ``<= -1e30``.
      num_select: ``[B]`` int32 budgets.
      order: optional ``[B, P]`` int32, ``P <= SORTED_SCAN_MAX_WIDTH``: the first
        ``P`` entries of :func:`stable_order` of ``scores``. Only those candidates
        take part (the pre-top-k pool); ``sel`` holds indices into the full rows.

    Returns ``(sel [B, max_out] int32, valid [B, max_out] bool)``. CUDA tensors
    run a kernel: the sorted scan over ``order``, else over the whole row's
    order when ``N <= SORTED_SCAN_MAX_WIDTH``, else one block per row. CPU
    tensors run the plain version; anything else raises. Both take the same
    inputs: dtypes, shapes and contiguity are checked alike.
    """
    _check(boxes, scores, num_select, order)
    dev = scores.device.type
    max_out, iou_threshold = int(max_out), float(iou_threshold)
    if dev == "cuda":
        if order is None and scan_path(scores.shape[1]) == "sorted_scan":
            order = stable_order(scores)
        if order is None:
            return _launch_per_pick(boxes, scores, num_select, max_out, iou_threshold)
        return _launch_sorted(boxes, scores, num_select, order, max_out, iou_threshold)
    if dev == "cpu":
        return plain_rows(boxes, scores, num_select, max_out, iou_threshold, order)
    raise ValueError(f"no NMS implementation for device {scores.device}")


def plain_rows(boxes: torch.Tensor, scores: torch.Tensor, num_select: torch.Tensor,
               max_out: int, iou_threshold: float, order: torch.Tensor | None = None):
    """The plain version of :func:`nms_rows`, on any device: only the candidates
    at ``order``'s positions take part when it is given."""
    active = None
    if order is not None:
        active = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
        active.scatter_(1, order.long(), True)
    return nms_ops.batched_greedy_nms(boxes, scores, num_select, max_out,
                                      iou_threshold, active=active)


def batched_greedy_nms_pretopk(boxes: torch.Tensor, scores: torch.Tensor,
                               num_select: torch.Tensor, max_out: int,
                               iou_threshold: float):
    """Pre-top-k pool in front of :func:`nms_rows`.

    Greedy NMS selects in descending score order, so running it on each row's top
    ``pool = max(2*max_out, 512)`` candidates is exact unless a row uses up its
    whole pool before filling its quota while live candidates remain outside the
    pool. Then the whole batch reruns at full width (the CUDA kernels have no
    fast-memory limit, unlike the TPU's). The check is data-dependent: one host
    sync per call.

    The pool is the head of :func:`stable_order`, which the sorted scan walks
    as it is, so the pool's candidates are never copied. A pool wider than the
    scan takes would run one block per row anyway, so the full width runs then.
    """
    _check(boxes, scores, num_select)
    n = scores.shape[-1]
    pool = max(2 * max_out, 512)
    if n <= pool or pool > SORTED_SCAN_MAX_WIDTH:
        return nms_rows(boxes, scores, num_select, max_out, iou_threshold)
    order = stable_order(scores)[:, :pool].contiguous()
    sel, valid = nms_rows(boxes, scores, num_select, max_out, iou_threshold, order)
    n_active = torch.sum(scores > nms_ops.NEG / 2, dim=-1)
    quota = torch.minimum(torch.clamp(num_select.long(), max=max_out), n_active)
    pool_exhausted = valid.sum(-1) < quota
    if bool(torch.any(pool_exhausted & (n_active > pool))):
        return nms_rows(boxes, scores, num_select, max_out, iou_threshold)
    return sel, valid
