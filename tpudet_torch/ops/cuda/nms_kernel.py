"""Batched greedy NMS: the CUDA kernels' wrapper and the pre-top-k pool
(counterpart of ``tpudet/ops/pallas/nms_kernel.py``).

:func:`nms_rows` and :func:`batched_greedy_nms_pretopk` run ``csrc/nms.cu`` on
CUDA tensors and the plain :func:`tpudet_torch.ops.nms.batched_greedy_nms` on
CPU tensors; any other device raises. On the card a call selects each row's
pool (the head of its stable descending order, :func:`select_top`'s kernel),
scans it with the sorted bitmask scan, and, where a row's pool is narrower than
the row, continues the rows that ran out past their pool: :func:`pool_kernels`
names the kernels a call launches. Nothing is read back to the host, so a call
can be captured in a CUDA graph. These kernels stand in for both Pallas
kernels of tpudet (the lockstep ``_kernel_xb`` and the per-image ``_kernel``),
so there is no kernel switch.

``launches`` counts the wrapper's calls that launched a kernel in this process,
and ``launches_by_path`` each kernel's launches (``select``, ``mask``, ``scan``,
``continue``); callers that need to show a path went through the kernels set
them to 0 and read them back. :func:`continued_rows` is the device-side count
of rows the continuation took past their pool.
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.ops import nms as nms_ops

SORTED_SCAN_MAX_WIDTH = 1024  # the scan kernel's limit: one 64-bit word per lane
TILE = 1024  # the continuation's largest tile (its tiles are sized to the picks owed)

launches = 0
launches_by_path = {"select": 0, "mask": 0, "scan": 0, "continue": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tpudet_nms_init": [],
    "tpudet_nms_select": [_P, _I, _I, _I, _P, _P, _P],
    "tpudet_nms_mask": [_P, _P, ctypes.c_int64, _P, _I, _I, _I, ctypes.c_float, _P, _P],
    "tpudet_nms_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "tpudet_nms_continue": [_P, _P, ctypes.c_int64, _P, _P, _P, _I, _I, _I, _I, _I,
                            ctypes.c_float, _P, _P, _P, _P],
    "tpudet_nms_pool": [_P, _P, ctypes.c_int64, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                        _P, _P, _P, _P, _P, _P],
}
_ready: set = set()  # devices whose kernels' shared-memory limits are set
_continued: dict = {}  # device -> its int32 [1] count of continued rows


def _library(entry: str, dev: torch.device):
    """The C entry ``entry`` of ``csrc/nms.cu``, the library built and loaded
    at first use and ``tpudet_nms_init`` run once for ``dev``."""
    from tpudet_torch.ops.cuda import build

    lib = build.load("nms")
    if lib.tpudet_nms_init.argtypes is None:
        for name, argtypes in _ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    if dev not in _ready:
        with torch.cuda.device(dev):
            _raise(lib.tpudet_nms_init())
        _ready.add(dev)
    return getattr(lib, entry)


def _raise(err: int):
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")


def mask_stride(p: int) -> int:
    """64-bit words a sorted position takes in the scan's mask: one per 64
    positions, padded to an even count so every mask row is 16-byte aligned
    (``mask_stride`` of ``csrc/nms.cu``, which reads the mask so)."""
    words = -(-p // 64)
    return words + words % 2


def pretopk_pool(max_out: int) -> int:
    """tpudet's pre-top-k pool: ``max(2 * max_out, 512)`` candidates a row."""
    return max(2 * max_out, 512)


def pool_width(width: int, pool: int | None = None) -> int:
    """Positions of each row's pool on the card for rows of ``width``
    candidates: ``pool`` (default the whole row), at most the row and the
    scan's 1024."""
    return min(width if pool is None else pool, width, SORTED_SCAN_MAX_WIDTH)


def pool_kernels(width: int, pool: int | None = None) -> tuple:
    """The kernels a call of :func:`nms_rows` launches on the card
    (``launches_by_path``'s keys): the continuation only where the pool is
    narrower than the row."""
    if width == 0:
        return ()
    cont = ("continue",) if pool_width(width, pool) < width else ()
    return ("select", "mask", "scan") + cont


def stable_order(scores: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` int32: each row's indices in descending score order, NaN first
    and ties in index order (the greedy pick order of the plain version).

    The keys are made canonical first (every NaN the same positive NaN, -0.0 as
    +0.0), so a radix sort that orders by bits agrees with ``>``.
    """
    key = torch.where(torch.isnan(scores), float("nan"), scores + 0.0)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return order.to(torch.int32)


def continued_rows(device) -> torch.Tensor:
    """The int32 ``[1]`` count, on ``device``, of the rows the continuation
    took past their pool in this process. The path never reads it: a test
    zeroes it, synchronises after the calls and reads it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _continued:
        _continued[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _continued[dev]


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
    if n >= 2 ** 31 // 4:
        raise ValueError(f"row width {n} exceeds the kernels' int32 indexing")


def _count(*kernels):
    global launches
    launches += 1
    for k in kernels:
        launches_by_path[k] += 1


def _select(scores, p: int):
    """Launch the select kernel: ``(order [B, p] int32, live [B] int32)``."""
    b, n = scores.shape
    dev = scores.device
    order = torch.empty((b, p), dtype=torch.int32, device=dev)
    live = torch.empty((b,), dtype=torch.int32, device=dev)
    fn = _library("tpudet_nms_select", dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(fn(scores.data_ptr(), b, n, p, order.data_ptr(), live.data_ptr(), stream))
    return order, live


def _pool(boxes, scores, num_select, max_out: int, iou_threshold: float, p: int):
    """One launch sequence (``tpudet_nms_pool``): select each row's first ``p``
    positions, scan them, and continue the rows that ran out, in tiles of
    ``TILE`` (read at the call), when the rows are wider than ``p``. CUDA
    tensors only."""
    b, n = scores.shape
    dev = scores.device
    sel = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    if b == 0 or n == 0:
        return sel.zero_(), valid.zero_()
    work = torch.empty((b * (p + 3),), dtype=torch.int32, device=dev)
    mask = torch.empty((b, p, mask_stride(p)), dtype=torch.int64, device=dev)
    row_stride = 0 if boxes.dim() == 2 else n * 4
    fn = _library("tpudet_nms_pool", dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(fn(scores.data_ptr(), boxes.data_ptr(), row_stride, num_select.data_ptr(),
                  b, n, p, TILE, max_out, iou_threshold, work.data_ptr(), mask.data_ptr(),
                  sel.data_ptr(), valid.data_ptr(), continued_rows(dev).data_ptr(),
                  stream))
    _count(*pool_kernels(n, p))
    return sel, valid


def select_top(scores: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, p]`` int32: the first ``p`` positions of :func:`stable_order` of
    ``[B, N]`` float32 ``scores`` (``p <= N``). CUDA tensors run the select
    kernel (``p <= SORTED_SCAN_MAX_WIDTH``), CPU tensors the plain sort."""
    if scores.dim() != 2 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError(f"select_top takes contiguous float32 [B, N] scores, got "
                         f"{scores.dtype} {tuple(scores.shape)}")
    if not 0 < p <= scores.shape[1]:
        raise ValueError(f"select_top takes 0 < p <= {scores.shape[1]}, got {p}")
    if scores.device.type == "cpu":
        return stable_order(scores)[:, :p].contiguous()
    if scores.device.type != "cuda":
        raise ValueError(f"no select implementation for device {scores.device}")
    if p > SORTED_SCAN_MAX_WIDTH:
        raise ValueError(f"the select kernel takes p <= {SORTED_SCAN_MAX_WIDTH}, got {p}")
    order, _ = _select(scores, p)
    _count("select")
    return order


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor, num_select: torch.Tensor,
             max_out: int, iou_threshold: float, order: torch.Tensor | None = None,
             pool: int | None = None):
    """Batched greedy NMS (see ``csrc/nms.cu``).

    Args:
      boxes: ``[N, 4]`` shared or ``[B, N, 4]`` per-row corner boxes, float32.
      scores: ``[B, N]`` float32, inactive entries ``<= -1e30``.
      num_select: ``[B]`` int32 budgets.
      order: optional ``[B, P]`` int32, ``P <= SORTED_SCAN_MAX_WIDTH``: the first
        ``P`` entries of :func:`stable_order` of ``scores``. Only those candidates
        take part; ``sel`` holds indices into the full rows. The plain version
        only: the card selects its pool itself, and raises on an order.
      pool: the positions of each row's pool on the card
        (:func:`pool_width`); the result is the full rows' all the same.

    Returns ``(sel [B, max_out] int32, valid [B, max_out] bool)``. CUDA tensors
    run the kernels: each row's pool selected, scanned and, where the pool is
    narrower than the row, continued (:func:`pool_kernels`). CPU tensors run the plain version;
    anything else raises. Both take the same inputs: dtypes, shapes and
    contiguity are checked alike.
    """
    _check(boxes, scores, num_select, order)
    dev = scores.device.type
    max_out, iou_threshold = int(max_out), float(iou_threshold)
    if dev == "cuda":
        if order is not None:
            raise ValueError("the card selects each row's pool itself: nms_rows takes "
                             "an order on CPU tensors only")
        return _pool(boxes, scores, num_select, max_out, iou_threshold,
                     pool_width(scores.shape[1], pool))
    if dev == "cpu":
        return plain_rows(boxes, scores, num_select, max_out, iou_threshold, order)
    raise ValueError(f"no NMS implementation for device {scores.device}")


def plain_rows(boxes: torch.Tensor, scores: torch.Tensor, num_select: torch.Tensor,
               max_out: int, iou_threshold: float, order: torch.Tensor | None = None,
               pool: int | None = None):
    """The plain version of :func:`nms_rows`, on any device: only the candidates
    at ``order``'s positions take part when it is given (``pool`` does not
    change the result)."""
    active = None
    if order is not None:
        active = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
        active.scatter_(1, order.long(), True)
    return nms_ops.batched_greedy_nms(boxes, scores, num_select, max_out,
                                      iou_threshold, active=active)


def batched_greedy_nms_pretopk(boxes: torch.Tensor, scores: torch.Tensor,
                               num_select: torch.Tensor, max_out: int,
                               iou_threshold: float):
    """Greedy NMS of the full rows through tpudet's pre-top-k pool.

    Greedy NMS selects in descending score order, so each row's top
    :func:`pretopk_pool` candidates give its first picks exactly, unless the
    row uses up its pool short of its quota while live candidates lie outside
    it (tpudet's run-out check). On CUDA tensors :func:`nms_rows` takes the
    pool on the card and continues such a row past it, tile by tile, where
    tpudet reruns the batch at full width; every step is a kernel and no
    value comes back to the host. CPU tensors run the plain version over the
    pool (the head of :func:`stable_order`), check on the host, and rerun the
    rows at full width when a row ran out.
    """
    _check(boxes, scores, num_select)
    n = scores.shape[-1]
    pool = pretopk_pool(max_out)
    if scores.device.type == "cuda":
        return nms_rows(boxes, scores, num_select, max_out, iou_threshold, None, pool)
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
