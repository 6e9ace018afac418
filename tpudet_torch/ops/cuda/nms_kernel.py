"""Batched greedy NMS: the CUDA kernel's wrapper and the pre-top-k pool
(counterpart of ``tpudet/ops/pallas/nms_kernel.py``).

:func:`nms_rows` runs ``csrc/nms.cu`` (one thread block per row) on CUDA tensors
and the plain :func:`tpudet_torch.ops.nms.batched_greedy_nms` on CPU tensors;
any other device raises. The one kernel stands in for both Pallas kernels of
tpudet (the lockstep ``_kernel_xb`` and the per-image ``_kernel``), so there is no
kernel switch.

``launches`` counts the kernel's launches in this process; callers that need to
show a path went through the kernel set it to 0 and read it back.
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.ops import nms as nms_ops

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _library():
    from tpudet_torch.ops.cuda import build

    lib = build.load("nms")
    fn = lib.tpudet_nms_rows
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(boxes, scores, num_select):
    if scores.dim() != 2:
        raise ValueError(f"scores must be [B, N], got {tuple(scores.shape)}")
    b, n = scores.shape
    if boxes.shape not in ((n, 4), (b, n, 4)):
        raise ValueError(f"boxes must be [N, 4] or [B, N, 4] with B={b}, N={n}; "
                         f"got {tuple(boxes.shape)}")
    if tuple(num_select.shape) != (b,):
        raise ValueError(f"num_select must be [{b}], got {tuple(num_select.shape)}")
    devices = {boxes.device, scores.device, num_select.device}
    if len(devices) != 1:
        raise ValueError(f"boxes, scores and num_select lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if scores.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"NMS takes float32 boxes and scores, got "
                        f"{boxes.dtype} and {scores.dtype}")
    if num_select.dtype != torch.int32:
        raise TypeError(f"NMS takes int32 num_select, got {num_select.dtype}")
    if not (boxes.is_contiguous() and scores.is_contiguous()
            and num_select.is_contiguous()):
        raise ValueError("NMS takes contiguous boxes, scores and num_select")


def _launch(boxes, scores, num_select, max_out: int, iou_threshold: float):
    global launches
    b, n = scores.shape
    if n >= 2 ** 31 // 4:
        raise ValueError(f"row width {n} exceeds the kernel's int32 indexing")
    dev = scores.device
    sel = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    valid = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    work = torch.empty((b, n), dtype=torch.float32, device=dev)
    row_stride = 0 if boxes.dim() == 2 else n * 4
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(scores.data_ptr(), work.data_ptr(), boxes.data_ptr(), row_stride,
                 num_select.data_ptr(), b, n, max_out, iou_threshold,
                 sel.data_ptr(), valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    launches += 1
    return sel, valid


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor, num_select: torch.Tensor,
             max_out: int, iou_threshold: float):
    """Batched greedy NMS, one row per block (see ``csrc/nms.cu``).

    Args:
      boxes: ``[N, 4]`` shared or ``[B, N, 4]`` per-row corner boxes, float32.
      scores: ``[B, N]`` float32, inactive entries ``<= -1e30``.
      num_select: ``[B]`` int32 budgets.

    Returns ``(sel [B, max_out] int32, valid [B, max_out] bool)``. CUDA tensors
    run the kernel; CPU tensors run the plain version; anything else raises.
    Both take the same inputs: dtypes, shapes and contiguity are checked alike.
    """
    _check(boxes, scores, num_select)
    dev = scores.device.type
    if dev == "cuda":
        return _launch(boxes, scores, num_select, int(max_out), float(iou_threshold))
    if dev == "cpu":
        return nms_ops.batched_greedy_nms(boxes, scores, num_select, max_out,
                                          iou_threshold)
    raise ValueError(f"no NMS implementation for device {scores.device}")


def batched_greedy_nms_pretopk(boxes: torch.Tensor, scores: torch.Tensor,
                               num_select: torch.Tensor, max_out: int,
                               iou_threshold: float):
    """Pre-top-k pool in front of :func:`nms_rows`.

    Greedy NMS selects in descending score order, so running it on each row's top
    ``pool = max(2*max_out, 512)`` candidates is exact unless a row uses up its
    whole pool before filling its quota while live candidates remain outside the
    pool. Then the whole batch reruns at full width through the same kernel
    (the CUDA kernel has no fast-memory limit, unlike the TPU's). The check is
    data-dependent: one host sync per call.

    The pool is built with a stable descending sort, so tied scores keep the
    lowest index first, which the kernel's tie rule relies on.
    """
    n = scores.shape[-1]
    pool = max(2 * max_out, 512)
    if n <= pool:
        return nms_rows(boxes, scores, num_select, max_out, iou_threshold)
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s = top_s[:, :pool].contiguous()
    top_i = top_i[:, :pool].contiguous()
    if boxes.dim() == 2:
        top_b = boxes[top_i].contiguous()                           # [B, pool, 4]
    else:
        top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)).contiguous()
    sel_p, valid = nms_rows(top_b, top_s, num_select, max_out, iou_threshold)
    n_active = torch.sum(scores > nms_ops.NEG / 2, dim=-1)
    quota = torch.minimum(torch.clamp(num_select.long(), max=max_out), n_active)
    pool_exhausted = valid.sum(-1) < quota
    if bool(torch.any(pool_exhausted & (n_active > pool))):
        return nms_rows(boxes, scores, num_select, max_out, iou_threshold)
    sel = torch.where(valid, torch.gather(top_i, 1, sel_p.long()).to(torch.int32), 0)
    return sel, valid
