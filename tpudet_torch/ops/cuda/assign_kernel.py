"""Batched anchor assignment: the CUDA kernel's wrapper (counterpart of
``tpudet/ops/pallas/assign_kernel.py``).

:func:`assign_anchors` runs ``csrc/assign.cu`` on CUDA tensors and the plain
:func:`tpudet_torch.ops.matching.assign_plain` on CPU tensors; any other device
raises. The products are integer and boolean decisions of gt and anchor
geometry, which carry no parameter gradient, so there is no backward.

``launches`` counts the calls that launched the kernel in this process;
callers that need to show a path went through the kernel set it to 0 and read
it back.

The kernel's scratch (the per-gt argmax keys and the per-image arrival
counters) lives here, one pair of tensors per device, grown to the largest
call and made with ``torch.zeros``: every launch leaves it zero again, so no
call clears it. Calls that share it must run on one stream, as the port's do
(PyTorch's current stream).
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.ops import matching

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _library():
    from tpudet_torch.ops.cuda import build

    lib = build.load("assign")
    fn = lib.tpudet_assign
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def scratch(dev: torch.device, b: int, g: int):
    """The kernel's zeroed scratch on ``dev`` for ``b`` images of ``g`` gt rows:
    ``(keys [>= b*g] int64, arrivals [>= b] int32)``."""
    keys, arrivals = _scratch.get(dev, (None, None))
    if keys is None or keys.numel() < b * g or arrivals.numel() < b:
        n_keys = max(b * g, 0 if keys is None else keys.numel())
        n_arrivals = max(b, 0 if arrivals is None else arrivals.numel())
        keys = torch.zeros(n_keys, dtype=torch.int64, device=dev)
        arrivals = torch.zeros(n_arrivals, dtype=torch.int32, device=dev)
        _scratch[dev] = (keys, arrivals)
    return keys, arrivals


def _check(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2):
    if gt_valid.dim() != 2:
        raise ValueError(f"gt_valid must be [B, G], got {tuple(gt_valid.shape)}")
    b, g = gt_valid.shape
    for name, t in (("gt_y1x1", gt_y1x1), ("gt_y2x2", gt_y2x2)):
        if tuple(t.shape) != (b, g, 2):
            raise ValueError(f"{name} must be [{b}, {g}, 2], got {tuple(t.shape)}")
    if a_y1x1.shape != a_y2x2.shape:
        raise ValueError(f"anchor corners differ in shape: {tuple(a_y1x1.shape)} "
                         f"and {tuple(a_y2x2.shape)}")
    a = a_y1x1.shape[-2] if a_y1x1.dim() >= 2 else 0
    if tuple(a_y1x1.shape) not in ((a, 2), (b, a, 2)) or a == 0:
        raise ValueError(f"anchors must be [A, 2] or [{b}, A, 2] with A > 0, got "
                         f"{tuple(a_y1x1.shape)}")
    tensors = (gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"assignment inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    for name, t in (("gt_y1x1", gt_y1x1), ("gt_y2x2", gt_y2x2),
                    ("a_y1x1", a_y1x1), ("a_y2x2", a_y2x2)):
        if t.dtype != torch.float32:
            raise TypeError(f"assignment takes float32 {name}, got {t.dtype}")
    if gt_valid.dtype != torch.bool:
        raise TypeError(f"assignment takes bool gt_valid, got {gt_valid.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("assignment takes contiguous tensors")


def _launch(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2):
    global launches
    b, g = gt_valid.shape
    a = a_y1x1.shape[-2]
    if b * a >= 2 ** 31:
        raise ValueError(f"B*A = {b * a} exceeds the kernel's int32 indexing")
    dev = gt_valid.device
    best_anchor = torch.empty((b, g), dtype=torch.int32, device=dev)
    best_iou = torch.empty((b, a), dtype=torch.float32, device=dev)
    rg = torch.empty((b, a), dtype=torch.int32, device=dev)
    best_set = torch.empty((b, a), dtype=torch.bool, device=dev)
    keys, arrivals = scratch(dev, b, g)
    row_stride = 0 if a_y1x1.dim() == 2 else a * 2
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gt_y1x1.data_ptr(), gt_y2x2.data_ptr(), gt_valid.data_ptr(),
                 a_y1x1.data_ptr(), a_y2x2.data_ptr(), row_stride, b, g, a,
                 keys.data_ptr(), arrivals.data_ptr(), best_anchor.data_ptr(),
                 best_iou.data_ptr(),
                 rg.data_ptr(), best_set.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"assignment kernel launch failed: cudaError {err}")
    launches += 1
    return matching.Assignment(best_anchor, best_iou, rg, best_set)


def assign_anchors(gt_y1x1: torch.Tensor, gt_y2x2: torch.Tensor,
                   gt_valid: torch.Tensor, a_y1x1: torch.Tensor,
                   a_y2x2: torch.Tensor) -> matching.Assignment:
    """Batched anchor assignment (see ``csrc/assign.cu``).

    Args:
      gt_y1x1, gt_y2x2: ``[B, G, 2]`` float32 gt corners.
      gt_valid: ``[B, G]`` bool.
      a_y1x1, a_y2x2: ``[A, 2]`` shared or ``[B, A, 2]`` per-image float32
        anchor corners.

    Returns ``Assignment(best_anchor [B, G] int32, best_iou [B, A] float32,
    rg [B, A] int32, best_set [B, A] bool)``. CUDA tensors run the kernel; CPU
    tensors run the plain version; anything else raises. Both take the same
    inputs: dtypes, shapes and contiguity are checked alike.
    """
    _check(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2)
    dev = gt_valid.device.type
    if dev == "cuda":
        return _launch(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2)
    if dev == "cpu":
        return matching.assign_plain(gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2)
    raise ValueError(f"no assignment implementation for device {gt_valid.device}")
