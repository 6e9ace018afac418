"""The NMS CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device exists. The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import nms_kernel
from torch_nms_cases import nms_case

CASES = ["random0", "random1", "per_row_boxes", "pretopk", "exhaustion", "zero_area",
         "ties"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("pretopk", [False, True])
def test_cuda_kernel_equals_plain(cuda_device, name, pretopk):
    boxes, scores, ns, max_out, thr = nms_case(name)
    cpu = [torch.from_numpy(a) for a in (boxes, scores, ns)]
    if pretopk:
        want = nms_kernel.batched_greedy_nms_pretopk(*cpu, max_out, thr)
    else:
        want = t_nms.batched_greedy_nms(*cpu, max_out, thr)
    fn = nms_kernel.batched_greedy_nms_pretopk if pretopk else nms_kernel.nms_rows
    before = nms_kernel.launches
    sel, val = fn(*(t.to(cuda_device) for t in cpu), max_out, thr)
    torch.cuda.synchronize()
    assert nms_kernel.launches > before
    np.testing.assert_array_equal(val.cpu().numpy(), want[1].numpy())
    np.testing.assert_array_equal(sel.cpu().numpy(), want[0].numpy())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_wrong_dtypes(cuda_device):
    boxes = torch.zeros((8, 4), device=cuda_device)
    scores = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(boxes, scores, torch.zeros(2, device=cuda_device), 4, 0.5)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(boxes.double(), scores,
                            torch.zeros(2, dtype=torch.int32, device=cuda_device), 4, 0.5)
