"""The initial weights that the convergence protocol starts from: for the two
host-feed families of ``scripts/train_convergence_torch.py``, every
tensor of the port's freshly built net has the scale of flax's own
initialisation of tpudet's net (a whole-net check beside the per-layer
ones of ``tests/test_torch_refine.py``): constant tensors (biases, BatchNorm
and L2-norm scales and statistics) equal exactly, and each random tensor of
at least ``MIN_RANDOM`` elements has flax's standard deviation within
``STD_RTOL`` (sampling error of a standard deviation over n draws is about
``1 / sqrt(2 n)``: 1.1% at 4096) and a mean within a tenth of it.
"""

import jax
import numpy as np
import pytest

from tpudet.models import refinedet as jax_refinedet
from tpudet_torch.models import refinedet as t_refinedet
from tpudet_torch.runtime import transfer

MIN_RANDOM = 4096
STD_RTOL = 0.1


def _config():
    return {"mode": "test", "data_format": "channels_last", "num_classes": 20,
            "weight_decay": 1e-4, "batch_size": 1, "input_size": 64,
            "nms_score_threshold": 0.05, "nms_max_boxes": 40, "nms_iou_threshold": 0.45,
            "pretraining_weight": None}


@pytest.mark.parametrize("name", ["RefineDet320", "PFPNetR"])
def test_initial_weights_have_flaxs_scales(name):
    jm = getattr(jax_refinedet, name)(_config(), None)
    tm = getattr(t_refinedet, name)(_config(), None, device="cpu")
    want = transfer.from_flax(jax.device_get({"params": jm.params,
                                              "batch_stats": jm.batch_stats}))
    got = tm.net.state_dict()
    assert got.keys() == want.keys()
    random = 0
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[key].double().numpy()
        assert g.shape == w.shape, key
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w.size >= MIN_RANDOM:
            random += 1
            assert abs(g.std() / w.std() - 1) < STD_RTOL, (key, g.std(), w.std())
            assert abs(g.mean() - w.mean()) < 0.1 * w.std(), (key, g.mean(), w.mean())
    assert random > 50
