"""The tools that carry a net between tpudet and the port
(``tests/torch_flax_init.py``, ``scripts/convergence_variants_torch.py``):

  * ``to_flax`` undoes ``transfer.from_flax`` leaf for leaf on every kind of
    leaf (conv, ``dconv``, depthwise, pointwise and dense kernels, biases,
    BatchNorm's and the L2 norms' leaves), at the small sizes of the family
    tests;
  * ``carry_state`` keeps 1-D leaves float32 and rounds the rest to
    bfloat16, and a bfloat16 CenterNet computes from its copy what it
    computes from its own weights, bit for bit (a float32 one does not).

``tests/test_torch_flax_init.py`` holds the initial-weight files.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import torch_flax_init
import torch_refine_common as refine_common
from test_torch_lhrcnn import config as lhrcnn_config
from test_torch_lhrcnn import tpudet_model as lhrcnn_tpudet_model
from torch_anchor_free_common import seeded_pair
from tpudet.models.centernet import CenterNet as JaxCenterNet
from tpudet.models.refinedet import RefineDet320 as JaxRefineDet320
from tpudet.models.retinanet import RetinaNet as JaxRetinaNet
from tpudet_torch.models.centernet import CenterNet
from tpudet_torch.models.refinedet import RefineDet320
from tpudet_torch.runtime import transfer

SIZE = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variants():
    torch_flax_init._paths()
    return importlib.import_module("convergence_variants_torch")


def centernet_config(**kw):
    """``drivers/testcenternet.py``'s widths at 64x64, 20 classes, batch 2."""
    cfg = {"mode": "test", "input_size": SIZE, "data_format": "channels_last",
           "num_classes": 20, "weight_decay": 1e-4, "keep_prob": 0.5, "batch_size": 2,
           "score_threshold": 0.05, "top_k_results_output": 40, "seed": 3}
    cfg.update(kw)
    return cfg


def retina_config():
    return {"mode": "test", "data_format": "channels_last", "num_classes": 4,
            "weight_decay": 1e-4, "keep_prob": 1.0, "batch_size": 2,
            "nms_score_threshold": 0.2, "nms_max_boxes": 5, "nms_iou_threshold": 0.45,
            "data_shape": [SIZE, SIZE, 3], "is_bottleneck": True,
            "residual_block_list": [1, 1, 1], "init_conv_filters": 8,
            "is_pretraining": False, "alpha": 0.25, "gamma": 2.0, "seed": 3}


def tpudet_variables(name):
    """tpudet's variables of a small model of the family, drawn from a
    seeded numpy generator in flax's shapes."""
    if name == "CenterNet":
        return seeded_pair(JaxCenterNet, centernet_config(), (SIZE, SIZE))[1]
    if name == "LHRCNN":
        return lhrcnn_tpudet_model(lhrcnn_config(mode="test"))[1]
    if name == "RefineDet320":
        return refine_common.tpudet_pair(JaxRefineDet320, RefineDet320)[1]
    return seeded_pair(JaxRetinaNet, retina_config(), (SIZE, SIZE))[1]


# the kinds of kernel leaf each family must hold, so that every branch of
# ``to_flax`` is crossed
KERNELS = {"CenterNet": {"conv", "dconv"}, "RetinaNet": {"conv"},
           "LHRCNN": {"conv", "depthwise", "pointwise", "roi_feat_dense", "rcnn_pconf",
                      "rcnn_pbbox"},
           "RefineDet320": {"conv", "dconv"}}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_to_flax_inverts_from_flax_leaf_for_leaf(name):
    variables = tpudet_variables(name)
    back = torch_flax_init.to_flax(transfer.from_flax(variables), variables)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    kinds = set()
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, np.asarray(w)), path
        if path[-1].key == "kernel":
            kinds.add(path[-2].key)
    assert kinds == KERNELS[name]


def test_to_flax_refuses_a_leaf_the_template_lacks():
    variables = tpudet_variables("CenterNet")
    state = transfer.from_flax(variables)
    with pytest.raises(KeyError, match="no flax leaf"):
        torch_flax_init.to_flax(dict(state, **{"extra.weight": torch.zeros(1, 1, 1, 1)}),
                                variables)


@pytest.fixture(scope="module")
def centernet_nets():
    """A bfloat16 and a float32 CenterNet at 64x64 with tpudet's numpy
    variables and BatchNorm statistics, and an image."""
    variables = tpudet_variables("CenterNet")
    nets = {}
    for dtype in ("bfloat16", "float32"):
        pm = CenterNet(centernet_config(compute_dtype=dtype), device="cpu")
        transfer.load_flax(pm.net, variables)
        nets[dtype] = pm
    image = np.random.default_rng(5).uniform(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    return nets, image


def _outputs(pm, image):
    pm.net.eval()
    with torch.no_grad():
        x = torch.from_numpy(image.transpose(0, 3, 1, 2).copy())
        return [t.clone() for t in pm.net(pm._preprocess(x))]


def test_carry_state_is_bit_for_bit_in_a_bfloat16_net(variants, centernet_nets):
    nets, image = centernet_nets
    for dtype, pm in nets.items():
        carry = variants.carry_state(pm.net.state_dict())
        for k, v in carry.items():
            assert v.dtype == (torch.bfloat16 if v.dim() >= 2 else torch.float32), k
        assert any(v.dim() == 1 for v in carry.values())
        fresh = CenterNet(centernet_config(compute_dtype=dtype), device="cpu")
        fresh.net.load_state_dict(carry, strict=True)
        want, got = _outputs(pm, image), _outputs(fresh, image)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        # bfloat16 casts every kernel before use; float32 computes with the
        # unrounded kernels, so the copy moves its outputs
        assert same == (dtype == "bfloat16"), dtype
        if dtype == "bfloat16":
            decodes = pm.test_one_image(image), fresh.test_one_image(image)
            assert len(decodes[0][0]) > 0
            for a, b in zip(*decodes):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_write_carry_copies_the_newest_checkpoint(variants, tmp_path):
    """``write_carry(NAME)`` reads the run's newest ``ckpt-*.pt`` (not an
    older one) and writes ``carry.pt`` beside it: its ``state_dict`` through
    ``carry_state``, without the optimizer's state."""
    from tpudet_torch.runtime import checkpoint

    run = tmp_path / "torch_runs" / "CenterNet-tpudet-init"
    rng = np.random.default_rng(2)
    states = {step: {"a.conv.weight": torch.from_numpy(rng.normal(size=(4, 3, 3, 3))
                                                        .astype(np.float32)),
                     "a.bn.mean": torch.from_numpy(rng.normal(size=4).astype(np.float32))}
              for step in (500, 1000)}
    for step, state in states.items():
        checkpoint.save_state(str(run / "ckpt"), {"state_dict": state, "global_step": step,
                                                  "opt_state": {"velocity": state}}, step)
    out = variants.write_carry("CenterNet-tpudet-init", str(tmp_path))
    assert out == str(run / "carry.pt")
    got = torch.load(out)
    want = variants.carry_state(states[1000])
    assert got.keys() == want.keys() == states[1000].keys()
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in ((got[k], want[k]) for k in want))
    assert got["a.conv.weight"].dtype == torch.bfloat16
