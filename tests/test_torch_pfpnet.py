"""The port's PFPNet-R slice against tpudet's on the same numpy inputs.

PFPNet shares RefineDet's head, loss and decode (``tests/test_torch_refine.py``);
here are its own pieces: the MSCA pyramid's flax average pooling and
align-corners bilinear downscales, its bfloat16 dtype promotion, the unused
VGG block 5 that weight decay still moves, and the whole model. Whole-model
tolerances are in ``tests/torch_refine_common.py``; the pooling and the
resize are the same float32 operations on both sides, equal to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.heads import refine as jax_refine
from tpudet.models.refinedet import PFPNetR as JaxPFPNet
from tpudet.nn import layers as jax_layers
from tpudet_torch.heads import refine as t_refine
from tpudet_torch.models import PFPNetR
from tpudet_torch.nn import layers as t_layers
from tpudet_torch.runtime import transfer
from torch_refine_common import (check_eval_forward, check_grads, check_test_one_image,
                                 check_tpudet_file, check_train_step, config, nchw, nhwc,
                                 port_model, rel, tpudet_pair)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ac_layout(monkeypatch):
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")


@pytest.mark.parametrize("size,dtype", [((5, 5), "float32"), ((8, 8), "float32"),
                                        ((7, 4), "float32"), ((9, 9), "bfloat16")])
def test_avg_pool_same_matches_flax(size, dtype):
    """2x2 stride 2 with flax's divisor: the zero padding counts. float32 to
    1e-6; bfloat16 to 1e-2 normwise (flax sums the window in bf16, rounding
    after each add, and torch rounds the float sum once: one bf16 ulp)."""
    x = np.random.default_rng(1).normal(size=(2, *size, 3)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_layers.avg_pool_same(jx, 2, 2), np.float32)
    got = t_layers.avg_pool_same(nchw(np.asarray(jx, np.float32)).to(getattr(torch, dtype)),
                                 2, 2)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    else:
        assert rel(nhwc(got), want) < 1e-2


def test_avg_pool_same_counts_the_padding():
    ones = t_layers.avg_pool_same(torch.ones(1, 1, 5, 5), 2, 2)[0, 0]
    assert ones[0, 0] == 1.0 and ones[0, 2] == 0.5 and ones[2, 2] == 0.25


@pytest.mark.parametrize("size_in,size_out,dtype", [
    ((40, 40), (20, 20), "float32"), ((40, 40), (5, 5), "float32"),
    ((8, 8), (1, 1), "float32"), ((9, 6), (4, 3), "float32"), ((6, 6), (6, 6), "float32"),
    ((40, 40), (10, 10), "bfloat16")])
def test_resize_bilinear_align_matches_tpudet(size_in, size_out, dtype):
    """align_corners=True, equal to 1e-6; bf16 in gives float32 out on both
    sides (the same size returns the input)."""
    x = np.random.default_rng(2).normal(size=(2, *size_in, 3)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax_refine._resize_bilinear_align(jx, *size_out)
    got = t_refine._resize_bilinear_align(
        nchw(np.asarray(jx, np.float32)).to(getattr(torch, dtype)), *size_out)
    out_dtype = dtype if size_in == size_out else "float32"
    assert want.dtype == getattr(jnp, out_dtype) and got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_pfpnet_rejects_sizes_that_are_not_multiples_of_64():
    with pytest.raises(ValueError, match="multiple of 64"):
        PFPNetR(config(input_size=320 + 32), device="cpu")
    with pytest.raises(AssertionError):
        JaxPFPNet(config(input_size=320 + 32))


# ------------------------------------------------------------ the whole model
@pytest.fixture(scope="module")
def pair():
    return tpudet_pair(JaxPFPNet, PFPNetR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pfpnet_levels_match_tpudet(pair, dtype):
    """Eval mode after ``load_flax``: the 16 per-level outputs. In bfloat16
    the downscales come out float32, so levels 2-4 are float32 where the
    ARMs and TCBs take them, and level 1 is bfloat16, as in tpudet."""
    jm, variables, image = pair
    seen = {}
    pm = port_model(PFPNetR, variables, mode="test", compute_dtype=dtype)
    for i in range(4):
        getattr(pm.net, f"arm{i + 1}").register_forward_pre_hook(
            lambda m, a, i=i: seen.__setitem__(i, a[0].dtype))
    with torch.no_grad():
        pm.net(nchw(image))
    want = {"float32": [torch.float32] * 4,
            "bfloat16": [torch.bfloat16] + [torch.float32] * 3}[dtype]
    assert [seen[i] for i in range(4)] == want
    assert pm.net.feature_extractor.out_channels == (767,) * 4
    check_eval_forward(jm, PFPNetR, variables, image, dtype)


def test_test_one_image_matches_tpudet(pair):
    jm, variables, image = pair
    check_test_one_image(jm, PFPNetR, variables, image)


def test_train_step_matches_tpudet_and_moves_the_unused_conv5(pair):
    """One float32 step; VGG block 5, whose output PFPNet drops, moves by
    weight decay and momentum alone, as in tpudet: ``p - lr (0.9 v + wd p)``."""
    jm, variables, _ = pair
    want, got, v0 = check_train_step(jm, PFPNetR, variables, lr=0.01, wd=1e-4)
    conv5 = [k for k in want if ".vgg.conv5_" in k]
    assert len(conv5) == 6
    p0 = transfer.from_flax(variables)
    for k in conv5:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-9)
        expect = p0[k] - 0.01 * (0.9 * v0[k] + 1e-4 * p0[k])
        np.testing.assert_allclose(got[k].numpy(), expect.numpy(), rtol=1e-6, atol=1e-9)
        assert not torch.equal(got[k], p0[k])


def _pyramid_key(name):
    """A kernel or BatchNorm scale of the MSCA pyramid (``fl*``, ``up*``), or
    one of the two L2-norm scales; not the conv biases before a BatchNorm,
    whose gradient is zero in exact arithmetic."""
    parts = name.split(".")
    if parts[0] != "feature_extractor":
        return False
    if parts[1] in ("feat1_l2_norm", "feat2_l2_norm"):
        return True
    return (parts[1].startswith(("fl", "up"))
            and parts[2:] in (["conv", "weight"], ["dconv", "weight"], ["bn", "scale"]))


def test_pyramid_gradients_match_tpudet_per_tensor():
    """float32 at 128x128, batch 4 (the top level 2x2): the loss's gradient
    of every pyramid kernel and BatchNorm scale and of both L2 scales, each
    held on its own against tpudet's (``check_grads``): 16 ConvBNs, 6
    deconvolutions, 2 scales."""
    held = check_grads(JaxPFPNet, PFPNetR, _pyramid_key)
    assert len(held) == 2 * 16 + 2 * 6 + 2


def test_tpudet_checkpoint_loads_into_the_port(tmp_path, pair):
    jm, variables, image = pair
    check_tpudet_file(tmp_path, jm, PFPNetR, variables, image)


def test_pfpnet_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PFPNetR(config(compute_dtype="bfloat16"))
