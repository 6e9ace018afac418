"""The port's entry point and bench (``entry_torch.py``, ``bench_torch.py``)
against tpudet's (``__graft_entry__.py``, ``bench.py``), on the CPU.

``entry`` is compared at input 76 (the SSD tests' size: its pools and
stride-2 convolutions pad asymmetrically as at 300) within the SSD tests'
tolerance, 1e-4: oneDNN and XLA sum the convolutions in other orders.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import bench as jax_bench
import bench_torch
import entry_torch
from tpudet_torch.models import ssd as t_ssd
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel
from tpudet_torch.runtime import transfer

torch.set_num_threads(1)


def test_entry_matches_tpudets_entry_after_from_flax():
    jfn, (jarg,) = jax_entry.entry()
    variables = inspect.getclosurevars(jfn).nonlocals["variables"]
    fn, (arg,) = entry_torch.entry(device="cpu")
    assert arg.shape == (1, 3, 300, 300) and arg.dtype == torch.float32
    assert float(arg.abs().sum()) == 0.0 and jarg.shape == (1, 300, 300, 3)
    assert not fn.training and next(fn.parameters()).device.type == "cpu"
    transfer.load_flax(fn, variables)
    x = np.random.default_rng(0).normal(0, 50, (1, 76, 76, 3)).astype(np.float32)
    want = jax.jit(jfn)(jnp.asarray(x))
    with torch.no_grad():
        got = fn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_torch.entry()


def test_bench_batch_and_config_are_tpudets(monkeypatch):
    """The same images, gt and config as ``bench.py``'s ``_build_model``."""
    captured = {}

    class Capture:
        input_size = 300

        def __init__(self, config, provider, device=None):
            captured["config"] = config

    monkeypatch.setattr(t_ssd, "SSD300", Capture)
    _, images, gt = bench_torch._build_model(2)
    want_images, want_gt = None, None

    import tpudet.models.ssd as jax_ssd_models

    class JaxCapture:
        input_size = 300

        def __init__(self, config, provider):
            nonlocal want_images, want_gt
            captured["jax_config"] = config
            want_images, want_gt = next(provider["train_generator"][1])

    monkeypatch.setattr(jax_ssd_models, "SSD300", JaxCapture)
    jax_bench._build_model(2)
    assert captured["config"] == captured["jax_config"]
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(gt, want_gt)
    assert (bench_torch.BATCH, bench_torch.STEPS) == (jax_bench.BATCH, jax_bench.STEPS)


class SSD76(t_ssd.SSD300):
    input_size = 76


def test_bench_runs_on_the_cpu_and_prints_one_json_line_last(monkeypatch, capsys):
    """Batch 2, 1 timed step and a scanned epoch of 2 at input 76: the last
    line of standard output is the result; on the CPU no kernel launches."""
    monkeypatch.setattr(t_ssd, "SSD300", SSD76)
    real_scan = bench_torch._time_scan
    monkeypatch.setattr(bench_torch, "_time_scan",
                        lambda m, i, g, steps: real_scan(m, i, g, 2))
    launches = (nms_kernel.launches, assign_kernel.launches)
    result = bench_torch.main(batch=2, steps=1, device="cpu")
    assert (nms_kernel.launches, assign_kernel.launches) == launches
    last = capsys.readouterr().out.rstrip("\n").splitlines()[-1]
    assert json.loads(last) == result
    assert set(result) == {"metric", "value", "unit", "scan_epoch_imgs_per_sec", "device"}
    assert result["metric"] == "ssd300_train_imgs_per_sec_per_chip_bs2_bf16"
    assert result["value"] > 0 and result["scan_epoch_imgs_per_sec"] > 0
    assert result["device"] == "cpu"


def test_bench_refuses_steps_that_skip_a_kernel(monkeypatch):
    """On the card each counter must move once a step; a step that moves
    none is refused."""
    fake = type("M", (), {"device": torch.device("cuda")})()
    before = bench_torch._launches()
    with pytest.raises(RuntimeError, match="each should move by 3"):
        bench_torch._check_launches(fake, before, 3)
    monkeypatch.setattr(nms_kernel, "launches", nms_kernel.launches + 3)
    monkeypatch.setattr(assign_kernel, "launches", assign_kernel.launches + 3)
    bench_torch._check_launches(fake, before, 3)
