"""The port's per-model bench and headline repeater
(``scripts/bench_all_torch.py``, ``scripts/bench_headline_torch.py``) against
tpudet's (``scripts/bench_all.py``, ``scripts/bench_headline.py``), on the CPU.

The FLOP count of a step is held against a count made here from the output
shapes of the net's convolutions: a backward costs twice the forward (the
input's gradient and the weight's), except for the first convolution, whose
input, the image, needs no gradient. The two must agree exactly.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import tpudet_torch.models as t_models
from tpudet_torch.models import ssd as t_ssd
from tpudet_torch.ops.cuda import assign_kernel, nms_kernel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(name, module_name):
    spec = importlib.util.spec_from_file_location(module_name, REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    return _load("bench_all_torch.py", "_bench_all_torch")


class SSD76(t_ssd.SSD300):
    input_size = 76


def small_spec(bench):
    """SSD300's spec at input 76 and batch 2."""
    spec = bench._specs()["SSD300"]
    return dict(spec, batch=2, shape=(76, 76), config=dict(spec["config"], batch_size=2))


def test_specs_are_tpudets(bench):
    jax_bench = _load("bench_all.py", "_jax_bench_all")
    assert bench._specs() == jax_bench._specs()
    assert set(bench.KERNELS_A_STEP) <= set(bench._specs())


def test_bench_model_on_the_cpu_gives_every_field(bench, monkeypatch):
    """SSD300 at 76, batch 2, 1 timed step and 1 request: tpudet's fields and
    the port's, a finite loss, and no kernel launch on the CPU."""
    monkeypatch.setattr(t_models, "SSD300", SSD76)
    launches = (nms_kernel.launches, assign_kernel.launches)
    result = bench.bench_model("SSD300", small_spec(bench), train_steps=1, latency_runs=1,
                               device="cpu")
    assert (nms_kernel.launches, assign_kernel.launches) == launches
    assert set(result) == {"compile_plus_warmup_s", "train_step_ms", "train_imgs_per_sec",
                           "loss_finite", "kernel_launches", "train_step_tflop", "mfu_pct",
                           "mfu_peak_tflops", "flop_count", "infer_p50_ms", "device"}
    assert result["loss_finite"] is True and result["device"] == "cpu"
    assert result["kernel_launches"] == {"steps": 1, "assign": 0, "nms_scan": 0,
                                         "nms_continue": 0}
    assert result["train_step_ms"] > 0 and result["infer_p50_ms"] > 0
    assert result["train_step_tflop"] > 0 and result["mfu_pct"] >= 0
    assert result["mfu_peak_tflops"] == 989.4


def conv_flops(net, images):
    """FLOPs of the forward's convolutions, from their output shapes, and of
    the first one alone."""
    counts = []

    def hook(module, args, out):
        k = module.kernel_size[0] * module.kernel_size[1]
        counts.append(2 * out.numel() * module.in_channels // module.groups * k)

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            net(images)
    finally:
        for h in handles:
            h.remove()
    assert not any(isinstance(m, (nn.Linear, nn.ConvTranspose2d)) for m in net.modules())
    return sum(counts), counts[0]


def test_step_flops_are_three_forwards_less_the_images_gradient(bench):
    """SSD300 at 76, batch 2, bf16: the step's count equals 3x the forward's
    convolutions less the first convolution's input gradient, exactly."""
    spec = small_spec(bench)
    model = SSD76(dict(spec["config"]), None, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 76, 76, 3)).astype(np.float32)
    gt = -np.ones((2, 60, 5), np.float32)
    gt[:, 0] = [38, 38, 22.8, 19, 7]
    x, g = model._to_device(images, gt)
    model.net.train()
    forward, first = conv_flops(model.net, model._preprocess(x))
    assert bench.step_flops(model, x, g) == 3 * forward - first


def test_launch_counts_are_checked_by_design(bench, monkeypatch):
    """On the card each family's counters must move by its launches a step;
    the pools' continuation launches are reported beside the scans."""
    cuda = torch.device("cuda")
    before = bench._counts()
    with pytest.raises(RuntimeError, match="1 assignments and 1 sorted scans a step"):
        bench._launches("SSD300", cuda, before, 3)
    monkeypatch.setattr(assign_kernel, "launches", assign_kernel.launches + 3)
    monkeypatch.setitem(nms_kernel.launches_by_path, "scan",
                        nms_kernel.launches_by_path["scan"] + 3)
    monkeypatch.setitem(nms_kernel.launches_by_path, "continue",
                        nms_kernel.launches_by_path["continue"] + 3)
    got = bench._launches("SSD300", cuda, before, 3)
    assert got == {"steps": 3, "assign": 3, "nms_scan": 3, "nms_continue": 3}
    with pytest.raises(RuntimeError, match="0 assignments and 2 sorted scans"):
        bench._launches("LHRCNN", cuda, before, 3)
    with pytest.raises(RuntimeError, match="0 assignments and 0 sorted scans"):
        bench._launches("YOLOv2", cuda, before, 3)


def test_main_records_an_error_keeps_going_and_exits_1(bench, monkeypatch, tmp_path):
    def fake(name, spec, device=None):
        if name == "FCOS":
            raise ValueError("no card")
        return {"train_imgs_per_sec": 1.0}

    monkeypatch.setattr(bench, "bench_model", fake)
    out = tmp_path / "details.json"
    assert bench.main(["FCOS", "SSD300"], out=str(out), device="cpu") == 1
    got = json.loads(out.read_text())
    assert got["SSD300"] == {"train_imgs_per_sec": 1.0}
    assert "no card" in got["FCOS"]["error"]
    assert bench.main(["SSD300"], out=str(out), device="cpu") == 0
    assert set(json.loads(out.read_text())) == {"FCOS", "SSD300"}  # merged


def test_headline_median_and_spread_on_a_stub(tmp_path, capsys):
    """Three runs of a stub that prints a log line, then bench_torch's JSON
    line with 100, 120 and 90: every sample kept in order, the median 100,
    the spread (120 - 90) / 100."""
    headline = _load("bench_headline_torch.py", "_bench_headline_torch")
    counter = tmp_path / "n"
    stub = tmp_path / "stub.py"
    stub.write_text(
        "import json, pathlib\n"
        f"p = pathlib.Path({str(counter)!r})\n"
        "i = int(p.read_text()) if p.exists() else 0\n"
        "p.write_text(str(i + 1))\n"
        "print('{not json')\n"
        "print(json.dumps({'metric': 'm', 'value': [100.0, 120.0, 90.0][i],"
        " 'unit': 'images/sec/chip', 'scan_epoch_imgs_per_sec': 1.0, 'device': 'd'}))\n")
    out = tmp_path / "headline.json"
    result = headline.main(3, command=[sys.executable, str(stub)], out=str(out))
    assert result["samples"] == [100.0, 120.0, 90.0]
    assert result["median"] == 100.0 and result["spread_pct"] == 30.0
    assert "vs_baseline" not in result and result["device"] == "d"
    assert json.loads(out.read_text()) == result
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
