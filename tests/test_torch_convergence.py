"""The port's convergence script (``scripts/train_convergence_torch.py``)
against tpudet's SSD300 path of ``scripts/train_convergence.py``.

The spec and the loop's schedule are compared exactly: both scripts'
``run_model`` drive a stand-in model that records each epoch's steps and lr,
over stand-ins for the dataset, the feeder and the evaluation. Then the port's
script runs for real on the CPU at a tiny size: 76x76, 16 train and 4 test
scenes, 2 steps, batch 4 (the spec's 32 exceeds 16 scenes, and bf16 at
batch 32 on one CPU thread would take minutes a step).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tpudet.data.device_dataset as jax_device_dataset
import tpudet.runtime.evaluate as jax_evaluate
import tpudet_torch.data.device_dataset as t_device_dataset
import tpudet_torch.runtime.evaluate as t_evaluate

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(name, module_name):
    spec = importlib.util.spec_from_file_location(module_name, REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return (_load("train_convergence.py", "_jax_train_convergence"),
            _load("train_convergence_torch.py", "_torch_train_convergence"))


def test_ssd300_spec_equals_tpudets(scripts):
    """Config, input, base lr, steps and schedule; the class is the port's."""
    jax_tc, tc = scripts
    want = jax_tc.model_specs()["SSD300"]
    got = tc.model_specs()["SSD300"]
    assert got[0] == want[0].replace("tpudet.", "tpudet_torch.", 1)
    assert got[1:] == want[1:]
    assert tc._load_class(got[0]).__module__ == "tpudet_torch.models.ssd"
    assert list(tc.model_specs()) == ["SSD300"]


class _Feeder:
    def __init__(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _fake_model(epochs):
    class Model:
        def __init__(self, config, provider, device=None):
            self.batch = config["batch_size"]
            self.num_train = provider["num_train"]
            self.train_initializer = "reset"

        def train_one_epoch(self, lr):
            assert self.train_initializer is None
            epochs.append((self.num_train // self.batch, lr))
            return 1.0

        def save_weight(self, mode, path):
            pass

    return Model


@pytest.mark.parametrize("smoke", [False, True])
def test_the_loop_takes_tpudets_steps_at_tpudets_lr(monkeypatch, tmp_path, scripts, smoke):
    """Every epoch's steps and lr, in order (4000 steps, or the smoke run's
    60), the files written, and the result's keys."""
    jax_tc, tc = scripts
    images = np.zeros((4, 8, 8, 3), np.uint8)
    gt = -np.ones((4, 60, 5), np.float32)
    monkeypatch.setattr(tc.synthvoc, "build", lambda *a, **k: str(tmp_path))
    monkeypatch.setattr(tc.synthvoc, "load", lambda d: (images, gt, images, gt))
    monkeypatch.setattr(tc.synthvoc, "test_records", lambda d: iter([]))
    monkeypatch.setattr(jax_device_dataset, "DeviceDataset", _Feeder)
    monkeypatch.setattr(t_device_dataset, "DeviceDataset", _Feeder)
    monkeypatch.setattr(jax_evaluate, "evaluate_model", lambda m, r: (0.5, {3: 0.5}))
    monkeypatch.setattr(t_evaluate, "evaluate_model", lambda m, r: (0.5, {3: 0.5}))
    monkeypatch.setattr(jax_tc, "RUNS_ROOT", str(tmp_path / "jax"))
    runs = {}
    for side, module, kwargs in ((("tpudet", jax_tc, {})),
                                 ("port", tc, {"root": str(tmp_path / "port"), "device": "cpu"})):
        epochs = []
        monkeypatch.setattr(module, "_load_class", lambda path: _fake_model(epochs))
        result = module.run_model("SSD300", smoke=smoke, **kwargs)
        runs[side] = epochs, result
    (want, want_result), (got, got_result) = runs["tpudet"], runs["port"]
    assert got == want
    assert sum(n for n, _ in got) == (60 if smoke else 4000)
    if not smoke:
        lrs = [lr for n, lr in got for _ in range(n)]
        assert (lrs[0], lrs[200], lrs[2999], lrs[3000], lrs[3999]) == (
            1e-4, 1e-3, 1e-3, 1e-4, 1e-5)
    assert set(got_result) == set(want_result) | {"device"}
    name = "probe_result.json" if smoke else "result.json"
    run_dir = tmp_path / "port" / "torch_runs" / "SSD300"
    assert json.loads((run_dir / name).read_text())["mAP@0.5_voc07"] == 0.5
    curve = [json.loads(ln) for ln in (run_dir / "curve.jsonl").read_text().splitlines()]
    assert [c["step"] for c in curve] == list(np.cumsum([n for n, _ in got]))


def test_a_tiny_run_on_the_cpu_writes_a_probe_result(monkeypatch, tmp_path, scripts):
    _, tc = scripts
    real = tc.model_specs

    def specs():
        path, hw, config, lr, steps, schedule = real()["SSD300"]
        return {"SSD300": (path, hw, dict(config, batch_size=4), lr, steps, schedule)}

    monkeypatch.setattr(tc, "model_specs", specs)
    result = tc.run_model("SSD300", steps_scale=2 / 4000, root=str(tmp_path),
                          n_train=16, n_test=4, size=(76, 76), device="cpu")
    run_dir = tmp_path / "torch_runs" / "SSD300"
    assert json.loads((run_dir / "probe_result.json").read_text()) == result
    assert not (run_dir / "result.json").exists()
    assert result["steps"] == 2 and result["input"] == [76, 76]
    assert result["eval_images"] == 4 and result["device"] == "cpu"
    assert 0.0 <= result["mAP@0.5_voc07"] <= 1.0
    curve = [json.loads(ln) for ln in (run_dir / "curve.jsonl").read_text().splitlines()]
    assert [(c["step"], c["lr"]) for c in curve] == [(1, 1e-4), (2, 1e-3)]
    assert all(np.isfinite(c["mean_loss"]) for c in curve)
    assert (run_dir / "ckpt-2.pt").is_file()
    assert sorted(p.name for p in (tmp_path / "data" / "76x76").iterdir()) == [
        "DONE", "test_gt.npy", "test_images.npy", "train_gt.npy", "train_images.npy"]
