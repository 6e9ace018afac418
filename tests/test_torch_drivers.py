"""The port's drivers (``drivers_torch/``) against tpudet's (``drivers/``).

Both directories hold a module named ``_common``; tpudet's drivers import it
as ``from _common import run`` after putting ``drivers/`` on the path, the
port's import ``drivers_torch._common``. So the drivers are loaded here by
file path under module names of their own, and tpudet's ``_common`` is a
stand-in put into ``sys.modules`` for the load only.
"""

import ast
import importlib.util
import os
import runpy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import drivers_torch._common as t_common
from tpudet_torch.models import base as t_base
from tpudet_torch.models import ssd as t_ssd
from tpudet_torch.runtime import config as config_lib

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MINI = REPO / "tests" / "torch_data" / "voc_mini"
# driver file -> the model class it trains
DRIVERS = {"testSSD300.py": "SSD300", "testSSD512.py": "SSD512",
           "testYOLOv2.py": "YOLOv2", "testYOLOv3.py": "YOLOv3",
           "testcenternet.py": "CenterNet", "testfcos.py": "FCOS",
           "testlhrcnn.py": "LHRCNN", "testpfpnet.py": "PFPNetR",
           "testrefinedet.py": "RefineDet320", "testretinanet.py": "RetinaNet"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recorder(calls):
    def run(model_cls, *args, **kwargs):
        calls.append((model_cls.__name__, args, kwargs))
    return run


def _run_calls(monkeypatch, side, name):
    """The driver's module and the ``run`` calls its ``__main__`` makes."""
    calls = []
    if side == "tpudet":
        fake = types.ModuleType("_common")
        fake.run = _recorder(calls)
        monkeypatch.setitem(sys.modules, "_common", fake)
        path = REPO / "drivers" / name
    else:
        monkeypatch.setattr(t_common, "run", _recorder(calls))
        path = REPO / "drivers_torch" / name
    module = _load(path, f"_{side}_driver_{name[:-3]}")
    if name != "testSSD300.py":  # its main() trains at once; compared by source
        runpy.run_path(str(path), run_name="__main__")
    return module, calls


def _main_source(path: Path) -> str:
    tree = ast.parse(path.read_text())
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return ast.dump(main)


def test_every_tpudet_driver_has_a_counterpart():
    names = {p.name for p in (REPO / "drivers").glob("*.py")}
    assert len(names) == 13
    assert names == {p.name for p in (REPO / "drivers_torch").glob("*.py")}
    assert set(DRIVERS) == {n for n in names if n.startswith("test")} - {
        "test_voc_utils.py", "test_imagenet_utils.py"}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_dicts_and_run_arguments_equal_tpudets(monkeypatch, name):
    """Both dicts key for key and value for value, the ``run`` call's
    arguments (testSSD300.py: its constants and ``main``'s source), the model
    class, and the config passes the port's ``validate`` for that class."""
    want, want_calls = _run_calls(monkeypatch, "tpudet", name)
    got, got_calls = _run_calls(monkeypatch, "port", name)
    assert got.config == want.config
    assert got.image_augmentor_config == want.image_augmentor_config
    cls = DRIVERS[name]
    config_lib.validate(got.config, cls)
    if name == "testSSD300.py":
        for key in ("lr", "batch_size", "buffer_size", "epochs", "reduce_lr_epoch",
                    "ckpt_path"):
            assert getattr(got, key) == getattr(want, key), key
        assert got.SSD300.__module__.startswith("tpudet_torch.")
        assert (_main_source(REPO / "drivers_torch" / name)
                == _main_source(REPO / "drivers" / name))
    else:
        assert len(got_calls) == 1 and got_calls == want_calls
        assert got_calls[0][0] == cls
        assert getattr(got, cls).__module__.startswith("tpudet_torch.")


def test_importing_a_driver_does_nothing(monkeypatch):
    """No listing of a directory, no model, no loader, no ``run``."""
    def refuse(*a, **k):
        raise AssertionError("a driver did work when it was imported")

    monkeypatch.setattr(os, "listdir", refuse)
    monkeypatch.setattr(t_base.DetectorBase, "__init__", refuse)
    monkeypatch.setattr(t_common, "run", refuse)
    monkeypatch.setattr(t_common.voc_utils, "get_generator", refuse)
    for path in sorted((REPO / "drivers_torch").glob("*.py")):
        _load(path, f"_port_import_{path.stem}")


class SSD76(t_ssd.SSD300):
    input_size = 76


def test_common_run_trains_ssd300_on_the_mini_voc_set(monkeypatch, tmp_path, capsys):
    """The mini VOC set through the port's ``test_voc_utils`` driver (5
    shards under ./data/), then one epoch of ``_common.run`` at input 76,
    batch 2, without ``vgg_16.ckpt``: a finite epoch loss and a ``.pt``
    checkpoint."""
    voc = tmp_path / "VOC2007"
    voc.mkdir()
    for sub in ("Annotations", "JPEGImages"):
        (voc / sub).symlink_to(MINI / sub)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(str(REPO / "drivers_torch" / "test_voc_utils.py"), run_name="__main__")
    assert len(os.listdir("./data/")) == 5

    driver = _load(REPO / "drivers_torch" / "testSSD300.py", "_port_driver_ssd300")
    config = dict(driver.config, batch_size=2, pretraining_weight=None)
    aug = dict(driver.image_augmentor_config, output_shape=[76, 76])
    model = t_common.run(SSD76, config, aug, [76, 76, 3], data_dir="./data/",
                         num_train=8, batch_size=2, epochs=1, lr=0.01,
                         save_path=str(tmp_path / "ssd" / "test"), device="cpu")
    assert model.device.type == "cpu" and model.global_step == 4
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(">> mean loss")]
    assert np.isfinite(float(line.split()[-1])), line
    assert (tmp_path / "ssd" / "test-4.pt").is_file()
