"""The port's convergence script (``scripts/train_convergence_torch.py``)
against tpudet's (``scripts/train_convergence.py``).

Every one of tpudet's 24 specs is compared exactly: both scripts'
``run_model`` drive a stand-in model that records each epoch's steps and lr,
over stand-ins for the dataset, both feeders and the evaluation, so the
epochs, the feeder each spec builds (with its arguments and gt width), the
config the model gets, the curve, the periodic checkpoints, ``--resume``,
``--eval-every`` and ``--eval-only`` are held against tpudet's. The stall
watchdog runs in a subprocess. ``MemmapFeeder``'s batches and the losslessness
of ``gt_pad`` are held on numpy inputs, and the script runs for real on the CPU
at a tiny size: SSD300 at 76x76 and RefineDet320 at 64x64 through the host
feed and ``gt_pad``, 16 train and 4 test scenes, 2 steps, batch 4 (the specs'
32 exceed 16 scenes, and bf16 at batch 32 on one CPU thread would take minutes
a step).
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudet.data.device_dataset as jax_device_dataset
import tpudet.runtime.evaluate as jax_evaluate
import tpudet_torch.data.device_dataset as t_device_dataset
import tpudet_torch.runtime.evaluate as t_evaluate
from tpudet.heads import refine as jax_refine
from tpudet_torch.heads import refine as t_refine
from tpudet_torch.models.refinedet import PFPNetR, _refine_feat_shapes
from torch_refine_common import gt_rows

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# every spec name of tpudet's script, in its order
SPEC_NAMES = [
    "SSD300", "SSD512", "YOLOv2", "YOLOv3", "YOLOv3-consistent", "YOLOv2-consistent",
    "RetinaNet", "RetinaNet-long", "CenterNet-long", "RefineDet320", "PFPNetR",
    "RefineDet320-pad60", "LHRCNN", "CenterNet", "FCOS", "FCOS-long", "FCOS-long2",
    "FCOS-long3", "RefineDet320-long", "LHRCNN-long", "FCOS-consistent", "LHRCNN-long2",
    "PFPNetR-pad60", "PFPNetR-long"]


def _load(name, module_name):
    spec = importlib.util.spec_from_file_location(module_name, REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return (_load("train_convergence.py", "_jax_train_convergence"),
            _load("train_convergence_torch.py", "_torch_train_convergence"))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_ssd300_spec_equals_tpudets(scripts, name):
    """Each spec: config, input, base lr, steps and schedule equal tpudet's;
    the class is the port's."""
    jax_tc, tc = scripts
    want = jax_tc.model_specs()[name]
    got = tc.model_specs()[name]
    assert got[0] == want[0].replace("tpudet.", "tpudet_torch.", 1)
    assert got[1:] == want[1:]
    assert tc._load_class(got[0]).__module__ == want[0].rsplit(".", 1)[0].replace(
        "tpudet.", "tpudet_torch.", 1)


def test_spec_names_and_all_equal_tpudets(scripts):
    jax_tc, tc = scripts
    assert list(tc.model_specs()) == list(jax_tc.model_specs()) == SPEC_NAMES
    assert tc.ALL == jax_tc.ALL


# ------------------------------------------------------------ the stand-ins
class _Cut(Exception):
    """A run cut off in the middle of an epoch."""


def _feeder_class(made, kind):
    class Feeder:
        def __init__(self, images, gt, batch, **kwargs):
            kwargs.pop("device", None)  # the port's, on every DeviceDataset
            made.append((kind, images.shape, gt.shape, batch, kwargs))

        def close(self):
            pass

    return Feeder


def _fake_model(epochs, configs, cut_at=None):
    """A model that records each epoch's (steps, lr) and its config, writes
    an empty ``{path}-{step}.pt`` for ``save_weight``, takes ``global_step``
    from ``ckpt_meta.json`` in ``load_weight``, and raises ``_Cut`` in the
    epoch that would pass step ``cut_at``."""

    class Model:
        def __init__(self, config, provider, device=None):
            configs.append(dict(config))
            self.batch = config["batch_size"]
            self.num_train = provider["num_train"]
            self.train_initializer = "reset"
            self.global_step = 0

        def train_one_epoch(self, lr):
            assert self.train_initializer is None
            n = self.num_train // self.batch
            if cut_at is not None and self.global_step + n > cut_at:
                raise _Cut(self.global_step)
            epochs.append((n, lr))
            self.global_step += n
            return 1.0

        def save_weight(self, mode, path):
            Path(f"{path}-{self.global_step}.pt").touch()

        def load_weight(self, path):
            with open(os.path.join(os.path.dirname(path), "ckpt_meta.json")) as f:
                self.global_step = json.load(f)["steps"]

    return Model


@pytest.fixture
def stand_ins(monkeypatch, tmp_path, scripts):
    """Both scripts over stand-ins. Returns ``run(side, fn, *args, **kwargs)``
    that calls ``fn`` of that side's script with its model stand-in and
    gives back the epochs, the models' configs, the feeders made and the
    result; the port's run directory is ``tmp_path/port/torch_runs``,
    tpudet's ``tmp_path/jax``."""
    jax_tc, tc = scripts
    images = np.zeros((4, 8, 8, 3), np.uint8)
    gt = -np.ones((4, 60, 5), np.float32)
    # tpudet's watchdog stays armed after a cut run: keep it from firing
    monkeypatch.setenv("STALL_LIMIT_S", "1e9")
    for module in (jax_tc, tc):
        monkeypatch.setattr(module.synthvoc, "build", lambda *a, **k: str(tmp_path))
        monkeypatch.setattr(module.synthvoc, "load", lambda d: (images, gt, images, gt))
        monkeypatch.setattr(module.synthvoc, "test_records", lambda d: iter([]))
    monkeypatch.setattr(jax_evaluate, "evaluate_model", lambda m, r: (0.5, {3: 0.5}))
    monkeypatch.setattr(t_evaluate, "evaluate_model", lambda m, r: (0.5, {3: 0.5}))
    monkeypatch.setattr(jax_tc, "RUNS_ROOT", str(tmp_path / "jax"))

    def run(side, fn, *args, cut_at=None, **kwargs):
        module, dataset = ((jax_tc, jax_device_dataset) if side == "tpudet"
                           else (tc, t_device_dataset))
        if side == "port":
            kwargs.update(root=str(tmp_path / "port"), device="cpu")
        epochs, configs, made = [], [], []
        monkeypatch.setattr(module, "_load_class",
                            lambda path: _fake_model(epochs, configs, cut_at))
        monkeypatch.setattr(module, "MemmapFeeder", _feeder_class(made, "memmap"))
        monkeypatch.setattr(dataset, "DeviceDataset", _feeder_class(made, "device"))
        try:
            result = getattr(module, fn)(*args, **kwargs)
        except _Cut:
            result = None
        return dict(epochs=epochs, configs=configs, made=made, result=result)

    return run


def test_training_pools_launches_are_recorded_apart_from_the_evaluations(
        stand_ins, monkeypatch, tmp_path):
    """The NMS kernel's launches in each chunk of training go into its curve
    record and their sum into the result, by design (``per_pick``: a training
    pool's full-width rerun); an evaluation's launches are not counted there.
    The stand-in launches as LH-RCNN does, two sorted scans a step, plus one
    rerun a chunk; an evaluation launches 5 reruns."""
    from tpudet_torch.ops.cuda import nms_kernel

    monkeypatch.setattr(nms_kernel, "launches_by_path", {"sorted_scan": 0, "per_pick": 0})
    real = _fake_model

    def launching(epochs, configs, cut_at=None):
        class Model(real(epochs, configs, cut_at)):
            def train_one_epoch(self, lr):
                nms_kernel.launches_by_path["sorted_scan"] += 2 * (self.num_train
                                                                   // self.batch)
                nms_kernel.launches_by_path["per_pick"] += 1
                return super().train_one_epoch(lr)
        return Model

    def evaluate_model(model, records):
        nms_kernel.launches_by_path["per_pick"] += 5
        return 0.5, {3: 0.5}

    monkeypatch.setattr(sys.modules[__name__], "_fake_model", launching)
    monkeypatch.setattr(t_evaluate, "evaluate_model", evaluate_model)
    got = stand_ins("port", "run_model", "LHRCNN", smoke=True, eval_every=30)
    curve = _lines(tmp_path / "port" / "torch_runs" / "LHRCNN" / "curve.jsonl")
    assert [c["nms_launches"] for c in curve] == [{"sorted_scan": 60, "per_pick": 1}] * 2
    assert got["result"]["train_nms_launches"] == {"sorted_scan": 120, "per_pick": 2}
    assert nms_kernel.launches_by_path == {"sorted_scan": 120, "per_pick": 2 + 5 * 3}


def _schedule_lrs(spec, smoke):
    """Each step's lr, from the spec's schedule alone."""
    _, _, _, base_lr, total, schedule = spec
    if smoke:
        total, schedule = 60, [(1.0, 1.0)]
    lrs = [base_lr * mult for frac, mult in schedule
           for _ in range(max(1, int(round(total * frac))))]
    return lrs[:total]


def _lines(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_the_loop_takes_tpudets_steps_at_tpudets_lr(tmp_path, scripts, stand_ins, name,
                                                    smoke):
    """Every epoch's steps and lr, in order; the feeder each spec builds
    (``MemmapFeeder`` for ``host_feed``, chunked ``DeviceDataset`` for
    ``chunk_bytes``, else resident), its arguments and the gt width it gets
    (24 under ``gt_pad``); the config the model gets; the files written and
    the result's keys."""
    jax_tc, tc = scripts
    want = stand_ins("tpudet", "run_model", name, smoke=smoke)
    got = stand_ins("port", "run_model", name, smoke=smoke)
    assert got["epochs"] == want["epochs"]
    assert [lr for n, lr in got["epochs"] for _ in range(n)] == _schedule_lrs(
        tc.model_specs()[name], smoke)
    assert got["made"] == want["made"] and len(got["made"]) == 1
    config = tc.model_specs()[name][2]
    kind, _, gt_shape, batch, kwargs = got["made"][0]
    assert kind == ("memmap" if config.get("host_feed") else "device")
    assert gt_shape[1] == config.get("gt_pad", 60) and batch == config["batch_size"]
    if "chunk_bytes" in config:
        assert kwargs["chunk_bytes"] == config["chunk_bytes"]
        assert kwargs["rotate_every"] == config["rotate_every"]
    assert got["configs"] == want["configs"]
    assert not set(got["configs"][0]) & set(tc.SCRIPT_KEYS)
    assert set(got["result"]) == set(want["result"]) | {"device", "train_nms_launches"}
    run_dir = tmp_path / "port" / "torch_runs" / name
    steps = sum(n for n, _ in got["epochs"])
    result_name = "result.json" if steps >= 500 and not smoke else "probe_result.json"
    assert json.loads((run_dir / result_name).read_text())["mAP@0.5_voc07"] == 0.5
    curve = _lines(run_dir / "curve.jsonl")
    assert [c["step"] for c in curve] == list(np.cumsum([n for n, _ in got["epochs"]]))
    assert json.loads((run_dir / "ckpt_meta.json").read_text())["steps"] == steps
    jax_dir = tmp_path / "jax" / name
    assert sorted(p.name for p in run_dir.glob("ckpt-*")) == sorted(
        p.name for p in jax_dir.glob("ckpt-*"))


def test_resume_after_a_cut_takes_tpudets_epochs_and_appends_its_curve(tmp_path, stand_ins):
    """A run cut at step 1225 (its last periodic checkpoint at 1000), then
    ``--resume``: the resumed epochs, the appended curve (steps and lrs),
    ``ckpt_meta.json`` and the checkpoints kept equal tpudet's."""
    name = "RefineDet320"
    runs = {}
    for side in ("tpudet", "port"):
        cut = stand_ins(side, "run_model", name, cut_at=1225)
        assert cut["result"] is None and sum(n for n, _ in cut["epochs"]) == 1200
        runs[side] = stand_ins(side, "run_model", name, resume=True)
    want, got = runs["tpudet"], runs["port"]
    assert got["epochs"] == want["epochs"]
    assert sum(n for n, _ in got["epochs"]) == 5000 - 1000
    port_dir = tmp_path / "port" / "torch_runs" / name
    jax_dir = tmp_path / "jax" / name
    curves = [[(c["step"], c["lr"]) for c in _lines(d / "curve.jsonl")]
              for d in (port_dir, jax_dir)]
    assert curves[0] == curves[1]
    assert curves[0][23:25] == [(1200, 5e-4), (1050, 5e-4)]  # appended after the cut
    assert (json.loads((port_dir / "ckpt_meta.json").read_text())["steps"]
            == json.loads((jax_dir / "ckpt_meta.json").read_text())["steps"] == 5000)
    assert sorted(p.name for p in port_dir.glob("ckpt-*")) == ["ckpt-5000.pt"]
    assert got["result"]["steps"] == want["result"]["steps"] == 5000


def test_eval_every_evaluates_at_tpudets_steps(tmp_path, stand_ins):
    name = "RefineDet320"
    stand_ins("tpudet", "run_model", name, eval_every=1000)
    stand_ins("port", "run_model", name, eval_every=1000)
    got = _lines(tmp_path / "port" / "torch_runs" / name / "eval.jsonl")
    want = _lines(tmp_path / "jax" / name / "eval.jsonl")
    assert [e["step"] for e in got] == [e["step"] for e in want] == [1000, 2000, 3000,
                                                                     4000, 5000]
    assert [set(e) for e in got] == [set(e) for e in want]
    assert all(e["mAP@0.5_voc07"] == 0.5 for e in got)


@pytest.mark.parametrize("steps", [200, 4000])
def test_eval_only_writes_tpudets_result(tmp_path, stand_ins, steps):
    """``eval_from_checkpoint`` on a run's ``ckpt_meta.json``: the result's
    keys are tpudet's and ``device``, in the file tpudet writes
    (``probe_result.json`` under 500 steps); the config the model gets has
    the script's keys popped, as tpudet's."""
    name = "PFPNetR"
    for d in (tmp_path / "port" / "torch_runs" / name, tmp_path / "jax" / name):
        d.mkdir(parents=True)
        (d / "ckpt_meta.json").write_text(json.dumps({"steps": steps, "elapsed_s": 9.5}))
    want = stand_ins("tpudet", "eval_from_checkpoint", name)
    got = stand_ins("port", "eval_from_checkpoint", name)
    assert set(got["result"]) == set(want["result"]) | {"device"}
    assert {k: got["result"][k] for k in want["result"] if k != "eval_seconds"} == {
        k: v for k, v in want["result"].items() if k != "eval_seconds"}
    assert got["configs"] == want["configs"] and not got["made"]
    fname = "result.json" if steps >= 500 else "probe_result.json"
    run_dir = tmp_path / "port" / "torch_runs" / name
    assert json.loads((run_dir / fname).read_text()) == got["result"]


@pytest.mark.parametrize("argv, calls, rc", [
    (["SSD300", "YOLOv2"], [("run", "SSD300"), ("run", "YOLOv2")], 1),
    (["SSD300"], [("run", "SSD300")], 0),
    (["SSD300", "--eval-only"], [("eval", "SSD300")], 0),
    (["all"], None, 1),
    (["NoSuchNet"], [], 2),
])
def test_main_runs_each_family_and_fails_unless_all_have_an_map(monkeypatch, capsys, scripts,
                                                                argv, calls, rc):
    """A family that raises is recorded with its error and the queue goes
    on; the exit status is 1 unless every family has an mAP (tpudet's main
    exits 0 either way); ``all`` is tpudet's ``ALL``."""
    jax_tc, tc = scripts
    seen = []

    def run_model(name, **kwargs):
        seen.append(("run", name))
        if name == "YOLOv2":
            raise RuntimeError("out of memory")
        return {"model": name, "mAP@0.5_voc07": 0.5}

    def eval_from_checkpoint(name):
        seen.append(("eval", name))
        return {"model": name, "mAP@0.5_voc07": 0.5}

    monkeypatch.setattr(tc, "run_model", run_model)
    monkeypatch.setattr(tc, "eval_from_checkpoint", eval_from_checkpoint)
    assert tc.main(argv) == rc
    assert seen == (calls if calls is not None else [("run", n) for n in jax_tc.ALL])
    if rc != 2:
        results = json.loads(capsys.readouterr().out)
        assert [r["model"] for r in results] == [n for _, n in seen]
        assert [("error" in r) for r in results] == [n == "YOLOv2" for _, n in seen]


# ------------------------------------------------------------- the pieces
def test_the_variants_differ_from_their_spec_only_where_named(monkeypatch):
    """``scripts/convergence_variants_torch.py``: every spec and its
    ``-seed1`` (config seed 1, nothing else) and ``-tpudet-init`` (the spec
    with a subclass of its class that loads tpudet's initial weights,
    nothing else), PFPNetR in float32 over the spec's first 2000 steps
    (250 warm-up at 0.1x, 1750 at the base lr), and LHRCNN-long's
    ``-tpudet-init`` with its first RPN phase in float32 (the spec as it
    is; the class turns its layers' compute dtype at ``rpn_first_step``)."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    variants = importlib.import_module("convergence_variants_torch")
    specs, base = variants.model_specs(), variants.tc.model_specs()
    rpn32 = "LHRCNN-long-tpudet-init-rpn32"
    assert set(specs) == set(base) | {n + "-seed1" for n in base} | {
        n + "-tpudet-init" for n in base} | {"PFPNetR-fp32-2000", rpn32}
    assert specs[rpn32][1:] == base["LHRCNN-long"][1:]
    rpn32_cls = variants.tc._load_class(specs[rpn32][0])
    assert rpn32_cls.__bases__ == (variants.from_tpudet_init("LHRCNN-long", rpn32),)
    assert {"__init__", "train_step"} <= set(vars(rpn32_cls))
    for name, spec in base.items():
        seeded = specs[name + "-seed1"]
        assert seeded[2] == dict(spec[2], seed=1)
        assert seeded[:2] + seeded[3:] == spec[:2] + spec[3:]
        init = specs[name + "-tpudet-init"]
        assert init[1:] == spec[1:]
        cls = variants.tc._load_class(init[0])
        assert cls.__bases__ == (variants.tc._load_class(spec[0]),)
        assert cls is variants.tc._load_class(init[0])
        assert {"__init__", "train_one_epoch"} <= set(vars(cls))
    assert variants.init_path("PFPNetR").endswith("build/pfpnet_tpudet_init.pt")
    assert variants.init_path("CenterNet").endswith("build/CenterNet_tpudet_init.pt")
    pfp = base["PFPNetR"]
    fp32 = specs["PFPNetR-fp32-2000"]
    assert fp32[2] == dict(pfp[2], compute_dtype="float32") and fp32[4] == 2000
    warm, full = (max(1, int(round(2000 * f))) for f, _ in fp32[5])
    assert (warm, full) == (250, 1750) and [m for _, m in fp32[5]] == [0.1, 1.0]
    assert round(pfp[4] * pfp[5][0][0]) == warm and pfp[5][1][1] == 1.0
    assert issubclass(variants.tc._load_class(specs["PFPNetR-tpudet-init"][0]), PFPNetR)


def test_state_at_writes_the_rpn_phases_state_and_ends_the_run(monkeypatch, tmp_path):
    """``--state-at=2`` on an LH-RCNN ``-tpudet-init`` class (192x320, batch
    2): an epoch of 4 steps stops before its third, the step after step 2
    (the script's chunks cross step 5000 at 5010), and writes
    ``state_at_2.pt`` (the
    ``feature_extractor`` and ``rpn`` parameters and velocity, every
    BatchNorm statistic, equal to the model's; nothing of ``rcnn`` but its
    statistics) and ends the run with ``StateWritten``, which the script's
    queue does not record as a failed run."""
    from tpudet_torch.models.lhrcnn import LHRCNN, RPN_SCOPES

    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    variants = importlib.import_module("convergence_variants_torch")
    config = {"mode": "train", "data_shape": [192, 320, 3],
              "data_format": "channels_last", "num_classes": 4, "weight_decay": 1e-4,
              "keep_prob": 0.5, "batch_size": 2, "rpn_first_step": 3,
              "rcnn_first_step": 5, "rpn_second_step": 7, "nms_score_threshold": 0.2,
              "nms_max_boxes": 10, "nms_iou_threshold": 0.45, "post_nms_proposal": 500}
    images = np.random.default_rng(0).uniform(0, 255, (2, 192, 320, 3)).astype(np.float32)
    gt = -np.ones((2, 24, 5), np.float32)
    gt[:, 0] = [96, 160, 60, 80, 3]

    def batches():
        while True:
            yield images, gt

    init = tmp_path / "init.pt"
    torch.save(LHRCNN(config, device="cpu").net.state_dict(), init)
    monkeypatch.setattr(variants, "init_path", lambda spec: str(init))
    monkeypatch.setattr(variants.tc, "CONVERGENCE_ROOT", str(tmp_path))
    monkeypatch.setitem(variants.STATE_AT, "step", 2)
    provider = {"data_shape": [192, 320, 3], "num_train": 8, "num_val": 0,
                "train_generator": (lambda: None, batches()), "val_generator": None}
    model = variants.from_tpudet_init("LHRCNN")(config, provider, device="cpu")
    with pytest.raises(variants.StateWritten):
        model.train_one_epoch(1e-3)
    assert not issubclass(variants.StateWritten, Exception)
    blob = torch.load(tmp_path / "torch_runs" / "LHRCNN-tpudet-init" / "state_at_2.pt")
    assert blob["global_step"] == model.global_step == 2
    state = model.net.state_dict()
    stats = {k for k in state if k.endswith((".mean", ".var"))}
    trained = {k for k in state if k.split(".", 1)[0] in RPN_SCOPES}
    assert set(blob["params"]) == trained | stats
    assert any(k.startswith("rcnn.") for k in state) and not any(
        k.startswith("rcnn.") for k in set(blob["params"]) - stats)
    assert set(blob["velocity"]) == trained - stats
    for k, v in blob["params"].items():
        assert torch.equal(v, state[k].float()), k
    for k, v in blob["velocity"].items():
        assert torch.equal(v, model.velocity[k].float()), k
    assert any(float(v.abs().sum()) > 0 for v in blob["velocity"].values())


def test_rcnn_probe_steps_the_rcnn_phase_from_a_carried_state(monkeypatch, tmp_path):
    """``scripts/lhrcnn_rcnn_probe_torch.py`` at 192x320 on 16 rendered
    scenes, bfloat16 (float32 differs in ``compute_dtype`` alone): the model takes the initial file with the carried state over
    it, its velocity and ``global_step`` 5000, trains 2 steps of the RCNN
    phase at the spec's lr there (3e-4) and scores the held-out scenes; a
    state whose steps would leave the RCNN phase is refused; the lr follows
    the spec's schedule."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    variants = importlib.import_module("convergence_variants_torch")
    probe = importlib.import_module("lhrcnn_rcnn_probe_torch")
    cls, _, config, _, _, _ = variants.tc._spec("LHRCNN-long", (192, 320))
    for k in variants.tc.SCRIPT_KEYS:
        config.pop(k, None)
    model = cls(config, None, device="cpu")
    init = tmp_path / "init.pt"
    torch.save(model.net.state_dict(), init)
    model.global_step = 5000
    for v in model.velocity.values():
        v.fill_(1e-3)
    state = tmp_path / "state_at_5000.pt"
    torch.save(variants.phase_state(model), state)
    kw = dict(root=str(tmp_path), size=(192, 320), n_train=16, n_test=4, chunk=1,
              init=str(init), device="cpu")
    monkeypatch.setattr(probe, "EVAL_IMAGES", 2)
    dtype = "bfloat16"
    got = probe.run(dtype, str(state), 2, **kw)
    assert got["from_step"] == 5000 and got["steps"] == 2 and got["lr"] == 3e-4
    assert list(got["windows"]) == ["5500"] and np.isfinite(got["windows"]["5500"])
    assert 0.0 <= got["mAP@0.5_voc07"] <= 1.0 and got["eval_images"] == 2
    curve = _lines(tmp_path / "torch_runs" / probe.RUN / f"curve_{dtype}.jsonl")
    assert [c["step"] for c in curve] == [5001, 5002]
    blob = variants.phase_state(model)
    blob["global_step"] = 4999
    torch.save(blob, state)
    with pytest.raises(ValueError, match="leave the RCNN phase"):
        probe.run(dtype, str(state), 2, **kw)
    schedule = [(0.03, 0.1), (0.8, 1.0), (0.17, 0.1)]
    assert [probe._lr_at(s, 3e-4, 12000, schedule) for s in (359, 360, 9959, 9960)] == [
        3e-4 * 0.1, 3e-4, 3e-4, 3e-4 * 0.1]


def test_the_parallel_render_is_synthvoc_build_byte_for_byte(tmp_path, scripts):
    """Two render processes write ``synthvoc.build``'s five files,
    byte for byte (12 train and 5 test scenes at 24x40); a second call finds
    the dataset there and renders nothing."""
    _, tc = scripts
    want = tc.synthvoc.build(str(tmp_path / "one"), 24, 40, n_train=12, n_test=5)
    got = tc.render_dataset(str(tmp_path / "two"), 24, 40, 12, 5, workers=2)
    assert got == str(tmp_path / "two" / "24x40")
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got)) == sorted(
        ["DONE", "test_gt.npy", "test_images.npy", "train_gt.npy", "train_images.npy"])
    for name in names:
        assert Path(got, name).read_bytes() == Path(want, name).read_bytes(), name
    stamp = os.stat(Path(got, "train_images.npy")).st_mtime_ns
    tc.render_dataset(str(tmp_path / "two"), 24, 40, 12, 5, workers=2)
    assert os.stat(Path(got, "train_images.npy")).st_mtime_ns == stamp


def test_memmap_feeder_batches_equal_tpudets_and_close_stops_it(scripts):
    """Seed 1, 40 rows at batch 8: twelve batches, so across two reshuffles."""
    jax_tc, tc = scripts
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (40, 6, 6, 3), dtype=np.uint8)
    gt = rng.normal(0, 1, (40, 24, 5)).astype(np.float32)
    got_feed = tc.MemmapFeeder(images, gt, 8, seed=1)
    want_feed = jax_tc.MemmapFeeder(images, gt, 8, seed=1)
    try:
        for _ in range(12):
            (gi, gg), (wi, wg) = next(got_feed), next(want_feed)
            assert gi.dtype == np.uint8 and gi.shape == (8, 6, 6, 3) and gg.shape == (8, 24, 5)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gg, wg)
    finally:
        got_feed.close()
        want_feed.close()
    got_feed.t.join(timeout=5)
    assert not got_feed.t.is_alive()


def test_gt_pad_is_lossless_for_refine_loss():
    """``refine_loss`` on fixed head outputs: the port's loss and gradients
    with gt ``[B, 60, 5]`` (at most 6 real boxes an image) equal those with
    its ``[:, :24]``, and equal tpudet's at width 24 within
    ``tests/test_torch_refine.py``'s tolerances (21 classes, anchors at 64)."""
    classes = 21
    shapes = _refine_feat_shapes(64)
    tanc, janc = t_refine.build_anchors(shapes), jax_refine.build_anchors(shapes)
    rng = np.random.default_rng(11)
    a = tanc.yx.shape[0]
    heads = [rng.normal(0, s, (4, a, c)).astype(np.float32)
             for s, c in ((0.5, 2), (0.5, 2), (2, 2), (0.5, 2), (0.5, 2), (2, classes))]
    gt = gt_rows(rng, 4, 60, 6, 64.0, num_classes=classes - 1)
    assert (gt[:, 6:] == -1).all() and (gt[:, 0, 0] >= 0).all()

    def port(g):
        tt = [torch.tensor(h, requires_grad=True) for h in heads]
        loss = t_refine.refine_loss(*tt, tanc, torch.from_numpy(g), classes)
        return loss, torch.autograd.grad(loss, tt)

    loss60, grads60 = port(gt)
    loss24, grads24 = port(np.ascontiguousarray(gt[:, :24]))
    assert torch.equal(loss60, loss24)
    assert all(torch.equal(g60, g24) for g60, g24 in zip(grads60, grads24))

    def jax_loss(g, *h):
        return jax_refine.refine_loss(*h, janc, g, classes)

    want, wgrads = jax.jit(jax.value_and_grad(jax_loss, argnums=tuple(range(1, 7))))(
        jnp.asarray(gt[:, :24]), *map(jnp.asarray, heads))
    np.testing.assert_allclose(float(loss24.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads24, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


# ------------------------------------------------------- real runs on the CPU
def _tiny_specs(monkeypatch, tc, name):
    real = tc.model_specs

    def specs():
        path, hw, config, lr, steps, schedule = real()[name]
        return {name: (path, hw, dict(config, batch_size=4), lr, steps, schedule)}

    monkeypatch.setattr(tc, "model_specs", specs)


def test_a_tiny_run_on_the_cpu_writes_a_probe_result(monkeypatch, tmp_path, scripts):
    _, tc = scripts
    _tiny_specs(monkeypatch, tc, "SSD300")
    result = tc.run_model("SSD300", steps_scale=2 / 4000, root=str(tmp_path),
                          n_train=16, n_test=4, size=(76, 76), device="cpu")
    run_dir = tmp_path / "torch_runs" / "SSD300"
    assert json.loads((run_dir / "probe_result.json").read_text()) == result
    assert not (run_dir / "result.json").exists()
    assert result["steps"] == 2 and result["input"] == [76, 76]
    assert result["eval_images"] == 4 and result["device"] == "cpu"
    assert 0.0 <= result["mAP@0.5_voc07"] <= 1.0
    curve = _lines(run_dir / "curve.jsonl")
    assert [(c["step"], c["lr"]) for c in curve] == [(1, 1e-4), (2, 1e-3)]
    assert all(np.isfinite(c["mean_loss"]) for c in curve)
    assert (run_dir / "ckpt-2.pt").is_file()
    assert sorted(p.name for p in (tmp_path / "data" / "76x76").iterdir()) == [
        "DONE", "test_gt.npy", "test_images.npy", "train_gt.npy", "train_images.npy"]


def test_a_tiny_refinedet_run_on_the_host_feed_resumes_and_evaluates(monkeypatch, tmp_path,
                                                                     scripts):
    """RefineDet320 at 64x64 through ``host_feed`` and ``gt_pad`` 24, with a
    checkpoint every step and an evaluation every step: the feeder gets gt
    of width 24, one checkpoint is kept, a resume from it restores the
    parameters, BatchNorm statistics, velocity and ``global_step`` bit for
    bit, and ``eval_from_checkpoint`` gives the run's mAP."""
    _, tc = scripts
    _tiny_specs(monkeypatch, tc, "RefineDet320")
    monkeypatch.setattr(tc, "CKPT_EVERY", 1)
    widths = []

    class Feeder(tc.MemmapFeeder):
        def __init__(self, images, gt, batch, **kwargs):
            widths.append(gt.shape[1:])
            super().__init__(images, gt, batch, **kwargs)

    monkeypatch.setattr(tc, "MemmapFeeder", Feeder)
    kwargs = dict(root=str(tmp_path), n_train=16, n_test=4, size=(64, 64), device="cpu")
    result = tc.run_model("RefineDet320", steps_scale=2 / 5000, eval_every=1, **kwargs)
    run_dir = tmp_path / "torch_runs" / "RefineDet320"
    assert widths == [(24, 5)]
    assert json.loads((run_dir / "probe_result.json").read_text()) == result
    assert result["steps"] == 2 and result["input"] == [64, 64]
    assert [e["step"] for e in _lines(run_dir / "eval.jsonl")] == [1, 2]
    assert sorted(p.name for p in run_dir.glob("ckpt-*")) == ["ckpt-2.pt"]
    assert json.loads((run_dir / "ckpt_meta.json").read_text())["steps"] == 2

    saved = torch.load(run_dir / "ckpt-2.pt", weights_only=True)
    loaded = []
    real_load = tc._load_class

    def load_class(path):
        cls = real_load(path)

        class Recorded(cls):
            def load_weight(self, prefix):
                super().load_weight(prefix)
                loaded.append((dict(self.net.state_dict()), self.velocity,
                               self.global_step))

        return Recorded

    monkeypatch.setattr(tc, "_load_class", load_class)
    resumed = tc.run_model("RefineDet320", steps_scale=2 / 5000, resume=True, **kwargs)
    (state, velocity, step), = loaded
    assert step == saved["global_step"] == 2 and resumed["steps"] == 2
    assert state.keys() == saved["state_dict"].keys()
    assert all(torch.equal(state[k], saved["state_dict"][k]) for k in state)
    assert any(k.endswith(".mean") for k in state)  # BatchNorm statistics among them
    assert all(torch.equal(velocity[k], saved["opt_state"]["velocity"][k])
               for k in saved["opt_state"]["velocity"])
    assert [c["step"] for c in _lines(run_dir / "curve.jsonl")] == [1, 2]

    salvaged = tc.eval_from_checkpoint("RefineDet320", **kwargs)
    assert salvaged["mAP@0.5_voc07"] == result["mAP@0.5_voc07"]
    assert salvaged["per_class_AP"] == result["per_class_AP"]
    assert salvaged["steps"] == 2 and salvaged["note"].startswith("evaluated from")


WATCHDOG = """
import importlib.util, sys, time
import numpy as np
spec = importlib.util.spec_from_file_location("tc", {script!r})
tc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tc)
import tpudet_torch.data.device_dataset as dd

class Feeder:
    def __init__(self, *a, **k):
        pass

    def close(self):
        pass

class Model:
    def __init__(self, config, provider, device=None):
        self.epochs = 0

    def train_one_epoch(self, lr):
        self.epochs += 1
        if self.epochs > 1:
            time.sleep(60)  # a stalled device
        return 1.0

    def save_weight(self, mode, path):
        pass

images = np.zeros((4, 8, 8, 3), np.uint8)
gt = -np.ones((4, 60, 5), np.float32)
tc.synthvoc.build = lambda *a, **k: {root!r}
tc.synthvoc.load = lambda d: (images, gt, images, gt)
dd.DeviceDataset = Feeder
tc._load_class = lambda path: Model
tc.STALL_CHECK_S = 0.05
tc.run_model("SSD300", root={root!r}, device="cpu")
print("the run ended")
"""


def test_the_watchdog_exits_a_stalled_run_with_93(tmp_path):
    code = WATCHDOG.format(script=str(REPO / "scripts" / "train_convergence_torch.py"),
                           root=str(tmp_path))
    env = dict(os.environ, STALL_LIMIT_S="0.5")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 93, proc.stdout + proc.stderr
    assert "STALLED: no chunk finished in 0s at step 50" in proc.stdout
    assert "the run ended" not in proc.stdout


def test_rpn32_runs_the_first_rpn_phase_in_float32_then_bfloat16(monkeypatch, tmp_path):
    """``LHRCNN-long-tpudet-init-rpn32``'s class on a bf16 LH-RCNN config
    (192x320, batch 2, ``rpn_first_step`` 2): every layer computes in
    float32 with TF32 off for convolutions and matmuls before step 2, in
    bfloat16 with TF32 convolutions (PyTorch's defaults) from step 2; the
    parameters stay float32 throughout."""
    from tpudet_torch.models.lhrcnn import LHRCNN

    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    variants = importlib.import_module("convergence_variants_torch")
    config = {"mode": "train", "data_shape": [192, 320, 3],
              "data_format": "channels_last", "num_classes": 4, "weight_decay": 1e-4,
              "keep_prob": 0.5, "batch_size": 2, "rpn_first_step": 2,
              "rcnn_first_step": 5, "rpn_second_step": 7, "nms_score_threshold": 0.2,
              "nms_max_boxes": 10, "nms_iou_threshold": 0.45, "post_nms_proposal": 500,
              "compute_dtype": "bfloat16"}
    images = np.random.default_rng(0).uniform(0, 255, (2, 192, 320, 3)).astype(np.float32)
    gt = -np.ones((2, 24, 5), np.float32)
    gt[:, 0] = [96, 160, 60, 80, 3]

    def batches():
        while True:
            yield images, gt

    init = tmp_path / "init.pt"
    torch.save(LHRCNN(config, device="cpu").net.state_dict(), init)
    monkeypatch.setattr(variants, "init_path", lambda spec: str(init))
    monkeypatch.setattr(variants.tc, "CONVERGENCE_ROOT", str(tmp_path))
    monkeypatch.setitem(variants.STATE_AT, "step", None)
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", flag.allow_tf32)  # restored after
    seen = []
    cls = variants.rpn_in_float32("LHRCNN")
    base_step = cls.__bases__[0].train_step

    def spy(self, images, gt, lr):
        dtypes = {m.compute_dtype for m in self.net.modules() if hasattr(m, "compute_dtype")}
        seen.append((self.global_step, dtypes, torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return base_step(self, images, gt, lr)

    monkeypatch.setattr(cls.__bases__[0], "train_step", spy)
    provider = {"data_shape": [192, 320, 3], "num_train": 6, "num_val": 0,
                "train_generator": (lambda: None, batches()), "val_generator": None}
    model = cls(config, provider, device="cpu")
    model.train_one_epoch(1e-3)
    f32, bf16 = {torch.float32}, {torch.bfloat16}
    assert seen == [(0, f32, False, False), (1, f32, False, False),
                    (2, bf16, True, False)]
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
