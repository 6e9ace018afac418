"""The port's evaluation, metrics and summary writer against tpudet's.

``voc_ap``, ``evaluate_detections`` and ``eval_preprocess`` agree to 1e-12 on
inputs made here with numpy; ``evaluate_model`` gives the same mAP on a stub
model with fixed detections, and on a whole SSD300 at input size 76 whose
weights are tpudet's, carried across by ``runtime/transfer.py``, within the
tolerance ``tests/test_torch_ssd.py`` holds ``test_one_image`` to (1e-4).
The event files of the two ``SummaryWriter`` differ only in ``wall_time``.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpudet.models.ssd import SSD300 as JaxSSD300
from tpudet.runtime import evaluate as j_eval
from tpudet.runtime import metrics as j_metrics
from tpudet.runtime import summary as j_summary
from tpudet_torch.data import example_proto, tfrecord, voc
from tpudet_torch.models.ssd import SSD300
from tpudet_torch.runtime import evaluate as t_eval
from tpudet_torch.runtime import metrics as t_metrics
from tpudet_torch.runtime import summary as t_summary
from tpudet_torch.runtime import transfer

torch.set_num_threads(1)

MINI = Path(__file__).resolve().parent / "torch_data" / "voc_mini"


def _pr_curve(rng, n):
    tp = rng.uniform(size=n) < 0.6
    npos = max(1, int(tp.sum()) + int(rng.integers(0, 3)))
    recall = np.cumsum(tp) / npos
    precision = np.cumsum(tp) / np.arange(1, n + 1)
    return recall, precision


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_tpudet(seed, use_07):
    recall, precision = _pr_curve(np.random.default_rng(seed), 5 + 20 * seed)
    want = j_eval.voc_ap(recall, precision, use_07)
    got = t_eval.voc_ap(recall.copy(), precision.copy(), use_07)
    assert abs(got - want) <= 1e-12


def _random_eval_case(rng, n_images=6, n_classes=4):
    dets, gts = {}, {}
    for i in range(n_images):
        k = int(rng.integers(0, 5))
        yx = rng.uniform(0, 80, (k, 2))
        hw = rng.uniform(5, 40, (k, 2))
        cls = rng.integers(0, n_classes, k)
        gts[i] = np.concatenate([yx, yx + hw, cls[:, None]], -1)
        boxes = []
        for j in range(int(rng.integers(0, 8))):
            if k and rng.uniform() < 0.6:  # near a ground-truth box
                g = gts[i][int(rng.integers(0, k))]
                box, c = g[:4] + rng.normal(0, 3, 4), int(g[4])
            else:
                y, x = rng.uniform(0, 80, 2)
                box = np.asarray([y, x, y + 20, x + 20])
                c = int(rng.integers(0, n_classes))
            boxes.append((float(rng.uniform()), box, c))
        if boxes or rng.uniform() < 0.5:
            dets[i] = boxes
    return dets, gts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("use_07,iou", [(True, 0.5), (False, 0.5), (True, 0.3)])
def test_evaluate_detections_matches_tpudet(seed, use_07, iou):
    dets, gts = _random_eval_case(np.random.default_rng(seed))
    want_map, want_aps = j_eval.evaluate_detections(dets, gts, 4, iou, use_07)
    got_map, got_aps = t_eval.evaluate_detections(dets, gts, 4, iou, use_07)
    assert got_aps.keys() == want_aps.keys() and want_aps
    assert abs(got_map - want_map) <= 1e-12
    for c in want_aps:
        assert abs(got_aps[c] - want_aps[c]) <= 1e-12


PREPROCESS = {
    "plain": {},
    "keep_aspect": {"keep_aspect_ratios": True, "fill_mode": "BILINEAR",
                    "constant_values": 5.0},
    "keep_aspect_nearest": {"keep_aspect_ratios": True,
                            "fill_mode": "NEAREST_NEIGHBOR"},
    "constant": {"fill_mode": "CONSTANT", "constant_values": 9.0},
}


@pytest.mark.parametrize("hw", [(50, 70), (90, 60), (120, 130)])
@pytest.mark.parametrize("mode", sorted(PREPROCESS))
def test_eval_preprocess_matches_tpudet(hw, mode):
    rng = np.random.default_rng(hw[0])
    image = rng.uniform(0, 255, (*hw, 3)).astype(np.float32)
    boxes = rng.uniform(0, 64, (5, 4))
    cfg = PREPROCESS[mode]
    want, want_unmap = j_eval.eval_preprocess(image, 64, 96, **cfg)
    got, got_unmap = t_eval.eval_preprocess(image, 64, 96, **cfg)
    assert got.shape == want.shape == (64, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_unmap(boxes), want_unmap(boxes), rtol=0,
                               atol=1e-12)


class _StubModel:
    """``test_one_image`` returns fixed detections, one set per call in turn,
    and records the input it was given."""

    num_classes = 4  # 3 classes + background

    def __init__(self, detections):
        self.detections = detections
        self.inputs = []

    def _data_shape_nhwc(self):
        return (64, 80, 3)

    def test_one_image(self, images):
        self.inputs.append(np.array(images))
        return self.detections[len(self.inputs) - 1]


def _stub_case(seed):
    rng = np.random.default_rng(seed)
    records, detections = [], []
    for i in range(5):
        h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
        k = int(rng.integers(1, 4))
        y1, x1 = rng.uniform(0, h / 2, k), rng.uniform(0, w / 2, k)
        y2, x2 = y1 + rng.uniform(5, h / 2, k), x1 + rng.uniform(5, w / 2, k)
        gt = np.stack([y1, y2, x1, x2, rng.integers(0, 3, k)], -1).astype(np.float32)
        records.append((rng.uniform(0, 255, (h, w, 3)).astype(np.float32), gt))
        n = int(rng.integers(0, 6))
        corners = np.sort(rng.uniform(0, 64, (n, 2, 2)), axis=1)  # [n, (lo, hi), (y, x)]
        boxes = corners.reshape(n, 4)  # y1 x1 y2 x2
        detections.append([rng.uniform(size=n).astype(np.float32),
                           boxes.astype(np.float32), rng.integers(0, 3, n)])
    return records, detections


@pytest.mark.parametrize("mode", sorted(PREPROCESS))
def test_evaluate_model_on_a_stub_matches_tpudet(mode):
    records, detections = _stub_case(len(mode))
    cfg = PREPROCESS[mode] or None
    j_model, t_model = _StubModel(detections), _StubModel(detections)
    want = j_eval.evaluate_model(j_model, records, preprocess_config=cfg)
    got = t_eval.evaluate_model(t_model, records, preprocess_config=cfg)
    for g, w in zip(t_model.inputs, j_model.inputs):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert got[1].keys() == want[1].keys()
    assert abs(got[0] - want[0]) <= 1e-12


# ------------------------------------------------------------ whole SSD300
def _config():
    return {"mode": "test", "data_format": "channels_last", "num_classes": 20,
            "batch_size": 1, "weight_decay": 5e-4, "nms_score_threshold": 0.05,
            "nms_max_boxes": 20, "nms_iou_threshold": 0.5,
            "pretraining_weight": None, "seed": 3}


class _JaxSSD76(JaxSSD300):
    input_size = 76


class SSD76(SSD300):
    input_size = 76


def _random_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0.0, 0.2, np.shape(v)).astype(np.float32)
    return out


def _mini_records():
    out = []
    for xml in sorted((MINI / "Annotations").glob("*.xml")):
        feats = voc.xml_to_features(str(xml), str(MINI / "JPEGImages"))
        image, _, gt = voc.parse_voc_record(example_proto.encode_example(feats))
        out.append((image, gt))
    return out


def test_evaluate_model_on_ssd300_at_76_matches_tpudet():
    jm = _JaxSSD76(_config())
    jm.batch_stats = _random_stats(jax.device_get(jm.batch_stats),
                                   np.random.default_rng(0))
    pm = SSD76(_config(), device="cpu")
    transfer.load_flax(pm.net, {"params": jax.device_get(jm.params),
                                "batch_stats": jm.batch_stats})
    assert pm._data_shape_nhwc() == jm._data_shape_nhwc() == (76, 76, 3)
    records = _mini_records()
    cfg = {"keep_aspect_ratios": False, "fill_mode": "BILINEAR", "constant_values": 0.0}
    # random weights: at IoU 0.5 no detection hits, and both mAPs would be 0
    want = j_eval.evaluate_model(jm, records, iou_threshold=0.3, preprocess_config=cfg)
    got = t_eval.evaluate_model(pm, records, iou_threshold=0.3, preprocess_config=cfg)
    assert want[0] > 0, "the case must score some detection"
    assert got[1].keys() == want[1].keys()
    assert abs(got[0] - want[0]) <= 1e-4
    for c in want[1]:
        assert abs(got[1][c] - want[1][c]) <= 1e-4


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv3", "FCOS", "RetinaNet", "LHRCNN"])
def test_data_shape_nhwc_of_the_non_square_models(name):
    import importlib
    from types import SimpleNamespace

    module = {"YOLOv2": "yolo", "YOLOv3": "yolo", "FCOS": "fcos",
              "RetinaNet": "retinanet", "LHRCNN": "lhrcnn"}[name]
    port = getattr(importlib.import_module(f"tpudet_torch.models.{module}"), name)
    ref = getattr(importlib.import_module(f"tpudet.models.{module}"), name)
    model = SimpleNamespace(data_shape_hw=(448, 640))
    assert port._data_shape_nhwc(model) == ref._data_shape_nhwc(model) == (448, 640, 3)


@pytest.mark.parametrize("name", ["SSD300", "RefineDet320", "PFPNetR", "CenterNet"])
def test_data_shape_nhwc_of_the_square_models(name):
    import importlib
    from types import SimpleNamespace

    module = {"SSD300": "ssd", "RefineDet320": "refinedet", "PFPNetR": "refinedet",
              "CenterNet": "centernet"}[name]
    port = getattr(importlib.import_module(f"tpudet_torch.models.{module}"), name)
    ref = getattr(importlib.import_module(f"tpudet.models.{module}"), name)
    model = SimpleNamespace(input_size=320)
    assert port._data_shape_nhwc(model) == ref._data_shape_nhwc(model) == (320, 320, 3)


# ------------------------------------------------------------ summary writer
SCALARS = [("loss", 1.5, 1), ("loss", 0.75, 2), ("lr", 0.01, 2), ("loss", -3.25, 2 ** 40)]


def _write_events(mod, logdir):
    w = mod.SummaryWriter(str(logdir))
    for tag, value, step in SCALARS[:-1]:
        w.add_scalar(tag, value, step)
    w.add_summary(SCALARS[-1][1], global_step=SCALARS[-1][2])
    w.flush()
    w.close()
    (name,) = os.listdir(logdir)
    return str(Path(logdir) / name)


def test_summary_events_equal_tpudet_but_for_wall_time(tmp_path):
    got = list(tfrecord.read_records(_write_events(t_summary, tmp_path / "port"),
                                     verify=True))
    want = list(tfrecord.read_records(_write_events(j_summary, tmp_path / "tpudet"),
                                      verify=True))
    assert len(got) == len(want) == 1 + len(SCALARS)
    for g, w in zip(got, want):
        assert g[0] == w[0] == 0x09  # field 1, a double: wall_time
        assert g[9:] == w[9:]


def test_read_events_gives_the_scalars(tmp_path):
    events = t_summary.read_events(_write_events(t_summary, tmp_path))
    assert events[0]["file_version"] == "brain.Event:2" and events[0]["step"] == 0
    assert [(e["tag"], e["value"], e["step"]) for e in events[1:]] == [
        (tag, float(np.float32(value)), step) for tag, value, step in SCALARS]
    assert all(e["wall_time"] > 1e9 for e in events)


def test_tensorflow_reads_the_port_s_events(tmp_path):
    tf = pytest.importorskip("tensorflow")
    path = _write_events(t_summary, tmp_path)
    events = [tf.compat.v1.Event.FromString(r) for r in tfrecord.read_records(path)]
    assert events[0].file_version == "brain.Event:2"
    for event, (tag, value, step) in zip(events[1:], SCALARS):
        assert event.step == step and event.summary.value[0].tag == tag
        assert event.summary.value[0].simple_value == np.float32(value)


# ------------------------------------------------------------ metrics
def test_step_timer_and_throughput_match_tpudet(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.625, 2.5]
    results = []
    for mod in (t_metrics, j_metrics):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        meter = mod.Throughput(32)
        meter.start()
        for _ in ticks[1:]:
            meter.mark()
        results.append((meter.timer.summary(), meter.items_per_sec()))
    assert results[0] == results[1]
    assert t_metrics.Throughput(8).items_per_sec() is None


def test_trace_writes_a_chrome_trace_and_block_until_ready_returns_the_tree(tmp_path):
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.arange(4),)], "c": 1}
    with t_metrics.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert t_metrics.block_until_ready(tree) is tree
    (name,) = os.listdir(tmp_path)
    assert name.startswith("trace.") and name.endswith(".json")
    assert "aten::mm" in (tmp_path / name).read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
