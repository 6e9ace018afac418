"""The port's per-model profilers (``scripts/profile_model_torch.py``,
``scripts/profile_decode_torch.py``) on the CPU, against tpudet's
(``scripts/profile_model.py``, ``scripts/profile_decode.py``) and against the
model's own ``train_step`` and ``test_one_image``; SSD300 at 76, batch 2,
one warm-up and one timed call a phase. LH-RCNN's phases are in
``test_torch_profile_lhrcnn.py``.

Tolerance: the port's ``fwd+loss`` against tpudet's ``forward_loss`` on the
same variables and batch is held as ``test_torch_train.py`` holds a whole
step's loss (float32 1e-4, bfloat16 1e-2 relative: convolutions sum in other
orders, and bf16 rounds in other places). Everything held against the port
itself is bit for bit.
"""

import importlib.util
import inspect
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudet_torch.models as t_models
from tpudet.models import base as jax_base
from tpudet_torch.runtime import transfer
from test_torch_train import SSD76, _JaxSSD76

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = {"host_ms", "device_ms", "kernels", "busy", "syncs", "launches", "calls"}
LAUNCH_KEYS = {"assign", "nms_rows", "select", "mask", "scan", "continue"}


def _load(name, module_name):
    spec = importlib.util.spec_from_file_location(module_name, REPO / "scripts" / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def prof():
    return _load("profile_model_torch.py", "_profile_model_torch")


@pytest.fixture(scope="module")
def dec():
    return _load("profile_decode_torch.py", "_profile_decode_torch")


def small_spec(prof, **config):
    """SSD300's spec at input 76 and batch 2."""
    spec = prof._specs()["SSD300"]
    return dict(spec, batch=2, shape=(76, 76),
                config=dict(spec["config"], batch_size=2, **config))


def tpudet_labels(script):
    """The phase labels each function of tpudet's ``script`` prints."""
    text = (REPO / "scripts" / script).read_text()
    return [re.findall(r'timeit\(\s*"([^"]+)"', part)
            for part in re.split(r"\ndef ", text) if "def timeit" in part]


def check_phases(phases, labels):
    assert list(phases) == labels
    for label, fig in phases.items():
        assert set(fig) == FIELDS, label
        assert set(fig["launches"]) == LAUNCH_KEYS, label
        assert all(np.isfinite(v) for v in fig["launches"].values()), label
        assert all(np.isfinite(fig[k]) for k in FIELDS - {"launches"}), label
        assert fig["host_ms"] > 0, label


@pytest.fixture(scope="module")
def ssd_records(prof, dec):
    """SSD300's train and serve records on the CPU, and the kernel counters
    before and after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_models, "SSD300", SSD76)
        before = prof.counts()
        train = prof.profile_model("SSD300", small_spec(prof), n=1, warmup=1, device="cpu")
        serve = dec.profile_decode("SSD300", small_spec(prof), n=1, warmup=1, device="cpu")
        return train, serve, before, prof.counts()


def test_specs_and_labels_are_tpudets(prof, dec, ssd_records):
    """tpudet's bench specs, the phase labels tpudet's scripts print (and
    the deltas over them), and tpudet's default families to serve."""
    jax_bench = _load("bench_all.py", "_jax_bench_all")
    assert prof._specs() == jax_bench._specs()
    model_labels, _ = tpudet_labels("profile_model.py")
    train, serve = ssd_records[:2]
    assert list(train["phases"]) == model_labels
    assert [label for label, _ in prof.DELTAS.values()] == model_labels[1:]
    (decode_labels,) = tpudet_labels("profile_decode.py")
    assert list(serve["phases"]) == decode_labels
    text = (REPO / "scripts" / "profile_decode.py").read_text()
    assert str(dec.FAMILIES).replace("'", '"') in text


def test_ssd300_records_give_every_field_and_no_launch_on_the_cpu(prof, ssd_records):
    train, serve, before, after = ssd_records
    assert after == before  # the CPU runs the kernels' plain versions
    check_phases(train["phases"], ["fwd", "fwd+loss", "grad", "step"])
    check_phases(serve["phases"], ["transfer", "forward", "decode", "fused", "full"])
    for record in (train, serve):
        assert record["device"] == "cpu" and (record["n"], record["warmup"]) == (1, 1)
        for fig in record["phases"].values():
            assert (fig["device_ms"], fig["kernels"], fig["busy"], fig["syncs"]) == (0,) * 4
            assert set(fig["launches"].values()) == {0}
            assert fig["calls"] == 3  # warm-up, timed, profiled
    assert (train["batch"], train["shape"], train["compute_dtype"]) == (2, [76, 76],
                                                                        "bfloat16")
    assert set(train["deltas"]) == {"loss", "bwd", "opt"}
    p = train["phases"]
    assert train["deltas"]["bwd"]["host_ms"] == p["grad"]["host_ms"] - p["fwd+loss"]["host_ms"]


def _models(prof):
    """Two SSD300s at 76 from the same seed, the profiler's batch on each."""
    spec = small_spec(prof)
    out = []
    for _ in range(2):
        model, x, g = prof.build("SSD300", spec, "cpu")
        out.append((model, x, g))
    return out


def test_fwd_loss_and_grad_phases_are_train_steps(prof, monkeypatch):
    """On two models from one seed: ``fwd+loss`` is ``train_step``'s loss bit
    for bit, and ``grad``'s gradients through the optimizer give
    ``train_step``'s parameters and velocities bit for bit; ``fwd`` is the
    net's train-mode output."""
    monkeypatch.setattr(t_models, "SSD300", SSD76)
    (a, xa, ga), (b, xb, gb) = _models(prof)
    phases = prof.train_phases(a, xa, ga)
    loss = phases["fwd+loss"]()
    want = b.train_step(xb, gb, prof.LR)
    assert torch.equal(loss.detach(), want)
    grads, g_loss, _ = phases["grad"]()
    assert torch.equal(g_loss, want)
    params = dict(a.net.named_parameters())
    a._optimizer.update(dict(zip(params, grads)), a.opt_state, params, prof.LR)
    for (k, p), q in zip(params.items(), b.net.parameters()):
        assert torch.equal(p.detach(), q.detach()), k
    for k, v in a.velocity.items():
        assert torch.equal(v, b.velocity[k]), k
    out = phases["fwd"]()
    assert isinstance(out, (tuple, list)) and all(t.requires_grad for t in out)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_fwd_loss_matches_tpudets_forward_loss(prof, monkeypatch, dtype, rtol):
    """``scripts/profile_model.py``'s ``forward_loss`` (its lines 73-81,
    jitted) on tpudet's SSD300 at 76 and the port's ``fwd+loss`` phase on its
    variables (``transfer.load_flax``), the profiler's batch on both."""
    monkeypatch.setenv("TPUDET_SSD_CONF_LAYOUT", "ac")
    spec = small_spec(prof, compute_dtype=dtype)
    jm = _JaxSSD76(dict(spec["config"], mode="test"))
    net, wd = jm.net, jm.weight_decay
    sample_weight = jm._sample_weight()
    augment_fused = not getattr(jm, "_augment_split", False)

    def forward_loss(params, bstats, imgs, g, s):
        x = imgs.astype(jnp.float32)
        if augment_fused:
            x, g = jm._device_augment(x, g, s)
        x = jm._preprocess(x)
        outputs, mut = net.apply({"params": params, "batch_stats": bstats}, x,
                                 True, mutable=["batch_stats"])
        loss = jm._loss_from_outputs(outputs, g, sample_weight)
        return loss + wd * jax_base.global_l2(params), mut["batch_stats"]

    images, gt = prof.seeded_batch(spec)
    params, bstats = jax.device_get((jm.params, jm.batch_stats))
    want = jax.jit(lambda p, b, i, g, s: forward_loss(p, b, i, g, s)[0])(
        params, bstats, jnp.asarray(images), jnp.asarray(gt), jnp.int32(0))

    monkeypatch.setattr(t_models, "SSD300", SSD76)
    model, x, g = prof.build("SSD300", spec, "cpu")
    transfer.load_flax(model.net, {"params": params, "batch_stats": bstats})
    got = prof.train_phases(model, x, g)["fwd+loss"]()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol)


def test_decode_phase_is_test_one_images_answer(dec, prof, monkeypatch):
    """The ``decode`` phase on the outputs computed in advance, its padding
    stripped, is what ``test_one_image`` returns for the image; ``fused``
    gives the same."""
    monkeypatch.setattr(t_models, "SSD300", SSD76)
    spec = small_spec(prof, nms_score_threshold=0.01)
    model, img = dec.serve_model("SSD300", spec, "cpu")
    phases = dec.serve_phases(model, img)
    want = model.test_one_image(img)
    assert len(want[0]) > 0
    for label in ("decode", "fused"):
        scores, boxes, cid, valid = (t.numpy() for t in phases[label]())
        for got, w in zip((scores[valid], boxes[valid], cid[valid]), want):
            np.testing.assert_array_equal(got, w)
    assert phases["transfer"]() == pytest.approx(float(img.sum()), rel=1e-5)


def test_main_records_errors_keeps_going_and_merges_serve(prof, dec, monkeypatch,
                                                          tmp_path):
    """Each script's default families are tpudet's; a family that raises
    records its error and the script exits 1; the train record and the
    serve record of one family sit side by side in one file, and a rerun of
    either keeps the other."""
    out = tmp_path / "PROFILE_TORCH.json"
    seen = []

    def fake_model(name, spec, device=None):
        seen.append(("model", name, device))
        if name == "FCOS":
            raise ValueError("no card")
        return {"phases": {"step": 1.0}}

    def fake_decode(name, spec, device=None):
        seen.append(("decode", name, device))
        return {"phases": {"full": 2.0}}

    for fn, n in ((prof.profile_model, 10), (dec.profile_decode, 15)):  # tpudet's
        params = inspect.signature(fn).parameters
        assert (params["n"].default, params["warmup"].default) == (n, 3)
    monkeypatch.setattr(prof, "profile_model", fake_model)
    monkeypatch.setattr(dec, "profile_decode", fake_decode)
    assert prof.main([], out=str(out), device="cpu") == 0
    assert seen == [("model", "YOLOv2", "cpu")]
    assert dec.main([], out=str(out), device="cpu") == 0
    assert seen[1:] == [("decode", name, "cpu") for name in dec.FAMILIES]
    assert dec.main(["YOLOv2"], out=str(out), device="cpu") == 0
    assert prof.main(["FCOS", "YOLOv2"], out=str(out), device="cpu") == 1
    got = json.loads(out.read_text())
    assert got["YOLOv2"] == {"serve": {"phases": {"full": 2.0}}, "phases": {"step": 1.0}}
    assert "no card" in got["FCOS"]["error"] and got["FCOS"]["serve"] == {
        "phases": {"full": 2.0}}
    assert set(got) == {"YOLOv2", *dec.FAMILIES}
