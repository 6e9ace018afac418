"""LH-RCNN's phases in the port's profilers (``scripts/profile_model_torch.py``,
``scripts/profile_decode_torch.py``) on the CPU: the spec at 192x320, batch
2, one warm-up and one timed call a phase; tpudet's two-stage split
(``scripts/profile_model.py::profile_lhrcnn``) with the RCNN phase's step
beside the RPN phase's. Everything is held against the port itself, bit for
bit.
"""

import numpy as np
import pytest
import torch

from test_torch_profile import _load, check_phases, tpudet_labels

torch.set_num_threads(1)

HW = (192, 320)
START_STEP = 7  # a global_step in the RPN phase, restored after every phase


@pytest.fixture(scope="module")
def prof():
    return _load("profile_model_torch.py", "_profile_model_torch")


def small_spec(prof, **config):
    spec = prof._specs()["LHRCNN"]
    return dict(spec, batch=2, shape=HW, config=dict(
        spec["config"], batch_size=2, data_shape=[*HW, 3], **config))


@pytest.fixture(scope="module")
def profiled(prof):
    """``profile_model("LHRCNN", ...)`` on the CPU from ``global_step``
    START_STEP; the record, the model it built with its batch, and the
    kernel counters before and after."""
    built = []

    def build(*args, **kw):
        model, x, g = real(*args, **kw)
        model.global_step = START_STEP
        built.append((model, x, g))
        return model, x, g

    real = prof.build
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prof, "build", build)
        before = prof.counts()
        record = prof.profile_model("LHRCNN", small_spec(prof), n=1, warmup=1, device="cpu")
    return record, built[0], before, prof.counts()


def test_lhrcnn_record_gives_tpudets_phases_and_no_launch_on_the_cpu(profiled):
    record, (model, _, _), before, after = profiled
    assert after == before
    _, lhrcnn_labels = tpudet_labels("profile_model.py")
    check_phases(record["phases"], lhrcnn_labels + ["step@rcnn"])
    for fig in record["phases"].values():
        assert (fig["device_ms"], fig["kernels"], fig["syncs"]) == (0, 0, 0)
        assert set(fig["launches"].values()) == {0}
    assert list(record["deltas"]) == ["rpn-sample", "roi+rcnn", "bwd@rpn", "bwd@rcnn",
                                      "step-over-grad", "step-over-grad@rcnn"]
    assert (record["batch"], record["shape"], record["device"]) == (2, list(HW), "cpu")
    assert model.global_step == START_STEP


def test_rpn_and_rcnn_phases_are_phase_losses(prof, profiled):
    """``+rpn`` and ``+rcnn`` are ``phase_loss`` of each phase, bit for bit;
    ``step@rcnn`` takes a step of the RCNN phase, which leaves the RPN
    scopes bit for bit."""
    _, (model, x, g), _, _ = profiled
    phases = prof.lhrcnn_phases(model, x, g)
    assert torch.equal(phases["+rpn"](), model.phase_loss(x, g, True))
    assert torch.equal(phases["+rcnn"](), model.phase_loss(x, g, False))
    rpn = {k: p.detach().clone() for k, p in model.net.named_parameters()
           if not k.startswith("rcnn.")}
    try:
        phases["step@rcnn"]()
        assert model.global_step == model.rpn_first_step + 1
    finally:
        model.global_step = START_STEP
    for k, p in model.net.named_parameters():
        if k in rpn:
            assert torch.equal(p.detach(), rpn[k]), k


def test_lhrcnn_decode_phase_is_test_one_images_answer(prof):
    dec = _load("profile_decode_torch.py", "_profile_decode_torch")
    model, img = dec.serve_model("LHRCNN", small_spec(prof, nms_score_threshold=0.01),
                                 "cpu")
    phases = dec.serve_phases(model, img)
    want = model.test_one_image(img)
    assert len(want[0]) > 0
    scores, boxes, cid, valid = (t.numpy() for t in phases["decode"]())
    for got, w in zip((scores[valid], boxes[valid], cid[valid]), want):
        np.testing.assert_array_equal(got, w)
