"""The cut RCNN step of ``tests/torch_lhrcnn_free_run.py`` at 192x320, batch
2, float32, with the LHRCNN-long spec's device flips.

The free run feeds both packages' RCNN steps from one trunk, tpudet's. So
each package's cut step (the trunk's ``c4`` and sample in, the ``rcnn``
scope's update out) must be its own full train step of the RCNN phase; the
port's cut steps must track tpudet's; and the port's sampling must pick
what tpudet's picks on the same RPN outputs.

Tolerances, each with its reason: a package's cut step against its full
step, the loss and the ``rcnn`` scope's parameters, velocity and BatchNorm
statistics to 1e-5 (normwise), the other scopes bit for bit (tpudet jits
the cut step apart from the trunk, so XLA may fuse it otherwise); three cut
steps of the port against tpudet's, the loss to 1e-5 and the scope's state
to 4x the port's own difference between its two CPU summation orders, or
1e-4 where that is larger (``tests/test_torch_lhrcnn_step.py``'s); the
picks exactly.

The free run found the port's picks on a trained RPN's outputs ordered two
near-tied negatives otherwise than tpudet's, and once took another negative
at the budget's edge: XLA's and PyTorch's ``exp`` and ``log`` differ in the
last bit, and so do the two scores. The near-tie test holds the port there
on three such images' scores (``tests/torch_data/lhrcnn_rpn_near_ties.npz``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_lhrcnn_free_run as fr
from pathlib import Path

from tpudet.heads import lhrcnn as jax_lh
from tpudet.ops import nms as jax_nms
from tpudet_torch.heads import lhrcnn as t_lh
from tpudet_torch.models.base import _copy_state
from tpudet_torch.models.lhrcnn import RCNN_SCOPES
from tpudet_torch.runtime import transfer
from test_torch_lhrcnn import (DRIVER_HW, HW, anchors_at, config, gt_batch, port_model,
                               tpudet_model)
from torch_anchor_free_common import port_opt_state, random_opt_state
from torch_refine_common import tree_rel

torch.set_num_threads(1)

LR = 3e-4  # the LHRCNN-long spec's in its RCNN phase
STEP = 3  # rpn_first_step: the first RCNN step
KW = dict(rcnn_first_step=10, device_augment={"flip_prob": [0.5, 0.5]})


@pytest.fixture(scope="module")
def pair():
    jm, variables = tpudet_model(config(**KW))
    opt = random_opt_state(jm, variables["params"], np.random.default_rng(21))
    return jm, variables, opt, fr.tpudet_trunk(jm), fr.tpudet_rcnn_step(jm)


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, *HW, 3)).astype(np.float32)
    gt = gt_batch(rng, HW)
    gt[1, :3] = [[60, 90, 70, 100, 3], [120, 240, 50, 60, 0], [100, 160, 150, 280, 2]]
    return images, gt


def _rcnn(tree):
    return {k: v for k, v in tree.items() if k.split(".", 1)[0] in RCNN_SCOPES}


def _load(pm, variables, opt, step):
    transfer.load_flax(pm.net, variables)
    _copy_state(pm.opt_state, port_opt_state(opt))
    pm.global_step = step


def _snapshot(pm):
    return ({k: v.clone() for k, v in pm.net.state_dict().items()},
            {k: v.clone() for k, v in pm.velocity.items()})


def _check_cut(full, cut, init, loss, cut_loss):
    """``cut`` (state, velocity) against ``full``: the loss and the ``rcnn``
    scope to 1e-5, every other leaf bit for bit and as it was."""
    np.testing.assert_allclose(cut_loss, loss, rtol=1e-5)
    for got, want, start in zip(cut, full, init):
        assert tree_rel(_rcnn(got), _rcnn(want)) < 1e-5
        assert not torch.equal(torch.cat([v.flatten() for v in _rcnn(got).values()]),
                               torch.cat([v.flatten() for v in _rcnn(start).values()]))
        for k in start:
            if k.split(".", 1)[0] not in RCNN_SCOPES and not k.endswith((".mean", ".var")):
                assert torch.equal(got[k], start[k]) and torch.equal(want[k], start[k]), k


def test_cut_step_is_each_packages_own_rcnn_step(pair):
    """tpudet's jitted ``_train_step_fn`` at an RCNN step against its trunk
    then its cut step; the port's ``train_step`` against ``port_trunk``
    then ``port_rcnn_step``; each from the same state and velocity."""
    jm, variables, opt, trunk, rcnn_step = pair
    images, gt = _batch(4)
    args = (jnp.asarray(images), jnp.asarray(gt))
    w_params, w_stats, w_opt, w_loss = jax.device_get(jax.jit(jm._train_step_fn)(
        variables["params"], variables["batch_stats"], opt, *args, jnp.float32(LR),
        jnp.int32(STEP)))
    t = trunk(variables["params"], variables["batch_stats"], *args, jnp.int32(STEP))
    c_params, c_stats, c_vel, c_loss = jax.device_get(rcnn_step(
        variables["params"]["rcnn"], variables["batch_stats"]["rcnn"],
        opt.velocity["rcnn"], t["c4"], t["sample"], jnp.float32(LR)))
    assert jnp.any(t["sample"].pos_valid) and jnp.any(t["sample"].neg_valid)

    def as_port(params, stats, vel):
        return (transfer.from_flax({"params": params, "batch_stats": stats}),
                transfer.velocity_from_flax(vel))

    init = as_port(variables["params"], variables["batch_stats"], opt.velocity)
    full = as_port(w_params, w_stats, w_opt.velocity)
    cut = as_port(dict(variables["params"], rcnn=c_params),
                  dict(w_stats, rcnn=c_stats), dict(opt.velocity, rcnn=c_vel))
    _check_cut(full, cut, init, float(w_loss), float(c_loss))

    pm = port_model(variables, **KW)
    x, g = pm._to_device(images, gt)
    _load(pm, variables, opt, STEP)
    loss = float(pm.train_step(x, g, LR))
    full = _snapshot(pm)
    _load(pm, variables, opt, STEP)
    c4, sample = fr.port_trunk(pm, x, g)
    cut_loss = float(fr.port_rcnn_step(pm, c4, sample, LR))
    assert pm.global_step == STEP + 1
    _check_cut(full, _snapshot(pm), init, loss, cut_loss)


def test_three_cut_steps_of_the_port_track_tpudets(pair):
    """Three steps of both packages' cut RCNN steps from one state and
    velocity, each on tpudet's trunk of its batch (a flip drawn at each
    step): the loss at each step, then the ``rcnn`` scope's parameters,
    BatchNorm statistics and velocity."""
    jm, variables, opt, trunk, rcnn_step = pair
    params, stats, vel = (variables["params"]["rcnn"], variables["batch_stats"]["rcnn"],
                          opt.velocity["rcnn"])
    pm = port_model(variables, **KW)
    trunks, losses = [], []
    for s in range(3):
        images, gt = _batch(10 + s)
        t = trunk(variables["params"], variables["batch_stats"], jnp.asarray(images),
                  jnp.asarray(gt), jnp.int32(STEP + s))
        trunks.append((fr.nchw(t["c4"]), fr.torch_sample(t["sample"])))
        params, stats, vel, loss = rcnn_step(params, stats, vel, t["c4"], t["sample"],
                                             jnp.float32(LR))
        losses.append(float(loss))
    want = (transfer.from_flax(jax.device_get({"params": {"rcnn": params},
                                               "batch_stats": {"rcnn": stats}})),
            transfer.velocity_from_flax(jax.device_get({"rcnn": vel})))

    def port_steps():
        _load(pm, variables, opt, STEP)
        out = [float(fr.port_rcnn_step(pm, c4, sample, LR)) for c4, sample in trunks]
        state, velocity = _snapshot(pm)
        return out, (_rcnn(state), _rcnn(velocity))

    got_losses, got = port_steps()
    with torch.backends.mkldnn.flags(enabled=False):  # the other summation order
        _, other = port_steps()
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    for g, o, w in zip(got, other, want):
        assert set(g) == set(w)
        assert tree_rel(g, w) < max(1e-4, 4 * tree_rel(o, g))


def test_port_sample_picks_tpudets_on_its_rpn_outputs(pair):
    """The port's ``rpn_loss_and_sample`` on tpudet's train-mode RPN outputs
    and flipped gts: both NMS calls' selections and valid masks, and the
    positives' labels, exactly; every field of the sample as
    ``tests/test_torch_lhrcnn.py`` holds it."""
    jm, variables, _, trunk, _ = pair
    pm = port_model(variables, **KW)
    for seed in (4, 5):
        images, gt = _batch(seed)
        t = jax.device_get(trunk(variables["params"], variables["batch_stats"],
                                 jnp.asarray(images), jnp.asarray(gt), jnp.int32(STEP)))
        heads = [torch.from_numpy(np.array(t[k])) for k in ("pyx", "phw", "pconf", "gt")]
        picks, sample = fr.port_picks(pm, *heads)
        assert len(fr.mismatched_images(t["picks"], t["sample"].pos_label, picks,
                                        sample.pos_label)) == 0
        for g, w in zip(picks, t["picks"]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert t["picks"][1].any() and t["picks"][3].any()
        for name, g, w in zip(sample._fields, sample, t["sample"]):
            if g.dtype in (torch.bool, torch.int32):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            else:
                atol = 1e-4 if name.endswith("proposal") else 1e-6
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=atol, err_msg=name)


def test_port_sampling_on_near_tied_trained_scores():
    """Three images of the free run at 700x1100 (its steps 5001, 5002 and
    5076) whose RPN confidences give negatives that tie within an ulp. The
    port's matching and budgets equal tpudet's exactly and its two scores
    (the positives' objectness, the negatives' CE) are within 2 ulps of
    tpudet's at their scale (XLA's and PyTorch's ``exp`` and ``log`` round
    differently); on tpudet's scores the port's NMS picks tpudet's exactly.
    On its own scores it keeps the valid masks, and wherever its pick
    differs from tpudet's the two anchors' scores (tpudet's) tie within
    those 2 ulps: the first two images take the same sets in another
    order, the third, at the budget's edge, one other negative."""
    data = np.load(Path(__file__).parent / "torch_data" / "lhrcnn_rpn_near_ties.npz")
    pconf, gt = data["pconf"], data["gt"]
    (j_anc, _), (t_anc, _) = anchors_at(DRIVER_HW)

    def jax_side(pconf, gt):
        pre = jax.vmap(lambda c, g: jax_lh._rpn_pre_nms(None, None, c, j_anc, g))(pconf, gt)
        pos = jax_nms.batched_greedy_nms(pre.row_boxes, pre.row_obj_prob, pre.chosen_pos,
                                         jax_lh.POS_CAP, 0.7, active=pre.row_valid)
        corners = jnp.concatenate([j_anc.y1x1, j_anc.y2x2], -1)
        neg = jax_nms.batched_greedy_nms(corners, pre.neg_ce, pre.chosen_neg,
                                         jax_lh.TOTAL_CAP, 0.7, active=pre.neg)
        return pre, (*pos, *neg)

    pre, want = jax.device_get(jax.jit(jax_side)(pconf, gt))
    rows = t_lh.rpn_rows(torch.from_numpy(pconf), t_anc, torch.from_numpy(gt))
    for name in ("row_valid", "row_anchor", "row_gt", "chosen_pos", "neg", "chosen_neg"):
        np.testing.assert_array_equal(getattr(rows, name).numpy(), getattr(pre, name),
                                      err_msg=name)
    # 2 ulps of 1 for a probability, of the largest logit for a CE (it
    # cancels the max logit against the picked one)
    tols = {name: 2 * np.spacing(np.float32(unit))
            for name, unit in (("row_obj_prob", 1.0), ("neg_ce", np.abs(pconf).max()))}
    for name, tol in tols.items():
        np.testing.assert_allclose(getattr(rows, name).numpy(), getattr(pre, name), rtol=0,
                                   atol=tol, err_msg=name)
    scored = rows._replace(row_obj_prob=torch.tensor(pre.row_obj_prob),
                           neg_ce=torch.tensor(pre.neg_ce))
    for g, w in zip(t_lh.rpn_select(scored, t_anc), want):
        np.testing.assert_array_equal(g.numpy(), w)
    own = [g.numpy() for g in t_lh.rpn_select(rows, t_anc)]
    for k, name in ((0, "row_obj_prob"), (2, "neg_ce")):
        np.testing.assert_array_equal(own[k + 1], want[k + 1])
        scores = getattr(pre, name)
        b, j = np.nonzero((own[k] != want[k]) & want[k + 1])
        gap = np.abs(scores[b, own[k][b, j]] - scores[b, want[k][b, j]])
        assert np.all(gap <= tols[name]), (name, gap.max())
    labels = np.zeros(np.shape(want[0]), np.int32)  # the sets, not the labels
    assert [fr.same_sets(want, labels, [torch.from_numpy(g) for g in own],
                         torch.from_numpy(labels), i) for i in range(len(gt))] == [
        True, True, False]


@pytest.mark.parametrize("port_over,verdict", [(1.03, "port_rcnn_step_at_fault"),
                                               (1.005, "rcnn_step_cleared"),
                                               (1.015, "undecided")])
def test_free_run_windows_and_rule(tmp_path, port_over, verdict):
    """``compare_runs_torch.free_run`` on records made up for steps
    5000-5999: the CPU steps averaged over the spec's 50-step epochs that
    begin at or after 5000 (the epoch 4960-5009 left out on every curve),
    the last record of a step that a resumed run wrote twice, the windows
    of 250 steps and the rule of ``PERF.md``."""
    import json

    fr._paths()
    import compare_runs_torch as cr

    run = tmp_path / "torch_runs" / cr.FREE_RUN
    run.mkdir(parents=True)
    with open(run / "steps.jsonl", "w") as f:
        for s in range(5000, 6000):
            f.write(json.dumps({"step": s, "tpudet_loss": 1.0 + (s % 50 == 10),
                                "port_loss": port_over * (1.0 + (s % 50 == 10)),
                                "sample_mismatch": [3] if s == 5076 else [],
                                "mismatch_same_sets": [False] if s == 5076 else []}) + "\n")
    for name, loss in ((f"torch_runs/{cr.CARD_RERUN}", 1.0), ("runs/LHRCNN-long", 0.97)):
        (tmp_path / name).mkdir(parents=True, exist_ok=True)
        recs = [{"step": e, "mean_loss": loss * 1.02} for e in range(5010, 6011, 50)]
        recs += [{"step": 5060, "mean_loss": 9.0}, {"step": 5060, "mean_loss": loss * 1.02}]
        (tmp_path / name / "curve.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in recs))
    out = cr.free_run(root=str(tmp_path))
    assert out["start"] == 5000 and out["steps"] == 1000
    assert sorted(out["windows"]) == [5250, 5500, 5750, 6000]
    assert out["windows"][5250]["tpudet_cpu"] == pytest.approx(1.02)  # 5010-5209
    assert out["windows"][5250]["tpudet_tpu"] == pytest.approx(0.9894)
    assert set(out["port_cpu_over_tpudet_cpu_pct"].values()) == {
        round(100 * (port_over - 1), 2)}
    assert (out["sample_mismatched_images"], out["mismatched_images_with_other_sets"]) == (1, 1)
    assert out["verdict"] == verdict
    if verdict == "rcnn_step_cleared":
        assert set(out["cpu_curves_nearer"].values()) == {"port_card"}
