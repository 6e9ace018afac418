"""The port's ops against tpudet's on the same numpy inputs.

Box geometry and anchors must agree with tpudet; the plain batched greedy NMS
must select EXACTLY what tpudet's Pallas kernels select in interpret mode, on
the cases of tests/test_pallas_nms.py (``torch_nms_cases.py``). The CUDA
kernel is held against the plain version in ``test_torch_cuda.py``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import anchors as jax_anchors
from tpudet.ops import boxes as jax_boxes
from tpudet.ops import nms as jax_nms
from tpudet.ops.pallas.nms_kernel import (batched_greedy_nms_pallas,
                                          batched_greedy_nms_pretopk)
from tpudet_torch.ops import anchors as t_anchors
from tpudet_torch.ops import boxes as t_boxes
from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import build as t_build
from tpudet_torch.ops.cuda import nms_kernel
from torch_nms_cases import corners, nms_case

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ package rules
def _port_sources():
    return sorted((REPO / "tpudet_torch").rglob("*.py"))


def test_port_sources_never_import_jax_flax_or_tpudet():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "tpudet")]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, pkgutil, sys, tpudet_torch\n"
            "for m in pkgutil.walk_packages(tpudet_torch.__path__, 'tpudet_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpudet'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nvcc_flags_keep_float_results_exact():
    flags = " ".join(t_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert t_build.library_path("nms").name.startswith("nms-")


def test_kernel_wrapper_checks_device_shape_dtype_and_layout():
    boxes = torch.zeros((8, 4), device="meta")
    scores = torch.zeros((2, 8), device="meta")
    ns = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        nms_kernel.nms_rows(boxes, scores, ns, 4, 0.5)
    ns = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="boxes"):
        nms_kernel.nms_rows(torch.zeros((7, 4)), torch.zeros((2, 8)), ns, 4, 0.5)
    # the CPU takes the kernel's input contract too, so CPU runs catch callers
    # that would fail on the card
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(torch.zeros((8, 4)), torch.zeros((2, 8)).double(), ns, 4, 0.5)
    with pytest.raises(TypeError):
        nms_kernel.nms_rows(torch.zeros((8, 4)), torch.zeros((2, 8)), ns.long(), 4, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_kernel.nms_rows(torch.zeros((8, 4)), torch.zeros((8, 2)).T, ns, 4, 0.5)


# ------------------------------------------------------------ boxes/anchors
def _box_cases():
    rng = np.random.default_rng(3)
    yx = rng.uniform(0, 50, (6, 2)).astype(np.float32)
    hw = rng.uniform(1, 20, (6, 2)).astype(np.float32)
    g = corners(rng, (5,))
    a = corners(rng, (9,))
    b1 = corners(rng, (7,))
    b2 = corners(rng, (7,))
    p = (rng.normal(size=(6, 2)) * 0.3).astype(np.float32)
    return {
        "center_to_corners": ((yx, hw), {}),
        "corners_to_center": ((yx - hw / 2, yx + hw / 2), {}),
        "area": ((hw,), {}),
        "pairwise_iou": ((g[:, :2], g[:, 2:], a[:, :2], a[:, 2:]), {}),
        "iou_corner": ((b1, b2), {}),
        "encode": ((yx, hw, yx[::-1].copy(), hw[::-1].copy()), {}),
        "decode": ((p, p, yx, hw), {}),
        "clip_corners": ((yx - hw, yx + hw), {"height": 30.0, "width": 40.0}),
    }


@pytest.mark.parametrize("name", sorted(_box_cases()))
def test_boxes_match_tpudet(name):
    args, kw = _box_cases()[name]
    want = getattr(jax_boxes, name)(*map(jnp.asarray, args), **kw)
    got = getattr(t_boxes, name)(*map(torch.from_numpy, args), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("call", [
    ("grid_anchors", (5, 3, [[10.0, 10.0], [14.0, 7.0]], 7.5, 12.0)),
    ("ssd_scale_pairs", (300.0, 6)),
    ("ssd_priors", ([60.0, 84.0], [2, 1 / 2, 3, 1 / 3])),
    ("retina_priors", (32.0, [0.5, 1.0, 2.0], [1.0, 2 ** (1 / 3), 2 ** (2 / 3)])),
])
def test_anchors_match_tpudet(call):
    name, args = call
    want, got = getattr(jax_anchors, name)(*args), getattr(t_anchors, name)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_concat_levels_matches_tpudet():
    lv = [jax_anchors.grid_anchors(4, 4, [[8.0, 8.0]], 4.0, 4.0),
          jax_anchors.grid_anchors(2, 2, [[16.0, 16.0], [20.0, 10.0]], 8.0, 8.0)]
    for w, g in zip(jax_anchors.concat_levels(lv), t_anchors.concat_levels(lv)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ greedy NMS
def _pallas(boxes, scores, ns, max_out, thr, pretopk=False):
    fn = batched_greedy_nms_pretopk if pretopk else batched_greedy_nms_pallas
    sel, val = fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ns),
                  max_out=max_out, iou_threshold=thr, interpret=True)
    return np.asarray(sel), np.asarray(val)


def _port(boxes, scores, ns, max_out, thr, pretopk=False):
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(ns))
    if pretopk:
        sel, val = nms_kernel.batched_greedy_nms_pretopk(*args, max_out, thr)
    else:
        sel, val = t_nms.batched_greedy_nms(*args, max_out, thr)
    assert sel.dtype == torch.int32 and val.dtype == torch.bool
    return sel.numpy(), val.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("name", ["random0", "random1", "per_row_boxes", "pretopk",
                                  "exhaustion", "zero_area", "ties"])
def test_plain_nms_equals_pallas_kernel(name):
    case = nms_case(name)
    _assert_same(_port(*case), _pallas(*case))


@pytest.mark.parametrize("name", ["pretopk", "exhaustion"])
def test_pretopk_equals_pallas_pretopk(name):
    case = nms_case(name)
    _assert_same(_port(*case, pretopk=True), _pallas(*case, pretopk=True))
    _assert_same(_port(*case, pretopk=True), _pallas(*case))


def test_pretopk_exhaustion_reruns_full_width(monkeypatch):
    calls = []
    real = nms_kernel.nms_rows

    def spy(boxes, scores, *a):
        calls.append(scores.shape[-1])
        return real(boxes, scores, *a)

    monkeypatch.setattr(nms_kernel, "nms_rows", spy)
    sel, val = _port(*nms_case("exhaustion"), pretopk=True)
    assert calls == [1024, 1200]
    assert int(val.sum()) == 60


def test_zero_area_boxes_terminate_without_duplicates():
    sel, val = _port(*nms_case("zero_area"))
    got = sel[0][val[0]]
    assert len(set(got.tolist())) == len(got) == 4


def test_greedy_nms_single_row_matches_tpudet():
    rng = np.random.default_rng(2)
    boxes = corners(rng, (150,), 0, 80, 4, 30)
    scores = rng.uniform(0, 1, 150).astype(np.float32)
    active = rng.uniform(size=150) < 0.6
    want = jax_nms.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 24, 0.45,
                              active=jnp.asarray(active), num_select=jnp.int32(11))
    got = t_nms.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 24, 0.45,
                           active=torch.from_numpy(active), num_select=11)
    _assert_same(tuple(t.numpy() for t in got), tuple(np.asarray(w) for w in want))


def test_batched_nms_active_mask_matches_tpudet():
    """Exact: the ``active`` mask of the mining call, with per-row budgets."""
    boxes, scores, ns, max_out, thr = nms_case("random0")
    active = np.random.default_rng(4).uniform(size=scores.shape) < 0.5
    want = jax_nms.batched_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(ns), max_out, thr,
                                      active=jnp.asarray(active))
    t_scores = torch.tensor(scores, requires_grad=True)
    got = t_nms.batched_greedy_nms(torch.from_numpy(boxes), t_scores, torch.from_numpy(ns),
                                   max_out, thr, active=torch.from_numpy(active))
    _assert_same(tuple(t.numpy() for t in got), tuple(np.asarray(w) for w in want))
    assert not any(t.requires_grad for t in got)


@pytest.mark.parametrize("impl", ["vmap", "batched"])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_class_nms_matches_tpudet(monkeypatch, impl, seed):
    monkeypatch.setenv("TPUDET_PCNMS_IMPL", impl)
    rng = np.random.default_rng(seed)
    n, c, max_out = 900, 7, 12  # n > 512: the pre-top-k pool is taken
    boxes = corners(rng, (n,), 0, 80, 4, 40)
    scores = rng.uniform(0, 1, (c, n)).astype(np.float32)
    class_active = rng.uniform(0, 1, (n,)) > 0.2
    wb, ws, wv, _ = jax_nms.per_class_nms(
        jnp.asarray(boxes), jnp.asarray(scores), 0.35, 64, max_out, 0.5,
        class_active=jnp.asarray(class_active))
    gb, gs, gv = t_nms.per_class_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.35, max_out, 0.5,
        class_active=torch.from_numpy(class_active))
    wv = np.asarray(wv)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > c
    np.testing.assert_allclose(gs.numpy()[wv], np.asarray(ws)[wv], rtol=1e-6)
    np.testing.assert_allclose(gb.numpy()[wv], np.asarray(wb)[wv], rtol=1e-6)
