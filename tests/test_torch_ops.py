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
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

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
from torch_nms_cases import NAMES as NMS_CASES
from torch_nms_cases import corners, nms_case

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ package rules
def _imports(path):
    """The top-level names of every module ``path`` imports."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def _top_level_imports(path):
    """The top-level names of the modules ``path`` imports when it is itself
    imported: every import outside a function's body."""
    names = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names.extend(a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                names.append(child.module or "")
            visit(child)

    visit(ast.parse(path.read_text()))
    return names


def _sources(group):
    """``port``: every file of ``tpudet_torch``. ``chip_smoke``: the script and
    the helpers of ``tests/`` it imports (it runs where JAX is absent)."""
    if group == "port":
        paths = sorted((REPO / "tpudet_torch").rglob("*.py"))
        names = {str(p.relative_to(REPO / "tpudet_torch")) for p in paths}
        assert names >= {f"data/{m}.py" for m in (
            "classes", "example_proto", "tfrecord", "voc", "augment", "pipeline",
            "imagenet", "prng", "device_augment", "device_dataset")} | {f"runtime/{m}.py" for m in ("evaluate", "metrics", "summary")}
        return paths
    script = REPO / "chip_smoke.py"
    helpers = sorted(REPO / "tests" / f"{n}.py" for n in set(_imports(script))
                     if (REPO / "tests" / f"{n}.py").is_file())
    assert {p.name for p in helpers} >= {"torch_nms_cases.py", "torch_assign_cases.py"}
    return [script, *helpers]


@pytest.mark.parametrize("group", ["port", "chip_smoke"])
def test_port_sources_never_import_jax_flax_or_tpudet(group):
    """Nor ``lxml`` anywhere (the card's machine has none), nor ``cv2`` or
    ``PIL`` when a module is imported: only inside the function that decodes."""
    sources = _sources(group)
    bad = [f"{path.name}: {n}" for path in sources for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "tpudet", "lxml")]
    bad += [f"{path.name}: {n} at import" for path in sources
            for n in _top_level_imports(path) if n.split(".")[0] in ("cv2", "PIL")]
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
    args = (torch.zeros((2000, 4)), torch.zeros((2, 2000)), ns, 4, 0.5)
    with pytest.raises(TypeError, match="order"):
        nms_kernel.nms_rows(*args, torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="order"):
        nms_kernel.nms_rows(*args, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="sorted scan"):
        nms_kernel.nms_rows(*args, torch.zeros((2, 1025), dtype=torch.int32))


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


@pytest.mark.parametrize("name", NMS_CASES)
def test_plain_nms_equals_pallas_kernel(name):
    case = nms_case(name)
    _assert_same(_port(*case), _pallas(*case))


@pytest.mark.parametrize("name", ["pretopk", "exhaustion", "nan_row"])
def test_pretopk_equals_pallas_pretopk(name):
    case = nms_case(name)
    _assert_same(_port(*case, pretopk=True), _pallas(*case, pretopk=True))
    _assert_same(_port(*case, pretopk=True), _pallas(*case))


def test_pretopk_exhaustion_reruns_full_width(monkeypatch):
    calls = []
    real = nms_kernel.nms_rows

    def spy(boxes, scores, ns, max_out, thr, order=None):
        calls.append((scores.shape[-1], None if order is None else order.shape[-1]))
        return real(boxes, scores, ns, max_out, thr, order)

    monkeypatch.setattr(nms_kernel, "nms_rows", spy)
    sel, val = _port(*nms_case("exhaustion"), pretopk=True)
    assert calls == [(1200, 1024), (1200, None)]  # the pool's order, then full width
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


def test_nan_row_selects_nothing():
    boxes, scores, ns, max_out, thr = nms_case("nan_row")
    _, val = _port(boxes, scores, ns, max_out, thr)
    assert val.sum(-1).tolist()[1] == 0 and val[0].all() and val[2].sum() > 0


# ------------------------------------------------------------ the sorted scan
def _iou_matrix(bx):
    """``[P, Q]`` float32 IoU of candidate q against pick p, in the plain
    version's order of operations (``ops/nms.py``)."""
    y1, x1, y2, x2 = bx.unbind(-1)
    area = (y2 - y1) * (x2 - x1)
    inter = (torch.clamp(torch.minimum(y2[None, :], y2[:, None])
                         - torch.maximum(y1[None, :], y1[:, None]), min=0.0)
             * torch.clamp(torch.minimum(x2[None, :], x2[:, None])
                           - torch.maximum(x1[None, :], x1[:, None]), min=0.0))
    return inter / (area[None, :] + area[:, None] - inter)


def _bitmask_scan(boxes, scores, num_select, max_out, thr):
    """Plain-torch mirror of ``csrc/nms.cu``'s sorted bitmask scan: the upper
    triangle of IoU bits in sorted positions packed into 64-bit words, then a
    walk over the words that takes the lowest live bit and ORs in its row."""
    b, n = scores.shape
    order = nms_kernel.stable_order(scores).long()
    bx = boxes if boxes.dim() == 3 else boxes.expand(b, n, 4)
    sel = torch.zeros((b, max_out), dtype=torch.int32)
    valid = torch.zeros((b, max_out), dtype=torch.bool)
    words = -(-n // 64)
    for r in range(b):
        s = scores[r][order[r]]
        dead = ~(s > t_nms.NEG / 2)
        n_live = int(torch.nonzero(dead)[0, 0]) if bool(dead.any()) else n
        hit = (_iou_matrix(bx[r][order[r]]) > thr) & torch.ones(n, n, dtype=torch.bool).triu(1)
        bits = np.zeros((n, words * 64), np.uint8)
        bits[:, :n] = hit.numpy()
        mask = np.packbits(bits, axis=1, bitorder="little").view(np.uint64)  # [n, words]
        removed = [0] * words
        k, n_sel = 0, min(int(num_select[r]), max_out)
        for w in range(words):
            if 64 * w >= n_live or k >= n_sel:
                break
            cur = removed[w]
            span = (1 << min(64, n_live - 64 * w)) - 1
            live = ~cur & span
            while live and k < n_sel:
                t = (live & -live).bit_length() - 1
                p = 64 * w + t
                sel[r, k], valid[r, k] = int(order[r, p]), True
                k += 1
                cur |= int(mask[p, w]) | (1 << t)
                for u in range(w + 1, words):
                    removed[u] |= int(mask[p, u])
                live = ~cur & span
    return sel, valid


@pytest.mark.parametrize("name", NMS_CASES)
def test_sorted_bitmask_scan_equals_plain_nms(name):
    boxes, scores, ns, max_out, thr = nms_case(name)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(ns))
    want = t_nms.batched_greedy_nms(*args, max_out, thr)
    got = _bitmask_scan(*args, max_out, thr)
    _assert_same(tuple(t.numpy() for t in got), tuple(t.numpy() for t in want))


_coord = st.floats(0, 100, width=32)
_side = st.one_of(st.just(0.0), st.floats(0, 50, width=32))


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 48).flatmap(lambda n: st.tuples(
    arrays(np.float32, (n, 2), elements=_coord), arrays(np.float32, (n, 2), elements=_side))))
def test_iou_is_symmetric_bit_for_bit(corner_and_size):
    """One triangle of the mask suffices: IoU(i, j) and IoU(j, i) have the same
    bits, zero-area pairs (NaN) included."""
    y1x1, hw = corner_and_size
    bx = torch.from_numpy(np.concatenate([y1x1, y1x1 + hw], -1))
    iou = _iou_matrix(bx)
    assert torch.equal(iou.view(torch.int32), iou.T.contiguous().view(torch.int32))


@pytest.mark.parametrize("width,path", [(1, "sorted_scan"), (512, "sorted_scan"),
                                        (768, "sorted_scan"), (1024, "sorted_scan"),
                                        (1025, "per_pick"), (8828, "per_pick")])
def test_scan_path_routes_by_width(width, path):
    assert nms_kernel.scan_path(width) == path


_score = st.one_of(st.sampled_from([float("nan"), -0.0, 0.0, 0.5, 1.0, -1e30,
                                    float("inf"), float("-inf")]),
                   st.floats(-2, 2, width=32))


@settings(max_examples=80, deadline=None, database=None)
@given(arrays(np.float32, st.tuples(st.integers(1, 3), st.integers(1, 40)),
              elements=_score))
def test_stable_order_is_descending_nan_first_ties_by_index(scores):
    order = nms_kernel.stable_order(torch.from_numpy(scores))
    assert order.dtype == torch.int32 and order.shape == scores.shape
    for row, got in zip(scores, order.tolist()):
        want = sorted(range(len(row)),
                      key=lambda i: (not np.isnan(row[i]),
                                     0.0 if np.isnan(row[i]) else -float(row[i]), i))
        assert got == want
