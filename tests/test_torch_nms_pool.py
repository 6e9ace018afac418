"""The NMS pool's design on the card, mirrored in plain numpy/torch on the CPU.

``csrc/nms.cu`` selects each row's pool with a radix select (8-bit digits,
ties to the lowest index, a bitonic sort of the winners), scans it with the
sorted bitmask scan, and continues a row that ran out tile by tile after the
pool's last rank word: the next tile's selection, the kill by every earlier
pick, the tile's upper-triangle IoU bitmask and the warp's walk over it. The
mirror below follows those steps; it must equal the plain full-width greedy
NMS and tpudet's ``batched_greedy_nms_pretopk`` in interpret mode, with small
pools and tiles so that continuations cross several tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from tpudet.ops.pallas.nms_kernel import batched_greedy_nms_pretopk
from tpudet_torch.ops import nms as t_nms
from tpudet_torch.ops.cuda import nms_kernel
from torch_nms_cases import NAMES as NMS_CASES
from torch_nms_cases import corners, nms_case

torch.set_num_threads(1)

NEG_HALF = np.float32(-5e29)
MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ the mirror
def sort_keys(s):
    """``sort_key`` of ``csrc/nms.cu``: canonical NaN and zero, then bits
    mapped so that unsigned order is the scores' order (uint64 holding 32 bits)."""
    s = np.asarray(s, np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(np.isnan(s), np.uint64(0x7FC00000), u)
    u = np.where((u & np.uint64(0x7FFFFFFF)) == 0, np.uint64(0), u)
    neg = (u & np.uint64(0x80000000)) != 0
    return np.where(neg, ~u & np.uint64(MASK32), u | np.uint64(0x80000000))


def rank_words(keys, idx):
    idx = np.asarray(idx, np.uint64)
    return (keys << np.uint64(32)) | (~idx & np.uint64(MASK32))


def index_of(words):
    return (~np.asarray(words, np.uint64) & np.uint64(MASK32)).astype(np.int64)


def bitonic_desc(words):
    """The kernel's bitonic network over the next power of two, padded with 0."""
    size = 1
    while size < len(words):
        size *= 2
    w = np.zeros(size, np.uint64)
    w[:len(words)] = words
    i = np.arange(size)
    k = 2
    while k <= size:
        j = k // 2
        while j > 0:  # one stage: every pair (i, i ^ j) with i < i ^ j at once
            lo = i[(i ^ j) > i]
            hi = lo ^ j
            a, b = w[lo], w[hi]
            swap = np.where((lo & k) == 0, a < b, a > b)
            w[lo] = np.where(swap, b, a)
            w[hi] = np.where(swap, a, b)
            j //= 2
        k *= 2
    return w[:len(words)]


def block_select(s, count, key_floor=0, cursor=None):
    """``block_select``: the first ``min(count, M)`` rank words, in stable
    descending order, of the M entries with a key above ``key_floor`` and a
    rank word below ``cursor``."""
    keys = sort_keys(s)
    words = rank_words(keys, np.arange(len(keys)))
    cand = keys > np.uint64(key_floor)
    if cursor is not None:
        cand &= words < np.uint64(cursor)
    prefix, fixed, need = 0, 0, count
    for shift in (24, 16, 8, 0):
        match = cand & ((keys & np.uint64(fixed)) == np.uint64(prefix))
        digits = ((keys[match] >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
        hist = np.bincount(digits, minlength=256)
        if shift == 24:
            need = min(need, int(match.sum()))
            if need == 0:
                return np.zeros(0, np.uint64)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= need:
                break
            above += int(hist[d])
        prefix |= d << shift
        fixed |= 0xFF << shift
        need -= above
        if hist[d] == need:
            break
    masked = keys & np.uint64(fixed)
    tie = cand & (masked == np.uint64(prefix))
    tie_rank = np.cumsum(tie) - tie
    win = (cand & (masked > np.uint64(prefix))) | (tie & (tie_rank < need))
    return bitonic_desc(words[win])


def _iou_above(cands, picks, thr):
    """``[P, Q]``: IoU of candidate q against pick p > thr, in the plain
    version's order of operations (``ops/nms.py``)."""
    c = torch.from_numpy(np.asarray(cands, np.float32)).reshape(-1, 4)
    p = torch.from_numpy(np.asarray(picks, np.float32)).reshape(-1, 4)
    cy1, cx1, cy2, cx2 = (t[None, :] for t in c.unbind(-1))
    py1, px1, py2, px2 = (t[:, None] for t in p.unbind(-1))
    area = (cy2 - cy1) * (cx2 - cx1)
    parea = (py2 - py1) * (px2 - px1)
    inter = (torch.clamp(torch.minimum(cy2, py2) - torch.maximum(cy1, py1), min=0.0)
             * torch.clamp(torch.minimum(cx2, px2) - torch.maximum(cx1, px1), min=0.0))
    return (inter / (area + parea - inter) > thr).numpy()


def walk(alive, hit, budget):
    """The warp's walk over a tile: positions in order, 32-bit words one a
    lane; ``alive`` [c] bool, ``hit`` [c, c] the upper triangle; returns the
    positions picked, at most ``budget``."""
    c = len(alive)
    words = -(-c // 32)
    bits = np.zeros((c, words * 32), np.uint8)
    bits[:, :c] = np.triu(hit, 1)
    mask = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)  # [c, words]
    alive_bits = np.zeros(words * 32, np.uint8)
    alive_bits[:c] = alive
    alive_words = np.packbits(alive_bits, bitorder="little").view(np.uint32)
    removed = [0] * words
    picks = []
    for w in range(words):
        if len(picks) >= budget:
            break
        rng = (1 << min(32, c - 32 * w)) - 1
        live = int(alive_words[w]) & ~removed[w] & rng
        while live and len(picks) < budget:
            t = (live & -live).bit_length() - 1
            p = 32 * w + t
            picks.append(p)
            row = mask[p]
            live &= ~(int(row[w]) | (1 << t))
            for u in range(w + 1, words):
                removed[u] |= int(row[u])
    return picks


def mirror_pool(boxes, scores, num_select, max_out, thr, pool, tile):
    """The card's pool call, row by row: select ``pool`` positions, scan them,
    continue a row that ran out in tiles of ``tile``. Returns ``(sel, valid,
    continued rows)``."""
    b, n = scores.shape
    bx = boxes if boxes.ndim == 3 else np.broadcast_to(boxes, (b, n, 4))
    sel = np.zeros((b, max_out), np.int32)
    valid = np.zeros((b, max_out), bool)
    p = min(pool, n)
    continued = 0
    for r in range(b):
        s = scores[r]
        n_sel = min(int(num_select[r]), max_out)
        words = block_select(s, p)
        order = index_of(words)
        live = int((s > NEG_HALF).sum())
        dead = ~(s[order] > NEG_HALF)
        n_live = int(np.argmax(dead)) if dead.any() else p
        hit = _iou_above(bx[r][order], bx[r][order], thr)
        picked = [int(order[q]) for q in walk(np.arange(p) < n_live, hit, n_sel)]
        ran_out = len(picked) < min(n_sel, live) and live > p
        if ran_out and not np.isnan(s[order[0]]):
            continued += 1
            cursor = words[-1]
            floor = int(sort_keys(np.asarray([NEG_HALF]))[0])
            while len(picked) < n_sel:
                tw = block_select(s, tile, floor, cursor)
                c = len(tw)
                if c == 0:
                    break
                idx = index_of(tw)
                cursor = tw[-1]
                alive = np.ones(c, bool)
                if picked:
                    alive = ~_iou_above(bx[r][idx], bx[r][picked], thr).any(0)
                hit = _iou_above(bx[r][idx], bx[r][idx], thr)
                picked += [int(idx[q]) for q in walk(alive, hit, n_sel - len(picked))]
                if c < tile:
                    break
        sel[r, :len(picked)] = picked
        valid[r, :len(picked)] = True
    return sel, valid, continued


# ------------------------------------------------------------ cases
def _plain(boxes, scores, ns, max_out, thr):
    got = t_nms.batched_greedy_nms(torch.from_numpy(np.ascontiguousarray(boxes)),
                                   torch.from_numpy(scores), torch.from_numpy(ns),
                                   max_out, thr)
    return tuple(t.numpy() for t in got)


def _pallas_pretopk(boxes, scores, ns, max_out, thr):
    sel, val = batched_greedy_nms_pretopk(jnp.asarray(boxes), jnp.asarray(scores),
                                          jnp.asarray(ns), max_out=max_out,
                                          iou_threshold=thr, interpret=True)
    return np.asarray(sel), np.asarray(val)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def edge_case(name):
    """(boxes, scores, num_select, max_out, iou_threshold) of the pool's edges."""
    rng = np.random.default_rng(23)
    n = 96
    boxes = corners(rng, (n,), 0, 60, 4, 30)
    if name == "ties_across_edge":  # equal keys straddle position 8 and every tile
        scores = np.round(rng.uniform(0, 1, (3, n)), 1).astype(np.float32)
        return boxes, scores, np.asarray([40, 12, 96], np.int32), 48, 0.4
    if name == "signed_zeros":  # -0.0 and +0.0 are one key: index order
        scores = rng.choice(np.asarray([-0.0, 0.0, 0.25], np.float32), (2, n))
        return boxes, scores, np.asarray([30, 30], np.int32), 30, 0.3
    if name == "nan_rows":  # a NaN in a row that would run out, and one in the tail
        scores = rng.uniform(0, 1, (3, n)).astype(np.float32)
        scores[0, 5] = np.nan
        scores[1, 90] = np.nan
        return boxes, scores, np.full(3, 40, np.int32), 40, 0.5
    if name == "dead_rows":  # all dead, mostly dead, live fewer than the pool
        scores = rng.uniform(0, 1, (3, n)).astype(np.float32)
        scores[0] = -1e30
        scores[1, 3:] = -1e30
        scores[2, 8:] = -1e30  # 8 live: the pool holds them all
        return boxes, scores, np.full(3, 20, np.int32), 20, 0.5
    if name == "budgets":  # budgets of 0, 1 and above max_out
        scores = rng.uniform(0, 1, (4, n)).astype(np.float32)
        return boxes, scores, np.asarray([0, 1, 500, 2 ** 30], np.int32), 24, 0.5
    if name == "per_row_run_out":  # per-row boxes; row 0's head is one cluster
        bx = corners(rng, (2, n), 0, 60, 4, 30)
        bx[0, :40] = np.asarray([10, 10, 30, 30], np.float32) + rng.uniform(
            -0.2, 0.2, (40, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
        scores[0, :40] += 1.0
        return bx, scores, np.asarray([20, 20], np.int32), 20, 0.5
    raise KeyError(name)


EDGE_CASES = ("ties_across_edge", "signed_zeros", "nan_rows", "dead_rows", "budgets",
              "per_row_run_out")


@pytest.mark.parametrize("pool,tile", [(8, 16), (16, 8), (64, 32)])
@pytest.mark.parametrize("name", NMS_CASES)
def test_mirror_equals_plain_full_width(name, pool, tile):
    case = nms_case(name)
    sel, val, _ = mirror_pool(*case, pool, tile)
    _assert_same((sel, val), _plain(*case))


@pytest.mark.parametrize("name", EDGE_CASES)
def test_mirror_equals_plain_on_the_pool_edges(name):
    case = edge_case(name)
    sel, val, continued = mirror_pool(*case, 8, 16)
    _assert_same((sel, val), _plain(*case))
    if name == "nan_rows":  # a NaN row picks nothing and is not continued
        assert not val[0].any() and not val[1].any() and val[2].any()
    if name in ("dead_rows", "budgets"):
        assert continued == {"dead_rows": 0, "budgets": 2}[name]


@pytest.mark.parametrize("name", ["pretopk", "exhaustion", "nan_row", "per_row_boxes"])
def test_mirror_equals_tpudet_pretopk(name):
    """At tpudet's own pool (``max(2 * max_out, 512)``, capped at 1024) and
    a 16-wide tile, against tpudet's interpret-mode pool with its fallback."""
    boxes, scores, ns, max_out, thr = nms_case(name)
    pool = nms_kernel.pool_width(scores.shape[1], nms_kernel.pretopk_pool(max_out))
    sel, val, continued = mirror_pool(boxes, scores, ns, max_out, thr, pool, 16)
    _assert_same((sel, val), _pallas_pretopk(boxes, scores, ns, max_out, thr))
    assert continued == (1 if name == "exhaustion" else 0)


def test_forced_run_out_crosses_tiles():
    """The exhaustion scene (one cluster of 1100 boxes at the top of the
    order, 100 apart below) at pool 64 and tile 16: the row continues
    through ~70 tiles, every one after a pool and before the picks end."""
    boxes, scores, ns, max_out, thr = nms_case("exhaustion")
    sel, val, continued = mirror_pool(boxes, scores, ns, max_out, thr, 64, 16)
    _assert_same((sel, val), _plain(boxes, scores, ns, max_out, thr))
    assert continued == 1 and int(val.sum()) == 60


_score = st.one_of(st.sampled_from([float("nan"), -0.0, 0.0, 0.5, 1.0, -1e30,
                                    float("inf"), float("-inf")]),
                   st.floats(-2, 2, width=32))


@settings(max_examples=60, deadline=None, database=None)
@given(arrays(np.float32, st.tuples(st.integers(1, 3), st.integers(1, 70)),
              elements=_score), st.integers(1, 70))
def test_mirror_select_equals_stable_order_head(scores, p):
    p = min(p, scores.shape[1])
    want = nms_kernel.stable_order(torch.from_numpy(scores))[:, :p].numpy()
    got = np.stack([index_of(block_select(row, p)) for row in scores])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        nms_kernel.select_top(torch.from_numpy(scores), p).numpy(), want)
