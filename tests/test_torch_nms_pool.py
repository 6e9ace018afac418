"""The NMS pool's design on the card, mirrored in plain numpy/torch on the CPU.

``csrc/nms.cu`` selects each row's pool with a cluster of blocks, each over
its slice of the row: 8-bit digit passes whose histograms are summed over the
cluster, stopping once the boundary bin is small (or at the full key), then
every block's list of winners and each winner's position counted as the
listed words above it (ties at the full key by index, block after block). It
scans the pool with the sorted bitmask scan, and continues a row that ran out
tile by tile after the pool's last rank word: tiles sized to the picks still
owed and doubled after a poor tile, each tile's selection, the kill by every
earlier pick and the tile's upper-triangle bitmask (each pair by the mask
kernel's two products, division only near the threshold) and the warp's walk
over it. The mirror below follows those steps; it must equal the plain
full-width greedy NMS and tpudet's ``batched_greedy_nms_pretopk`` in
interpret mode, with small pools and tiles so that continuations cross
several tiles, over 1 to 8 slices.
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
LIST_MAX = 1280  # kListMax
MIN_TILE = 32  # kMinTile
SLICE_MIN = 256  # kSliceMin
MAX_CLUSTER = 8  # kMaxCluster
REFINE = 48  # kRefine
SM_COUNT = 132  # an H100 SXM's SMs


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


def cluster_blocks(rows, n, sm_count=SM_COUNT):
    """``cluster_blocks`` of ``csrc/nms.cu`` before its one-wave check (the
    card's occupancy, which may take fewer blocks): blocks of a row's cluster."""
    nb = min(sm_count // max(rows, 1), -(-n // SLICE_MIN))
    return max(1, min(MAX_CLUSTER, nb))


def slices(n, nb):
    """Each block's slice ``[lo, hi)`` of a row of ``n`` (``slice_of``)."""
    per = -(-n // nb)
    return [(min(n, r * per), min(n, r * per + per)) for r in range(nb)]


def slice_hist(digits, match, lo, hi, cap=None):
    """A block's histogram of its slice's matching digits: staged whole, or
    summed chunk by chunk where the slice streams through ``cap`` floats."""
    step = cap if cap and hi - lo > cap else max(hi - lo, 1)
    hist = np.zeros(256, np.int64)
    for a in range(lo, hi, step):
        b = min(hi, a + step)
        hist += np.bincount(digits[a:b][match[a:b]], minlength=256)
    return hist


def cluster_select(s, count, key_floor=0, cursor=None, nb=1, list_max=LIST_MAX, cap=None):
    """``cluster_select``: the first ``min(count, M)`` rank words, in stable
    descending order, of the M entries with a key above ``key_floor`` and a
    rank word below ``cursor``, by ``nb`` blocks each over its slice. The
    digit passes sum the blocks' histograms and stop once the keys above the
    boundary bin and the bin's own fit ``list_max`` (mode 1: the bin is
    listed with the keys above it) or at the full key (mode 2: the bin's ties
    go by index, each block's after those of the blocks before it, as the
    last pass's histograms count them). Each listed word goes into its
    bucket's positions (its bin at the first pass where its digit is above
    the boundary's, or the boundary bin: from the keys above the bucket, read
    off each pass's counts, on; a bucket of more than REFINE words split by
    the words' next digit), and its position is that base plus the words of
    its bucket above it."""
    keys = sort_keys(s)
    words = rank_words(keys, np.arange(len(keys)))
    cand = keys > np.uint64(key_floor)
    if cursor is not None:
        cand &= words < np.uint64(cursor)
    bounds = slices(len(keys), nb)
    prefix, fixed, need, want, mode = 0, 0, count, 0, 0
    ge, boundary = [], []  # each pass's keys in bins >= d, and its boundary digit
    for shift in (24, 16, 8, 0):
        match = cand & ((keys & np.uint64(fixed)) == np.uint64(prefix))
        digits = ((keys >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
        block_hists = [slice_hist(digits, match, lo, hi, cap) for lo, hi in bounds]
        hist = np.sum(block_hists, axis=0)
        if shift == 24:
            want = need = min(need, int(hist.sum()))
            if want == 0:
                return np.zeros(0, np.uint64)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= need:
                break
            above += int(hist[d])
        prefix |= d << shift
        fixed |= 0xFF << shift
        need -= above
        ge.append(np.concatenate([np.cumsum(hist[::-1])[::-1], [0]]))
        boundary.append(d)
        in_bin = int(hist[d])
        if want - need + in_bin <= list_max:
            mode = 1
            break
        if shift == 0:
            mode = 2
            break
    out = np.zeros(want, np.uint64)
    masked = keys & np.uint64(fixed)
    at_boundary = masked == np.uint64(prefix)
    listed = cand & ((masked > np.uint64(prefix)) | (at_boundary if mode == 1 else False))
    lst = np.concatenate([words[lo:hi][listed[lo:hi]] for lo, hi in bounds])

    def bucket(w):
        key, base = int(w) >> 32, 0
        for k, d in enumerate(boundary):
            dk = (key >> (24 - 8 * k)) & 0xFF
            if dk != d:
                return base + int(ge[k][dk + 1]), int(ge[k][dk] - ge[k][dk + 1]), k
            base += int(ge[k][d + 1])
        return base, in_bin, len(boundary) - 1  # the boundary bin, listed in mode 1 only

    def split_digit(w, level):
        return (int(w) >> (48 - 8 * level)) & 0xFF

    # a bucket of more than REFINE words (a next digit left) is split by its
    # words' next digit, counted over every listed word
    splits = {}
    for w in lst:
        base, size, level = bucket(w)
        if size > REFINE and level < 3:
            splits.setdefault(base, np.zeros(256, np.int64))[split_digit(w, level)] += 1
    splits = {b: np.concatenate([np.cumsum(h[::-1])[::-1], [0]]) for b, h in splits.items()}

    def final_bucket(w):
        base, size, level = bucket(w)
        if base in splits and size > REFINE and level < 3:
            g2, d = splits[base], split_digit(w, level)
            return base + int(g2[d + 1]), int(g2[d] - g2[d + 1])
        return base, size

    placed = np.zeros(len(lst), np.uint64)
    fill = {}
    for w in lst:  # each word into its bucket's positions, in any order
        base, _ = final_bucket(w)
        placed[base + fill.get(base, 0)] = w
        fill[base] = fill.get(base, 0) + 1
    for w in lst:  # the blocks share the words of the lists, in block order
        base, size = final_bucket(w)
        r = base + int((placed[base:base + size] > w).sum())
        if r < want:
            out[r] = w
    if mode == 2:
        before = np.cumsum([0] + [int(h[d]) for h in block_hists])
        for r, (lo, hi) in enumerate(bounds):
            idx = np.flatnonzero((cand & at_boundary)[lo:hi]) + lo  # threads' runs: index order
            ordinal = before[r] + np.arange(len(idx))
            ok = ordinal < need
            out[want - need + ordinal[ok]] = words[idx[ok]]
    return out


def first_tile(owed, tile_max):
    """``first_tile``: the picks owed rounded up to 32, at least 32, at most
    the largest tile."""
    return min(tile_max, max(MIN_TILE, -(-owed // MIN_TILE) * MIN_TILE))


def next_tile(t, c, picked, owed, tile_max):
    """``next_tile``: sized to the picks still owed, doubled after a tile
    that picked fewer than half its candidates."""
    nt = first_tile(owed, tile_max)
    return max(nt, min(tile_max, 2 * t)) if 2 * picked < c else nt


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


def product_bounds(thr):
    """``product_bounds``: thr_lo, thr_hi a relative 2^-20 around thr, or
    infinities outside [2^-20, 2^20]."""
    t = float(np.float32(thr))
    if 2.0 ** -20 <= t <= 2.0 ** 20:
        return np.float32(t * (1 - 2.0 ** -20)), np.float32(t * (1 + 2.0 ** -20))
    return np.float32(-np.inf), np.float32(np.inf)


def pair_above(cands, picks, thr):
    """``[P, Q]``: ``pair_above`` of candidate q (later) against pick p
    (earlier): two float32 products decide a pair of proper boxes far from
    the threshold, the plain IoU every other pair."""
    c = np.asarray(cands, np.float32).reshape(-1, 4)[None, :, :]
    p = np.asarray(picks, np.float32).reshape(-1, 4)[:, None, :]
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    proper = lambda b, a: (b[..., 2] - b[..., 0] > 0) & (a >= 2.0 ** -50) & (a <= 2.0 ** 50)  # noqa: E731
    ca, pa = area(c), area(p)
    with np.errstate(invalid="ignore", over="ignore"):
        ih = np.maximum(np.minimum(c[..., 2], p[..., 2]) - np.maximum(c[..., 0], p[..., 0]),
                        np.float32(0))
        iw = np.maximum(np.minimum(c[..., 3], p[..., 3]) - np.maximum(c[..., 1], p[..., 1]),
                        np.float32(0))
        inter = ih * iw
        uni = ca + pa - inter
        lo, hi = product_bounds(thr)
        above, below = inter > hi * uni, inter < lo * uni
    decided = proper(c, ca) & proper(p, pa) & (above | below)
    return np.where(decided, above, _iou_above(cands, picks, thr))


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


def mirror_pool(boxes, scores, num_select, max_out, thr, pool, tile, nb=None,
                list_max=LIST_MAX, tiles=None):
    """The card's pool call, row by row: select ``pool`` positions over the
    row's cluster (``nb`` slices, else ``cluster_blocks``), scan them, and
    continue a row that ran out in tiles sized to the picks owed, at most
    ``tile``, appending each tile's (size, candidates, picks) to ``tiles``.
    Returns ``(sel, valid, continued rows)``."""
    b, n = scores.shape
    bx = boxes if boxes.ndim == 3 else np.broadcast_to(boxes, (b, n, 4))
    sel = np.zeros((b, max_out), np.int32)
    valid = np.zeros((b, max_out), bool)
    p = min(pool, n)
    continued = 0
    floor = int(sort_keys(np.asarray([NEG_HALF]))[0])
    for r in range(b):
        s = scores[r]
        n_sel = min(int(num_select[r]), max_out)
        words = cluster_select(s, p, nb=nb or cluster_blocks(b, n), list_max=list_max)
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
            t = first_tile(n_sel - len(picked), tile)
            while len(picked) < n_sel:
                tw = cluster_select(s, t, floor, cursor, nb=nb or cluster_blocks(1, n),
                                    list_max=list_max)
                c = len(tw)
                if c == 0:
                    break
                idx = index_of(tw)
                cursor = tw[-1]
                alive = ~pair_above(bx[r][idx], bx[r][picked], thr).any(0)
                hit = pair_above(bx[r][idx], bx[r][idx], thr)
                new = walk(alive, hit, n_sel - len(picked))
                picked += [int(idx[q]) for q in new]
                if tiles is not None:
                    tiles.append((t, c, len(new)))
                if c < t:
                    break
                t = next_tile(t, c, len(new), n_sel - len(picked), tile)
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
              elements=_score), st.integers(1, 70), st.sampled_from([1, 2, 8]),
       st.sampled_from([0, 3, LIST_MAX]))
def test_mirror_select_equals_stable_order_head(scores, p, nb, slack):
    """Over 1, 2 or 8 slices; a list only ``slack`` longer than ``p`` (0 or 3)
    takes the tie mode and the later passes at these widths, LIST_MAX the
    kernel's own."""
    p = min(p, scores.shape[1])
    want = nms_kernel.stable_order(torch.from_numpy(scores))[:, :p].numpy()
    got = np.stack([index_of(cluster_select(row, p, nb=nb, list_max=min(p + slack, LIST_MAX)))
                    for row in scores])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        nms_kernel.select_top(torch.from_numpy(scores), p).numpy(), want)


def _select_rows(name):
    """(scores [B, N], p): rows whose boundary needs each of the passes."""
    rng = np.random.default_rng(41)
    if name == "uniform":  # a few thousand distinct keys: stops after 1-2 passes
        return rng.uniform(0, 1, (3, 3000)).astype(np.float32), 700
    if name == "tenths":  # ~300 ties at the boundary: the tie mode at the full key
        return np.round(rng.uniform(0, 1, (3, 3000)), 1).astype(np.float32), 768
    if name == "dead_tail":  # fewer live than the pool: the dead key's ties by index
        scores = rng.uniform(0, 1, (2, 2500)).astype(np.float32)
        scores[:, 300:] = -1e30
        return scores, 1000
    if name == "close_keys":  # keys an ulp or a few apart: three passes
        base = np.float32(0.75).view(np.uint32) + rng.integers(0, 4000, (2, 4000))
        return base.astype(np.uint32).view(np.float32), 1024
    if name == "ulp_ties":  # 64 keys an ulp apart, ~60 ties each: four passes
        base = np.float32(0.75).view(np.uint32) + rng.integers(0, 64, (2, 4000))
        return base.astype(np.uint32).view(np.float32), 1024
    raise KeyError(name)


@pytest.mark.parametrize("nb", [1, 2, 8])
@pytest.mark.parametrize("name", ["uniform", "tenths", "dead_tail", "close_keys",
                                  "ulp_ties"])
def test_mirror_select_over_slices(name, nb):
    """The cluster select over 1, 2 and 8 slices of each row, staged whole
    and streamed through a 64-float buffer, == the stable order's head."""
    scores, p = _select_rows(name)
    want = nms_kernel.stable_order(torch.from_numpy(scores))[:, :p].numpy()
    for cap in (None, 64):
        got = np.stack([index_of(cluster_select(row, p, nb=nb, cap=cap)) for row in scores])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb", [1, 2, 8])
@pytest.mark.parametrize("name", NMS_CASES)
def test_mirror_pool_over_slices_equals_plain(name, nb):
    """The pool and its continuation over 1, 2 and 8 slices, with a list of
    67 words so that small rows take the later passes and the tie mode."""
    case = nms_case(name)
    sel, val, _ = mirror_pool(*case, 8, 64, nb=nb, list_max=67)
    _assert_same((sel, val), _plain(*case))


def test_pair_test_equals_the_plain_iou():
    """The kernels' two-product pair test == the plain IoU > thr, on boxes
    drawn around the threshold (near-copies, shared edges, zero areas)."""
    rng = np.random.default_rng(43)
    a = corners(rng, (400,), 0, 40, 0, 30)
    a[:40, 2] = a[:40, 0]  # zero height
    b = np.concatenate([a[:200] + rng.normal(0, 0.5, (200, 4)).astype(np.float32),
                        corners(rng, (200,), 0, 40, 0, 30)])
    for thr in (0.3, 0.45, 0.5, 0.7, 0.0, 2.0 ** -21):
        np.testing.assert_array_equal(pair_above(a, b, thr), _iou_above(a, b, thr))


def test_tile_schedule_grows_from_the_picks_owed():
    """The exhaustion scene at pool 64 owes 59 picks past its pool: the first
    tile is 64 (the picks owed rounded up), and since each tile of the
    cluster of near-copies yields one pick, the tiles double up to the
    largest tile; the picks == plain, whatever the schedule."""
    boxes, scores, ns, max_out, thr = nms_case("exhaustion")
    tiles = []
    sel, val, continued = mirror_pool(boxes, scores, ns, max_out, thr, 64, 1024, tiles=tiles)
    _assert_same((sel, val), _plain(boxes, scores, ns, max_out, thr))
    sizes = [t for t, _, _ in tiles]
    assert continued == 1 and sizes[0] == first_tile(59, 1024) == 64
    assert sizes[:5] == [64, 128, 256, 512, 1024] and max(sizes) == 1024
    assert all(t <= 1024 for t in sizes) and sum(p for _, _, p in tiles) == 59
