// Batched greedy non-max suppression for Hopper (sm_90a), with its
// pre-top-k pool, all on the card: no host round trip.
//
// Replaces the Pallas TPU kernels of tpudet/ops/pallas/nms_kernel.py:
//   _kernel_xb (rows advance in lockstep, reached through
//   batched_greedy_nms_pallas) and _kernel (one image per grid program),
//   and the rest of batched_greedy_nms_pretopk around them: jax.lax.top_k
//   of the pool, the run-out check and the full-width fallback under
//   jax.lax.cond. Both kernels compute the same function.
//
// What it computes, per row b:
//   n_sel = min(num_select[b], max_out)
//   repeat: pick the highest live score (ties -> lowest index); stop at
//   k == n_sel or when the best score is <= -1e30/2 or NaN (a row holding a
//   NaN score selects nothing: max() propagates NaN in tpudet and in the plain
//   version); kill every box whose IoU with the pick is strictly
//   > iou_threshold, and always kill the pick itself (a zero-area pair gives a
//   NaN IoU, and NaN is not >); sel[b,k] = j, valid[b,k] = 1. Unused slots
//   hold 0 / 0.
//
// Greedy NMS with ties to the lowest index is the same as walking the row in
// stable descending score order and taking each candidate that no earlier
// pick has killed. So the first P positions of that order (the pool) give
// the exact first picks of the full row, and a row needs more only when it
// used up its pool short of its quota while live candidates lie outside it.
// Four kernels, launched in stream order by one C entry a pool call
// (tpudet_nms_pool; the continuation only where the pool is narrower than
// the row):
//
// 1. nms_select_kernel (replaces jax.lax.top_k of the pool and the stable
//    sort of the whole row that stood in for it): the first P <= 1024
//    positions of each row's stable descending order, and the row's live
//    count (scores > -1e30/2). Keys are made canonical (every NaN the same
//    positive NaN, sorted first; -0.0 as +0.0) and mapped to unsigned words
//    whose order is the scores'; a key and ~index make one 64-bit rank word,
//    unique, larger = earlier. Bound: bytes, each row's scores read once
//    (32 x 8828 x 4 B at SSD300's mining pool: 0.34 us of HBM). Design: each
//    row is a thread-block cluster of up to 8 blocks (cluster_blocks: enough
//    to fill the SMs with the rows, a single row on 8), and each block reads
//    its slice of the row once, by one TMA bulk copy into shared memory
//    completing on an mbarrier (a slice too wide for shared memory streams
//    through it in chunks, pass by pass). cluster_select then works from
//    shared memory: 8-bit digit passes whose histograms are private to each
//    warp (so the dead scores' one key contends within a warp at most; a
//    lane's plain shared atomic measured faster than aggregating the warp's
//    equal digits first), summed over the block and then over the cluster
//    through distributed shared memory, one cluster barrier a pass; the
//    first pass also counts the live scores. It stops as soon as the keys
//    above the P-th key's bin and the bin's own fit the list
//    (kListMax; usually after two passes), or at the full key. Each block
//    then lists its keys above that bin (and the bin's own, or, at the full
//    key, the tied keys by index in order across the cluster); every block
//    gathers the lists and places each word in its bucket (its bin at the
//    first pass where it is above the boundary, which the passes' counts
//    place exactly; a bucket of more than kRefine words split by its next
//    digit), and each winner's position is its bucket's base plus the words
//    of its bucket above it, counted by threads of the whole cluster.
//    Positions are written straight into `order`: no sort network. The
//    clusters are sized by cudaOccupancyMaxActiveClusters so that all rows'
//    clusters run at once (1024-thread blocks take a whole SM).
// 2. nms_mask_kernel: the whole card computes mask[b, p, w], a 64-bit word
//    whose bit t is IoU(c_p, c_{64w+t}) > thr for 64w+t > p (c_p = the
//    candidate at sorted position p). One 64-thread block per row and
//    upper-triangle 64x64 tile (32 x 78 blocks at the mining pool), the
//    tile's column boxes in shared memory as float4. One triangle suffices:
//    a pick can only kill later positions, and each bit is the plain
//    version's IoU of the later candidate against the earlier pick (it is
//    symmetric bit for bit in any case). Between two proper boxes (see
//    box_is_proper) two products decide a pair far from the threshold; the
//    64 columns are one branch-free unrolled pass that yields the hits and
//    the pairs it could not decide, and only those go through iou_above
//    and its division. A position's words are padded to an even count, so
//    every row of the mask is 16-byte aligned.
// 3. nms_scan_kernel: one block per row copies the row's mask into shared
//    memory with cp.async while it finds the live prefix of the order, then
//    one warp walks it as 32-bit words, one a lane (the 64-bit word w is
//    the 32-bit words 2w and 2w+1): __ffs finds the next live candidate,
//    and a pick clears its mask row out of the live bits of the current
//    word (one shared-memory load and one three-input logic op on the
//    chain) and ORs it into the removed words of the lanes ahead. So the
//    cost follows the picks, not the candidates. A NaN score sorts first
//    and a dead score (<= -1e30/2) sorts last, so the scan stops at the
//    first position whose score is not > -1e30/2. Given the live count it
//    also writes the row's state: its picks, and whether it ran out (fewer
//    picks than min(n_sel, live) while live candidates lie outside the
//    pool: tpudet's pool_exhausted & n_active > pool, per row).
// 4. nms_continue_kernel (replaces the run-out check's host sync and the
//    full-width rerun): a few clusters of up to 8 blocks each take the rows
//    that ran out (a row that did not costs one read of its state); a row
//    holding a NaN selects nothing (as tpudet's fallback), and a row that
//    ran out goes on from the pool's picks, tile by tile in stable order
//    after the last position taken. Bound: bytes or operations of the IoU
//    tests past the pool (the candidates up to the last pick). Design: the
//    cluster stages the row once, as the select does, and each tile is
//    cluster_select over the staged keys, after the last rank word taken.
//    A tile is sized to the picks still owed (first_tile), up to `tile`,
//    and doubles after a tile that picked fewer than half its candidates
//    (next_tile); the picks do not depend on the tiles. The kill of the
//    tile by every earlier pick and the tile's upper-triangle IoU bitmask
//    are spread over the cluster's threads, each pair decided by the mask
//    kernel's two products (division only near the threshold), the bitmask
//    written into the first block's shared memory, where one warp walks it
//    as the scan does, up to the quota or the last live candidate. It
//    counts the rows it continued in a device-side int32.
//
// Nothing here reads a device value on the host, so a pool call can be
// captured in a CUDA graph; tpudet_nms_init sets the kernels' shared-memory
// limits once, when the library is loaded.
//
// Bit-exactness with the plain PyTorch version: build with -fmad=false (no
// contraction of `area + barea - inter` into an FMA), never --use_fast_math,
// IEEE division. The IoU's min/max are fminf/fmaxf, which drop a NaN where
// torch.minimum/maximum propagate it; the decision is the same all the same,
// since a NaN corner makes its box's area, the union and so the IoU NaN, and
// NaN is not > any threshold. The sign of a zero they return cannot change
// the decision either.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegHalf = -5e29f;  // -1e30 / 2: at or below this, no candidate

constexpr int kSortedMaxWidth = 1024;  // 32 words of 32 bits: one a lane of the scan warp
constexpr int kMaxWords = kSortedMaxWidth / 64;
constexpr int kTile = 64;
constexpr int kScanThreads = 512;
constexpr size_t kScanMaxSmem = sizeof(unsigned long long) * kSortedMaxWidth * kMaxWords +
                                2 * sizeof(int) * kSortedMaxWidth;

constexpr int kThreads = 1024;  // a block of the select and the continuation
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kHistStride = kBins + 1;  // a warp's histogram, padded: no bank conflict when summed
constexpr int kBhStride = kBins + 4;    // a block's histogram, then its live count
constexpr int kPasses = 4;              // 8-bit digits of a 32-bit key
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kListMax = 1280;          // the winners' list: the select stops once it fits
constexpr int kRefine = 48;             // a bucket larger than this is split by its next digit
constexpr int kSplitMax = kListMax / kRefine;  // buckets split at most
constexpr int kPickChunk = 256;         // earlier picks staged at a time for the kill test
constexpr int kContinueClusters = 4;    // clusters of the continuation
constexpr int kMinTile = 32;
constexpr int kSliceMin = 256;          // a row's entries a block of the cluster takes at least
constexpr unsigned long long kNoCursor = ~0ull;
static_assert(kThreads == 4 * kBins, "a block sums its histograms 4 threads a bin");
static_assert(kWarps == 32, "a block scan takes one warp's values");

// vars: 0 the boundary digit, 1 keys above it in the pass, 2 keys wanted,
// 3 keys in it, 4 this block's list length, 5 ties before this block,
// 7 buckets split, 8.. each block's list length, then the continuation's
// picks so far and picks of the last tile, then each pass's boundary digit
constexpr int kVarK = 8 + kMaxCluster;
constexpr int kVarPicked = kVarK + 1;
constexpr int kVarDigits = kVarPicked + 1;  // each pass's boundary digit
constexpr int kVars = kVarDigits + kPasses;

int g_sm_count = 132;        // set by tpudet_nms_init
int g_smem_optin = 232448;   // shared memory a block may opt into, set by tpudet_nms_init

// 64-bit words a sorted position takes in the mask: ceil(p_count / 64), even
__host__ __device__ __forceinline__ int mask_stride(int p_count) {
  const int words = (p_count + kTile - 1) / kTile;
  return words + (words & 1);
}

// The plain version's IoU of candidate (y1, x1, y2, x2, area) against the
// pick (by1, bx1, by2, bx2, barea), in its order of operations. Returns
// whether it is > thr; with thr >= 0 a pair that does not intersect is not.
__device__ __forceinline__ bool iou_above(float y1, float x1, float y2, float x2,
                                          float area, float by1, float bx1,
                                          float by2, float bx2, float barea,
                                          float thr) {
  const float ih = fmaxf(fminf(y2, by2) - fmaxf(y1, by1), 0.0f);
  const float iw = fmaxf(fminf(x2, bx2) - fmaxf(x1, bx1), 0.0f);
  const float inter = ih * iw;
  if (inter == 0.0f && thr >= 0.0f) return false;  // 0/union is 0, -0 or NaN
  return inter / (area + barea - inter) > thr;
}

__device__ __forceinline__ float area_of(float4 b) { return (b.z - b.x) * (b.w - b.y); }

// A box for which the mask kernel's products decide: y2 > y1 and an area in
// [2^-50, 2^50] (so x2 > x1 and nothing is NaN or infinite). Between two proper
// boxes the rounded intersection is at most either area, so the union is in
// [2^-51, 2^51]; with thr in [2^-20, 2^20] the products thr_hi * union and
// thr_lo * union are normal and within 2^-24 of exact, and thr_lo, thr_hi
// bracket thr by a relative 2^-20. So inter > thr_hi * union means the IEEE
// quotient is above thr by more than an ulp (the IoU is > thr), and
// inter < thr_lo * union that it is below thr (it is not).
__device__ __forceinline__ bool box_is_proper(float4 b, float area) {
  return b.z - b.x > 0.0f && area >= 0x1p-50f && area <= 0x1p50f;
}

// iou_above of the later candidate a against the earlier pick b, decided by
// the mask kernel's two products where both boxes are proper and the pair is
// far from the threshold (the same decision, see box_is_proper)
__device__ __forceinline__ bool pair_above(float4 a, float aa, float4 b, float ba,
                                           float thr, float thr_lo, float thr_hi) {
  if (box_is_proper(a, aa) && box_is_proper(b, ba)) {
    const float ih = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
    const float iw = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
    const float inter = ih * iw;
    const float uni = aa + ba - inter;
    if (inter > thr_hi * uni) return true;
    if (inter < thr_lo * uni) return false;
  }
  return iou_above(a.x, a.y, a.z, a.w, aa, b.x, b.y, b.z, b.w, ba, thr);
}

// thr_lo, thr_hi of the products test: a relative 2^-20 around thr, or
// infinities (decide every pair by division) for a threshold outside [2^-20, 2^20]
void product_bounds(float thr, float* lo, float* hi) {
  *lo = -INFINITY;
  *hi = INFINITY;
  if (thr >= 0x1p-20f && thr <= 0x1p20f) {
    *lo = static_cast<float>(thr * (1.0 - 0x1p-20));
    *hi = static_cast<float>(thr * (1.0 + 0x1p-20));
  }
}

// ------------------------------------------------------------- selection
// The sort key of a score: made canonical (every NaN the positive quiet NaN,
// -0.0 as +0.0), then its bits mapped so that unsigned order is the scores'
// order, NaN above +inf. No score maps to 0.
__device__ __forceinline__ unsigned sort_key(float s) {
  unsigned u = __float_as_uint(s);
  if (s != s) {
    u = 0x7fc00000u;
  } else if ((u << 1) == 0u) {
    u = 0u;
  }
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, index) as one word, unique in a row: a larger word comes earlier in
// the stable descending order (a higher key, or the same key at a lower index)
__device__ __forceinline__ unsigned long long rank_word(unsigned key, int i) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ int index_of(unsigned long long w) {
  return static_cast<int>(~static_cast<unsigned>(w));
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Clusters of nb blocks of a kernel that can run at once (by nb), from
// cudaOccupancyMaxActiveClusters at the largest shared memory, in tpudet_nms_init
int g_select_clusters[kMaxCluster + 1];
int g_continue_clusters[kMaxCluster + 1];

// Blocks of each of `clusters` clusters over rows of width n: enough to
// cover the SMs, each block taking at least kSliceMin entries, at most 8,
// and few enough that every cluster runs at once (one wave)
int cluster_blocks(int clusters, int n, const int* active) {
  int nb = g_sm_count / (clusters > 0 ? clusters : 1);
  const int by_width = (n + kSliceMin - 1) / kSliceMin;
  nb = nb < by_width ? nb : by_width;
  nb = nb > kMaxCluster ? kMaxCluster : nb;
  while (nb > 1 && active[nb] < clusters) --nb;
  return nb < 1 ? 1 : nb;
}

// The first tile of a continued row owing `owed` picks, and the next after a
// tile of t positions that held c candidates and gave `picked` picks
__host__ __device__ __forceinline__ int first_tile(int owed, int tile_max) {
  int t = (owed + kMinTile - 1) / kMinTile * kMinTile;
  t = t > kMinTile ? t : kMinTile;
  return t < tile_max ? t : tile_max;
}

__host__ __device__ __forceinline__ int next_tile(int t, int c, int picked, int owed,
                                                  int tile_max) {
  const int nt = first_tile(owed, tile_max);
  const int grown = 2 * t < tile_max ? 2 * t : tile_max;
  return 2 * picked < c && grown > nt ? grown : nt;
}

// ------------------------------------------------ shared-memory layout
__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets into a block's dynamic shared memory: the select's scratch
// (warp histograms, this block's list, every block's list, every word
// placed by bucket and the buckets' fill counts, each pass's counts, partial
// sums of the cluster's histogram, the large buckets' splits), which the
// continuation's tile bitmask overlays, then the block's histograms, the
// continuation's tile arrays (`tile` positions; none for the select), the
// variables and the staged slice (`cap` floats, 4 more for alignment)
struct Layout {
  size_t wh, loc, all, placed, fill, ge, part, split, ge2, mask, bh, sorted, t_box, t_area,
      t_idx, t_pick,
      alive, p_box, p_area, vars, warp_sum, row_list, bar, stage, end;
};

__host__ __device__ __forceinline__ Layout layout(int tile, int cap) {
  Layout l{};
  const size_t list_bytes = sizeof(unsigned long long) * kListMax;
  size_t o = 0;
  l.wh = o;     o = align16(o + sizeof(unsigned) * kWarps * kHistStride);
  l.loc = o;    o += list_bytes;
  l.all = o;    o += list_bytes;
  l.placed = o; o += list_bytes;
  l.fill = o;   o = align16(o + sizeof(int) * kListMax);
  l.ge = o;     o = align16(o + sizeof(unsigned) * kPasses * (kBins + 1));
  l.part = o;   o = align16(o + sizeof(unsigned) * 4 * kBins);
  l.split = o;  o = align16(o + sizeof(int) * kListMax);
  l.ge2 = o;    o = align16(o + sizeof(unsigned) * kSplitMax * (kBins + 1));
  const size_t scratch = o;
  const size_t words = (static_cast<size_t>(tile) + 31) / 32;
  const size_t mask = sizeof(unsigned) * static_cast<size_t>(tile) * words;
  l.mask = 0;
  o = align16(scratch > mask ? scratch : mask);
  const size_t chunk = tile > 0 ? kPickChunk : 0;
  l.bh = o;       o = align16(o + sizeof(unsigned) * 2 * kBhStride);
  l.sorted = o;   o = align16(o + sizeof(unsigned long long) * tile);
  l.t_box = o;    o = align16(o + sizeof(float4) * tile);
  l.t_area = o;   o = align16(o + sizeof(float) * tile);
  l.t_idx = o;    o = align16(o + sizeof(int) * tile);
  l.t_pick = o;   o = align16(o + sizeof(int) * tile);
  l.alive = o;    o = align16(o + sizeof(unsigned) * words);
  l.p_box = o;    o = align16(o + sizeof(float4) * chunk);
  l.p_area = o;   o = align16(o + sizeof(float) * chunk);
  l.vars = o;     o = align16(o + sizeof(int) * kVars);
  l.warp_sum = o; o = align16(o + sizeof(int) * kWarps);
  l.row_list = o; o = align16(o + (tile > 0 ? sizeof(int) * kThreads : 0));
  l.bar = o;      o = align16(o + sizeof(unsigned long long));
  l.stage = o;    o = align16(o + sizeof(float) * (static_cast<size_t>(cap) + 4));
  l.end = o;
  return l;
}

// Floats of a row a block stages at once at most, beside the rest of `tile`'s layout
int stage_cap_max(int tile) {
  const size_t fixed = layout(tile, 0).end;
  if (static_cast<size_t>(g_smem_optin) <= fixed + 16) return 0;
  return static_cast<int>((g_smem_optin - fixed) / sizeof(float)) & ~3;
}

// ------------------------------------------------- the staged row slice
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this block's shared memory by the TMA, completing on bar
__device__ __forceinline__ void bulk_load(unsigned long long* bar, float* dst,
                                          const float* src, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// A block's slice of a row: src[j] is the row's entry lo + j, j < len. It is
// staged whole (`resident`) when len <= cap, else streamed cap at a time.
struct Slice {
  const float* src;
  int lo, len, cap;
  float* buf;  // cap + 4 floats of shared memory, 16-byte aligned
  unsigned long long* bar;
  unsigned phase;  // the parity the next wait on bar waits for
  const float* resident;
};

// Block-wide (all threads calling): src[off, off + m) into shared memory.
// Returns st with st[j] = src[off + j]; the 16-byte-aligned body goes by one
// bulk copy, the at most 3 + 3 entries around it by plain loads.
__device__ const float* stage(Slice& sl, int off, int m) {
  const float* g = sl.src + off;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3u);
  const int head = min(m, (4 - mis) & 3);
  float* st = sl.buf + ((4 - head) & 3);  // st + head is 16-byte aligned
  const int body = (m - head) & ~3;
  const int tail = m - head - body;
  const int t = threadIdx.x;
  if (t == 0 && body > 0) {
    bulk_load(sl.bar, st + head, g + head, static_cast<unsigned>(body) * 4u);
  }
  if (t < head) {
    st[t] = g[t];
  } else if (t >= 32 && t < 32 + tail) {
    st[head + body + t - 32] = g[head + body + t - 32];
  }
  if (body > 0) {
    mbar_wait(sl.bar, sl.phase);
    sl.phase ^= 1u;
  }
  __syncthreads();
  return st;
}

// Block `me` of `nb`'s slice of the row `row` (n entries), staged when it fits
__device__ Slice slice_of(const float* row, int n, int me, int nb, float* buf, int cap,
                          unsigned long long* bar, unsigned phase) {
  Slice sl;
  const int per = (n + nb - 1) / nb;
  sl.lo = min(n, me * per);
  sl.len = min(per, n - sl.lo);
  sl.src = row + sl.lo;
  sl.cap = cap;
  sl.buf = buf;
  sl.bar = bar;
  sl.phase = phase;
  sl.resident = nullptr;
  if (sl.len <= cap) sl.resident = stage(sl, 0, sl.len);
  return sl;
}

// f(st, base, m) over the slice: st[j] is the row's entry base + j, j < m;
// the staged slice once, or each chunk streamed through the buffer
template <class F>
__device__ __forceinline__ void over_slice(Slice& sl, F&& f) {
  if (sl.resident != nullptr || sl.len == 0) {
    f(sl.resident, sl.lo, sl.len);
    return;
  }
  for (int off = 0; off < sl.len; off += sl.cap) {
    const int m = min(sl.cap, sl.len - off);
    f(stage(sl, off, m), sl.lo + off, m);
    __syncthreads();  // the buffer is rewritten by the next chunk
  }
}

// Entries of a thread's run: each thread takes a run of consecutive entries
// (odd, so a warp's loads hit 32 banks), in index order across the block
__device__ __forceinline__ int run_length(int m) {
  return ((m + kThreads - 1) / kThreads) | 1;
}

// Block-wide exclusive scan of v (all threads calling); *total is the sum
__device__ int block_scan(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sum[warp - 1];
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is rewritten by the next scan
  return before + x - v;
}

struct SelectSmem {
  unsigned* wh;                // [kWarps][kHistStride] the warps' histograms
  unsigned long long* loc;     // [kListMax] this block's list
  unsigned long long* all;     // [kListMax] every block's list, in block order
  unsigned long long* placed;  // [kListMax] the list, each word in its bucket's positions
  int* fill;                   // [kListMax] words placed in the bucket starting there
  unsigned* ge;                // [kPasses][kBins + 1] the cluster's keys in bins >= d, a pass
  unsigned* part;              // [4][kBins] partial sums of the blocks' histograms
  int* split;                  // [kListMax] a large bucket's row of ge2, by its first position
  unsigned* ge2;               // [kSplitMax][kBins + 1] a large bucket's words by next digit >= d
  unsigned* bh;                // [2][kBhStride] the block's histograms of the last two passes
  int* vars;                   // [kVars]
  int* warp_sum;               // [kWarps]
};

__device__ __forceinline__ SelectSmem select_smem(unsigned char* smem, const Layout& l) {
  return SelectSmem{reinterpret_cast<unsigned*>(smem + l.wh),
                    reinterpret_cast<unsigned long long*>(smem + l.loc),
                    reinterpret_cast<unsigned long long*>(smem + l.all),
                    reinterpret_cast<unsigned long long*>(smem + l.placed),
                    reinterpret_cast<int*>(smem + l.fill),
                    reinterpret_cast<unsigned*>(smem + l.ge),
                    reinterpret_cast<unsigned*>(smem + l.part),
                    reinterpret_cast<int*>(smem + l.split),
                    reinterpret_cast<unsigned*>(smem + l.ge2),
                    reinterpret_cast<unsigned*>(smem + l.bh),
                    reinterpret_cast<int*>(smem + l.vars),
                    reinterpret_cast<int*>(smem + l.warp_sum)};
}

// Cluster-wide (every thread of the cluster calling, each block with its
// slice in `sl`): of the row's entries i with sort_key(s[i]) > key_floor and
// a rank word below `cursor` (the candidates), the first c = min(count, their
// number) in stable descending order. The winner at position r goes to
// order_row[r] (its index) when order_row is not null, else to sorted[r]
// (its rank word) in every block of the cluster. With live_out, the first
// block writes the row's live count (scores > -1e30/2) there. Returns c in
// every thread; ends with a cluster barrier.
//
// The digit passes keep each pass's cluster histogram as counts of keys in
// bins >= d (ge). A listed word's bucket is its bin at the first pass where
// its digit is above the boundary digit, or the boundary bin: the bucket's
// words take exactly the positions from base (the keys above it, read off
// ge) to base + its count, so each word is placed in its bucket's positions
// and its position is base plus the words of its bucket above it.
__device__ int cluster_select(cg::cluster_group& cl, Slice& sl, unsigned key_floor,
                              unsigned long long cursor, int count, const SelectSmem& sm,
                              int* order_row, unsigned long long* sorted, int* live_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const unsigned live_key = sort_key(kNegHalf);
  unsigned* wh = sm.wh + warp * kHistStride;
  for (int e = tid; e < kWarps * kHistStride; e += kThreads) sm.wh[e] = 0u;
  __syncthreads();

  // radix select of the count-th key: prefix holds the digits fixed so far
  unsigned prefix = 0u, fixed = 0u;
  int want = 0, need = count, in_bin = 0, mode = 0, digit = 0, last = 0;
  const int* digits = sm.vars + kVarDigits;  // in shared memory: indexed at run time
  const unsigned* last_bh = sm.bh;
  for (int shift = 24, pass = 0;; shift -= 8, ++pass) {
    unsigned* bh = sm.bh + (pass & 1) * kBhStride;
    const bool count_live = live_out != nullptr && pass == 0;
    int live = 0;
    over_slice(sl, [&](const float* st, int base, int m) {
      const int run = run_length(m);
      for (int u = 0; u < run; ++u) {  // the u-th entry of each thread's run
        const int j = tid * run + u;
        unsigned key = 0u;
        bool in = false;
        if (j < m) {
          key = sort_key(st[j]);
          if (count_live) live += key > live_key ? 1 : 0;
          in = key > key_floor && (key & fixed) == prefix && rank_word(key, base + j) < cursor;
        }
        if (in) atomicAdd(&wh[(key >> shift) & 0xffu], 1u);  // the warp's own histogram
      }
    });
    if (count_live) {
      live = __reduce_add_sync(0xffffffffu, live);
      if (lane == 0) sm.warp_sum[warp] = live;
    }
    __syncthreads();
    {  // the block's histogram: 4 threads a bin, each over 8 warps, zeroing them
      const int bin = tid >> 2, part = tid & 3;
      unsigned v = 0u;
#pragma unroll
      for (int w = 0; w < kWarps / 4; ++w) {
        unsigned* h = sm.wh + (part * (kWarps / 4) + w) * kHistStride + bin;
        v += *h;
        *h = 0u;
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (part == 0) bh[bin] = v;
      if (count_live && warp == kWarps - 1) {
        const int x = __reduce_add_sync(0xffffffffu, sm.warp_sum[lane]);
        if (lane == 0) bh[kBins] = static_cast<unsigned>(x);
      }
    }
    cl.sync();
    {  // the cluster's histogram: every block's bins read at once, 4 partial sums a bin
      const int bin = tid & (kBins - 1), q = tid / kBins;
      unsigned v = 0u;
      for (int r = q; r < nb; r += kThreads / kBins) v += cl.map_shared_rank(bh, r)[bin];
      sm.part[q * kBins + bin] = v;
      if (count_live && warp == 0) {
        const unsigned x = lane < nb ? cl.map_shared_rank(bh, lane)[kBins] : 0u;
        const unsigned lv = __reduce_add_sync(0xffffffffu, x);
        if (lane == 0 && me == 0) *live_out = static_cast<int>(lv);
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: a scan over the lanes
      // counts the keys above each
      unsigned c[8], local = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bin = kBins - 1 - 8 * lane - j;
        c[j] = sm.part[bin] + sm.part[kBins + bin] + sm.part[2 * kBins + bin] +
               sm.part[3 * kBins + bin];
        local += c[j];
      }
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      int w = need;
      if (pass == 0) w = min(need, static_cast<int>(__shfl_sync(0xffffffffu, incl, 31)));
      if (lane == 0) {
        sm.vars[2] = w;
        sm.ge[pass * (kBins + 1) + kBins] = 0u;
      }
      unsigned run = incl - local;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bin = kBins - 1 - 8 * lane - j;
        if (w > 0 && run < static_cast<unsigned>(w) && run + c[j] >= static_cast<unsigned>(w)) {
          sm.vars[0] = bin;
          sm.vars[kVarDigits + pass] = bin;
          sm.vars[1] = static_cast<int>(run);
          sm.vars[3] = static_cast<int>(c[j]);
        }
        run += c[j];
        sm.ge[pass * (kBins + 1) + bin] = run;
      }
    }
    __syncthreads();
    if (pass == 0) want = need = sm.vars[2];
    if (want == 0) break;
    digit = sm.vars[0];
    last = pass;
    prefix |= static_cast<unsigned>(digit) << shift;
    fixed |= 0xffu << shift;
    need -= sm.vars[1];
    in_bin = sm.vars[3];
    last_bh = bh;
    // vars are next written by warp 0 after the next pass's cluster barrier
    if (want - need + in_bin <= kListMax) {
      mode = 1;  // list the bin's keys with those above it
      break;
    }
    if (shift == 0) {
      mode = 2;  // the full key: its ties go by index
      break;
    }
  }

  if (want > 0) {
    const int above = want - need;  // winners above the boundary
    auto emit = [&](int r, unsigned long long w) {
      if (order_row != nullptr) {
        order_row[r] = index_of(w);
      } else {
        for (int b = 0; b < nb; ++b) cl.map_shared_rank(sorted, b)[r] = w;
      }
    };
    if (tid == 0) {
      sm.vars[4] = 0;
      int ties = 0;  // the last pass counted each block's ties in its digit's bin
      if (mode == 2) {
        for (int r = 0; r < me; ++r) {
          ties += static_cast<int>(cl.map_shared_rank(last_bh, r)[digit]);
        }
      }
      sm.vars[5] = ties;
    }
    __syncthreads();
    int tie_base = sm.vars[5];
    over_slice(sl, [&](const float* st, int base, int m) {
      const int run = run_length(m);
      const int j0 = tid * run;
      int mine = 0, total = 0;
      if (mode == 2) {  // this thread's ties before its run, in index order
        for (int j = j0; j < min(j0 + run, m); ++j) {
          const unsigned key = sort_key(st[j]);
          mine += key > key_floor && (key & fixed) == prefix &&
                          rank_word(key, base + j) < cursor ? 1 : 0;
        }
        mine = block_scan(mine, sm.warp_sum, &total);
      }
      for (int u = 0; u < run; ++u) {
        const int j = j0 + u;
        bool push = false;
        unsigned long long w = 0ull;
        if (j < m) {
          const unsigned key = sort_key(st[j]);
          w = rank_word(key, base + j);
          if (key > key_floor && w < cursor) {
            const unsigned mk = key & fixed;
            if (mk > prefix || (mode == 1 && mk == prefix)) {
              push = true;
            } else if (mode == 2 && mk == prefix) {
              const int o = tie_base + mine++;
              if (o < need) emit(above + o, w);
            }
          }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, push);
        if (bal != 0u) {  // one shared atomic a warp
          const int leader = __ffs(bal) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&sm.vars[4], __popc(bal));
          at = __shfl_sync(0xffffffffu, at, leader);
          if (push) sm.loc[at + __popc(bal & lanes_below())] = w;
        }
      }
      tie_base += total;
    });
    if (tid < kListMax / 4) {
      reinterpret_cast<int4*>(sm.fill)[tid] = make_int4(0, 0, 0, 0);
      reinterpret_cast<int4*>(sm.split)[tid] = make_int4(-1, -1, -1, -1);
    }
    for (int e = tid; e < kSplitMax * (kBins + 1); e += kThreads) sm.ge2[e] = 0u;
    if (tid == 0) sm.vars[7] = 0;
    cl.sync();
    // every block's list, each word into its bucket's positions
    if (tid < nb) sm.vars[8 + tid] = *cl.map_shared_rank(sm.vars + 4, tid);
    __syncthreads();
    int listed = 0;
    for (int r = 0; r < nb; ++r) listed += sm.vars[8 + r];
    // a word's bucket: its bin at the first pass where its digit is above
    // the boundary digit (level: that pass), or the boundary bin (level: the
    // last pass); base: the keys above it
    auto bucket = [&](unsigned long long w, int* size, int* level) {
      const unsigned key = static_cast<unsigned>(w >> 32);
      int base = 0;
      for (int k = 0; k <= last; ++k) {
        const unsigned* ge = sm.ge + k * (kBins + 1);
        const int d = static_cast<int>((key >> (24 - 8 * k)) & 0xffu);
        if (d != digits[k]) {
          *size = static_cast<int>(ge[d] - ge[d + 1]);
          *level = k;
          return base + static_cast<int>(ge[d + 1]);
        }
        base += static_cast<int>(ge[digits[k] + 1]);
      }
      *size = in_bin;  // the boundary bin (listed in mode 1 only)
      *level = last;
      return base;
    };
    // a large bucket (more than kRefine words, a next digit left) is split
    // by its words' next digit, counted here, in each block, over every word
    auto split_digit = [&](unsigned long long w, int level) {
      return static_cast<int>((w >> (48 - 8 * level)) & 0xffu);
    };
    auto final_bucket = [&](unsigned long long w, int* size) {
      int level;
      int base = bucket(w, size, &level);
      if (*size > kRefine && level < kPasses - 1) {
        const int s = sm.split[base];
        if (s >= 0) {
          const unsigned* ge2 = sm.ge2 + s * (kBins + 1);
          const int d = split_digit(w, level);
          *size = static_cast<int>(ge2[d] - ge2[d + 1]);
          base += static_cast<int>(ge2[d + 1]);
        }
      }
      return base;
    };
    for (int e = tid; e < listed; e += kThreads) {
      int r = 0, o = e;
      while (o >= sm.vars[8 + r]) o -= sm.vars[8 + r++];
      const unsigned long long w = cl.map_shared_rank(sm.loc, r)[o];
      sm.all[e] = w;
      int size, level;
      const int base = bucket(w, &size, &level);
      if (size > kRefine && level < kPasses - 1 &&
          atomicCAS(&sm.split[base], -1, kListMax) == -1) {  // its first word names it
        const int s = atomicAdd(&sm.vars[7], 1);
        sm.split[base] = s < kSplitMax ? s : -2;
      }
    }
    __syncthreads();
    for (int e = tid; e < listed; e += kThreads) {
      const unsigned long long w = sm.all[e];
      int size, level;
      const int base = bucket(w, &size, &level);
      if (size > kRefine && level < kPasses - 1 && sm.split[base] >= 0) {
        atomicAdd(&sm.ge2[sm.split[base] * (kBins + 1) + split_digit(w, level)], 1u);
      }
    }
    __syncthreads();
    if (warp < min(sm.vars[7], kSplitMax)) {  // each split's counts to keys in bins >= d
      unsigned* ge2 = sm.ge2 + warp * (kBins + 1);
      unsigned c[8], local = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = ge2[kBins - 1 - 8 * lane - j];
        local += c[j];
      }
      unsigned run = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += v;
      }
      run -= local;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        run += c[j];
        ge2[kBins - 1 - 8 * lane - j] = run;
      }
      if (lane == 0) ge2[kBins] = 0u;
    }
    __syncthreads();
    for (int e = tid; e < listed; e += kThreads) {
      const unsigned long long w = sm.all[e];
      int size;
      const int base = final_bucket(w, &size);
      sm.placed[base + atomicAdd(&sm.fill[base], 1)] = w;
    }
    __syncthreads();
    // this block's share of `all` (the same in every block; each block
    // placed the words in its own order within a bucket): each word counts
    // the words of its bucket above it, g threads a word
    const int per = (listed + nb - 1) / nb;
    int g = 32;
    while (g > 1 && g * per > kThreads) g >>= 1;
    const int sub = tid & (g - 1);
    for (int e0 = me * per; e0 < me * per + per; e0 += kThreads / g) {
      const int e = e0 + tid / g;
      const bool ok = e < me * per + per && e < listed;
      const unsigned long long w = ok ? sm.all[e] : 0ull;
      int size = 0;
      const int base = ok ? final_bucket(w, &size) : 0;
      int r = 0;
      for (int j = base + sub; j < base + size; j += g) r += sm.placed[j] > w ? 1 : 0;
      for (int off = g >> 1; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
      if (ok && sub == 0 && base + r < want) emit(base + r, w);
    }
  }
  cl.sync();
  return want;
}

__global__ void __launch_bounds__(kThreads)
nms_select_kernel(const float* __restrict__ scores, int n, int p_count, int cap,
                  int* __restrict__ order, int* __restrict__ live) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int nb = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / nb;
  const Layout lay = layout(0, cap);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  Slice sl = slice_of(scores + (int64_t)b * n, n, me, nb,
                      reinterpret_cast<float*>(smem + lay.stage), cap, bar, 0u);
  cluster_select(cl, sl, 0u, kNoCursor, p_count, select_smem(smem, lay),
                 order + (int64_t)b * p_count, nullptr, live + b);
}

// ------------------------------------------------------- sorted bitmask scan
// Block (b, tile): rows p of tile row r against columns q of tile column c >= r.
__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                int64_t box_row_stride, const int* __restrict__ order, int n,
                int p_count, int words, int tiles, float iou_threshold,
                float thr_lo, float thr_hi, unsigned long long* __restrict__ mask) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ unsigned s_proper[kTile / 32];  // bit u: column u is a proper box
  const int b = blockIdx.x / tiles;
  int t = blockIdx.x - b * tiles;
  int r = 0;
  while (t >= words - r) {
    t -= words - r;
    ++r;
  }
  const int c = r + t;
  const int* ord = order + (int64_t)b * p_count;
  const float4* bx = boxes + (int64_t)b * box_row_stride;

  const int q = kTile * c + threadIdx.x;
  bool proper = false;
  if (q < p_count) {
    const float4 v = bx[ord[q]];
    const float area = area_of(v);
    s_box[threadIdx.x] = v;
    s_area[threadIdx.x] = area;
    proper = box_is_proper(v, area);
  }
  const unsigned proper_bits = __ballot_sync(0xffffffffu, proper);
  if ((threadIdx.x & 31) == 0) s_proper[threadIdx.x >> 5] = proper_bits;
  const int p = kTile * r + threadIdx.x;
  bool live = false;
  float4 pb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (p < p_count) {
    const int i = ord[p];
    live = scores[(int64_t)b * n + i] > kNegHalf;  // the scan never reads a dead row
    if (live) pb = bx[i];
  }
  __syncthreads();
  if (!live) return;
  const float barea = area_of(pb);
  // the pairs the products decide: a proper row box against proper columns
  const unsigned long long col_proper =
      (static_cast<unsigned long long>(s_proper[1]) << 32) | s_proper[0];
  const unsigned long long decided = box_is_proper(pb, barea) ? col_proper : 0ull;
  unsigned long long bits = 0ull, unsure = 0ull;
#pragma unroll
  for (int u = 0; u < kTile; ++u) {  // every column; the ones not wanted are masked below
    const float4 cb = s_box[u];
    const float ih = fmaxf(fminf(cb.z, pb.z) - fmaxf(cb.x, pb.x), 0.0f);
    const float iw = fmaxf(fminf(cb.w, pb.w) - fmaxf(cb.y, pb.y), 0.0f);
    const float inter = ih * iw;
    const float uni = s_area[u] + barea - inter;
    const bool above = inter > thr_hi * uni;
    const bool below = inter < thr_lo * uni;
    if (above) bits |= 1ull << u;
    if (!above && !below) unsure |= 1ull << u;
  }
  unsure |= ~decided;
  bits &= decided;
  // only columns after p, and inside the row
  unsigned long long wanted = ~0ull;
  const int q_end = min(kTile, p_count - kTile * c);
  if (q_end < kTile) wanted &= (1ull << q_end) - 1ull;
  if (c == r) wanted &= threadIdx.x == kTile - 1 ? 0ull : ~0ull << (threadIdx.x + 1);
  bits &= wanted;
  for (unsure &= wanted; unsure != 0ull; unsure &= unsure - 1ull) {
    const int u = __ffsll(static_cast<long long>(unsure)) - 1;
    const float4 cb = s_box[u];
    if (iou_above(cb.x, cb.y, cb.z, cb.w, s_area[u], pb.x, pb.y, pb.z, pb.w, barea,
                  iou_threshold)) {
      bits |= 1ull << u;
    }
  }
  mask[((int64_t)b * p_count + p) * mask_stride(p_count) + c] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const float* __restrict__ scores, const int* __restrict__ order,
                const int* __restrict__ num_select,
                const unsigned long long* __restrict__ mask, int n, int p_count,
                int max_out, const int* __restrict__ live_count,
                int* __restrict__ sel, bool* __restrict__ valid,
                int* __restrict__ row_state) {
  // [p_count, stride] mask words, then the order, then the picks' positions
  extern __shared__ __align__(16) unsigned long long s_mask[];
  const int stride = mask_stride(p_count);
  int* s_order = reinterpret_cast<int*>(s_mask + (size_t)p_count * stride);
  int* s_pick = s_order + p_count;
  __shared__ int s_first_dead;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* ord = order + (int64_t)b * p_count;
  int* sel_row = sel + (int64_t)b * max_out;
  bool* val_row = valid + (int64_t)b * max_out;
  const int n_sel = min(num_select[b], max_out);

  // the copy of the row's mask flies while the live prefix is found; rows of
  // dead positions were never written, and are never read
  const unsigned long long* m = mask + (int64_t)b * p_count * stride;
  for (int e = 2 * tid; e < p_count * stride; e += 2 * kScanThreads) {
    __pipeline_memcpy_async(s_mask + e, m + e, 16);
  }
  __pipeline_commit();
  for (int k = tid; k < max_out; k += kScanThreads) {
    sel_row[k] = 0;
    val_row[k] = false;
  }
  if (tid == 0) s_first_dead = p_count;
  __syncthreads();
  // scores fall along the order, so the live candidates are a prefix
  for (int p = tid; p < p_count; p += kScanThreads) {
    const int i = ord[p];
    s_order[p] = i;
    if (!(scores[(int64_t)b * n + i] > kNegHalf)) {
      atomicMin(&s_first_dead, p);  // later positions of this thread are dead too
      break;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid >= 32) return;
  const int n_live = s_first_dead;

  // lane l keeps removed word l (32 bits); the current word's live bits are
  // the same in every lane, so a pick within a word needs no shuffle
  const unsigned* mask32 = reinterpret_cast<const unsigned*>(s_mask);
  const int stride32 = 2 * stride;
  const int words32 = (p_count + 31) / 32;
  const int lane = tid;
  unsigned removed = 0u;
  int k = 0;
  for (int w = 0; 32 * w < n_live && k < n_sel; ++w) {
    const int left = n_live - 32 * w;
    const unsigned range = left >= 32 ? ~0u : (1u << left) - 1u;
    unsigned live = ~__shfl_sync(0xffffffffu, removed, w) & range;
    while (live != 0u && k < n_sel) {
      const int p = 32 * w + __ffs(live) - 1;
      s_pick[k++] = p;  // the same value from every lane
      const unsigned* row = mask32 + (size_t)p * stride32;
      live &= ~(row[w] | (live & (0u - live)));  // drop the pick and what it kills
      if (lane > w && lane < words32) removed |= row[lane];
    }
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    sel_row[j] = s_order[s_pick[j]];
    val_row[j] = true;
  }
  if (row_state != nullptr && lane == 0) {
    const int live_b = live_count[b];
    row_state[2 * b] = k;
    row_state[2 * b + 1] = k < min(n_sel, live_b) && live_b > p_count ? 1 : 0;
  }
}

// --------------------------------------------------------------- continuation
// A cluster's rows that ran out, one at a time (the same rows, in the same
// order, in each of its blocks).
__device__ __noinline__ void continue_rows(
    const float* __restrict__ scores, const float4* __restrict__ boxes, int64_t box_row_stride,
    const int* __restrict__ order, const int* __restrict__ num_select,
    const int* __restrict__ row_state, int rows, int n, int p_count, int tile_max, int cap,
    int max_out, float iou_threshold, float thr_lo, float thr_hi, int* __restrict__ sel,
    bool* __restrict__ valid, int* __restrict__ continued) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int nb = static_cast<int>(cl.num_blocks());
  const int me = static_cast<int>(cl.block_rank());
  const int cluster = blockIdx.x / nb, clusters = gridDim.x / nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout lay = layout(tile_max, cap);
  const SelectSmem sm = select_smem(smem, lay);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + lay.mask);  // overlays the select's scratch
  unsigned long long* sorted = reinterpret_cast<unsigned long long*>(smem + lay.sorted);
  float4* t_box = reinterpret_cast<float4*>(smem + lay.t_box);
  float* t_area = reinterpret_cast<float*>(smem + lay.t_area);
  int* t_idx = reinterpret_cast<int*>(smem + lay.t_idx);
  int* t_pick = reinterpret_cast<int*>(smem + lay.t_pick);
  unsigned* alive = reinterpret_cast<unsigned*>(smem + lay.alive);
  float4* p_box = reinterpret_cast<float4*>(smem + lay.p_box);
  float* p_area = reinterpret_cast<float*>(smem + lay.p_area);
  int* row_list = reinterpret_cast<int*>(smem + lay.row_list);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + lay.bar);
  float* buf = reinterpret_cast<float*>(smem + lay.stage);
  unsigned phase = 0u;
  bool bar_ready = false;  // the mbarrier, set up at the first row continued
  const unsigned live_floor = sort_key(kNegHalf);

  for (int r0 = cluster; r0 < rows; r0 += clusters * kThreads) {
    // this chunk's rows that ran out, in row order (one read of each state)
    const int rb = r0 + clusters * tid;
    const int ran = rb < rows && row_state[2 * rb + 1] != 0 ? 1 : 0;
    if (!__syncthreads_or(ran)) continue;  // none: the cost of a pool that did not run out
    if (!bar_ready) {
      if (tid == 0) mbar_init(bar);
      bar_ready = true;
    }
    int n_rows = 0;
    const int at = block_scan(ran, sm.warp_sum, &n_rows);
    if (ran) row_list[at] = rb;
    __syncthreads();
    for (int t = 0; t < n_rows; ++t) {
      const int b = row_list[t];
      const float* s = scores + (int64_t)b * n;
      const int* ord = order + (int64_t)b * p_count;
      if (s[ord[0]] != s[ord[0]]) continue;  // a NaN sorts first: the row selects nothing
      const float4* bx = boxes + (int64_t)b * box_row_stride;
      int* sel_row = sel + (int64_t)b * max_out;
      bool* val_row = valid + (int64_t)b * max_out;
      const int n_sel = min(num_select[b], max_out);
      int k = row_state[2 * b];
      if (me == 0 && tid == 0) atomicAdd(continued, 1);
      // the pool's picks' boxes (the first tile's kill) load while the row is staged
      const int preload = min(k, kPickChunk);
      float4 pick = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tid < preload) pick = bx[sel_row[tid]];
      Slice sl = slice_of(s, n, me, nb, buf, cap, bar, phase);
      if (tid < preload) {
        p_box[tid] = pick;
        p_area[tid] = area_of(pick);
      }
      int tiles = 0;
      const int last = ord[p_count - 1];
      unsigned long long cursor = rank_word(sort_key(s[last]), last);
      int tile = first_tile(n_sel - k, tile_max);
      while (k < n_sel) {
        const int c = cluster_select(cl, sl, live_floor, cursor, tile, sm, nullptr, sorted,
                                     nullptr);
        if (c == 0) break;
        const int words = (c + 31) / 32;
        for (int p = tid; p < c; p += kThreads) {
          const int i = index_of(sorted[p]);
          const float4 v = bx[i];
          t_box[p] = v;
          t_area[p] = area_of(v);
          t_idx[p] = i;
        }
        cursor = sorted[c - 1];
        // the kill by every earlier pick: this block's words of candidates,
        // g threads a candidate, each over every g-th pick
        const int share = (words + nb - 1) / nb;
        const int w0 = min(words, me * share), w1 = min(words, w0 + share);
        const int q0 = 32 * w0, nq = min(c, 32 * w1) - q0;
        for (int w = w0 + tid; w < w1; w += kThreads) alive[w] = 0u;
        int g = 32;
        while (g > 1 && g * nq > kThreads) g >>= 1;
        const int sub = tid & (g - 1), q = q0 + tid / g;
        const bool has = tid / g < nq;
        __syncthreads();
        const float4 cb = has ? t_box[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float ca = has ? t_area[q] : 0.0f;
        bool killed = false;
        for (int j0 = 0; j0 < k; j0 += kPickChunk) {
          const int m = min(kPickChunk, k - j0);
          if (tiles > 0 || j0 > 0 || m > preload) {  // else the preloaded pool's picks
            for (int u = tid; u < m; u += kThreads) {
              // picks this kernel wrote: not from L1
              const float4 v = bx[__ldcg(sel_row + j0 + u)];
              p_box[u] = v;
              p_area[u] = area_of(v);
            }
            __syncthreads();
          }
          for (int u = sub; has && !killed && u < m; u += g) {
            killed = pair_above(cb, ca, p_box[u], p_area[u], iou_threshold, thr_lo, thr_hi);
          }
          if (j0 + kPickChunk < k) __syncthreads();  // p_box is rewritten by the next chunk
        }
        int kill = killed ? 1 : 0;
        for (int off = g >> 1; off > 0; off >>= 1) kill |= __shfl_xor_sync(0xffffffffu, kill, off);
        if (has && sub == 0 && !kill) atomicOr(&alive[q >> 5], 1u << (q & 31));
        // in the same phase, the tile's upper triangle into the first
        // block's mask: word w of position p, bit u: IoU(32w + u, p) > thr
        // for p < 32w + u < c (the walk reads the rows of alive positions
        // only). Items (p, w) are w-major; the blocks take them in turn, so
        // a small tile spreads over all of them. Fewer items than the
        // cluster has threads (a tile up to 512 wide on 8 blocks): a warp an item, a
        // lane a column, the word from a ballot (a pair test is a serial
        // chain of ~200 cycles, so latency decides); else a thread an item
        // over its 32 columns (fewer instructions a test)
        unsigned* mask0 = cl.map_shared_rank(mask, 0);
        if (words * c <= nb * kThreads) {
          for (int it = warp * nb + me; it < words * c; it += nb * kWarps) {
            const int w = it / c, p = it - w * c;
            if (w < (p >> 5)) continue;
            const int qq = 32 * w + lane;
            const bool hit = qq > p && qq < c &&
                             pair_above(t_box[qq], t_area[qq], t_box[p], t_area[p],
                                        iou_threshold, thr_lo, thr_hi);
            const unsigned bits = __ballot_sync(0xffffffffu, hit);
            if (lane == 0) mask0[p * words + w] = bits;
          }
        } else {
          for (int it = tid * nb + me; it < words * c; it += nb * kThreads) {
            const int w = it / c, p = it - w * c;
            if (w < (p >> 5)) continue;
            const float4 pb = t_box[p];
            const float pa = t_area[p];
            const int q_lo = max(32 * w, p + 1), q_hi = min(32 * w + 32, c);
            unsigned bits = 0u;
            for (int qq = q_lo; qq < q_hi; ++qq) {
              if (pair_above(t_box[qq], t_area[qq], pb, pa, iou_threshold, thr_lo, thr_hi)) {
                bits |= 1u << (qq - 32 * w);
              }
            }
            mask0[p * words + w] = bits;
          }
        }
        __syncthreads();
        if (me != 0) {  // this block's alive words to the first block, which walks
          unsigned* alive0 = cl.map_shared_rank(alive, 0);
          for (int w = w0 + tid; w < w1; w += kThreads) alive0[w] = alive[w];
        }
        cl.sync();
        if (me == 0 && warp == 0) {  // the scan's walk over the tile
          unsigned removed = 0u;
          int j = 0;
          for (int w = 0; w < words && k + j < n_sel; ++w) {
            const int left = c - 32 * w;
            const unsigned range = left >= 32 ? ~0u : (1u << left) - 1u;
            unsigned live = alive[w] & ~__shfl_sync(0xffffffffu, removed, w) & range;
            while (live != 0u && k + j < n_sel) {
              const int p = 32 * w + __ffs(live) - 1;
              t_pick[j++] = p;
              const unsigned* row = mask + p * words;
              live &= ~(row[w] | (live & (0u - live)));
              if (lane > w && lane < words) removed |= row[lane];
            }
          }
          __syncwarp();
          for (int jj = lane; jj < j; jj += 32) {
            sel_row[k + jj] = t_idx[t_pick[jj]];
            val_row[k + jj] = true;
          }
          __threadfence();
          if (lane == 0) {
            for (int r = 0; r < nb; ++r) {
              int* v = cl.map_shared_rank(sm.vars, r);
              v[kVarK] = k + j;
              v[kVarPicked] = j;
            }
          }
        }
        cl.sync();
        const int picked = sm.vars[kVarPicked];
        k = sm.vars[kVarK];
        ++tiles;
        if (c < tile) break;  // that was the row's last live candidate
        tile = next_tile(tile, c, picked, n_sel - k, tile_max);
      }
      phase = sl.phase;
    }
    __syncthreads();  // row_list is rewritten by the next chunk
  }
}

// Clusters of nb blocks: cluster q takes the rows q, q + clusters, ... that
// ran out (continue_rows). A cluster none of whose rows ran out leaves after
// one read of each row's state, before anything else.
__global__ void __launch_bounds__(kThreads)
nms_continue_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                    int64_t box_row_stride, const int* __restrict__ order,
                    const int* __restrict__ num_select, const int* __restrict__ row_state,
                    int rows, int n, int p_count, int tile_max, int cap, int max_out,
                    float iou_threshold, float thr_lo, float thr_hi, int* __restrict__ sel,
                    bool* __restrict__ valid, int* __restrict__ continued) {
  const int nb = static_cast<int>(cg::this_cluster().num_blocks());
  const int cluster = blockIdx.x / nb, clusters = gridDim.x / nb;
  int ran = 0;
  for (int rb = cluster + clusters * threadIdx.x; rb < rows; rb += clusters * kThreads) {
    ran |= row_state[2 * rb + 1];
  }
  if (!__syncthreads_or(ran)) return;
  continue_rows(scores, boxes, box_row_stride, order, num_select, row_state, rows, n, p_count,
                tile_max, cap, max_out, iou_threshold, thr_lo, thr_hi, sel, valid, continued);
}

// The rows' clusters: cudaLaunchKernelEx with a cluster of nb blocks
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int clusters, int nb, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * nb));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nb);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// C entries for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launches (0 when
// they were accepted), or cudaErrorInvalidValue for sizes it does not take.

// Once, when the library is loaded (for the current device): the SM count,
// the shared memory a block may opt into, and the kernels' dynamic
// shared-memory limits.
extern "C" int tpudet_nms_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kScanMaxSmem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_smem_optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(nms_continue_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_optin);
  }
  for (int nb = 1; err == cudaSuccess && nb <= kMaxCluster; ++nb) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(nb));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(g_smem_optin);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(nb);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&g_select_clusters[nb], nms_select_kernel, &cfg);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&g_continue_clusters[nb], nms_continue_kernel, &cfg);
    }
  }
  return static_cast<int>(err);
}

// The first p_count (<= 1024, <= n) positions of each row's stable descending
// order into `order` ([rows, p_count] int32) and each row's live count (scores
// > -1e30/2) into `live` ([rows] int32).
extern "C" int tpudet_nms_select(const float* scores, int rows, int n, int p_count,
                                 int* order, int* live, void* stream) {
  if (p_count <= 0 || p_count > kSortedMaxWidth || p_count > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const int nb = cluster_blocks(rows, n, g_select_clusters);
    const int per = (n + nb - 1) / nb;
    const int cap_max = stage_cap_max(0);
    const int cap = (per + 3) / 4 * 4 < cap_max ? (per + 3) / 4 * 4 : cap_max;
    const cudaError_t err = launch_clusters(nms_select_kernel, rows, nb, layout(0, cap).end,
                                            static_cast<cudaStream_t>(stream), scores, n,
                                            p_count, cap, order, live);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The mask of the sorted bitmask scan over `order` ([rows, p_count] int32
// positions into the rows of width n, each row's stable descending score
// order or a prefix of it) into `mask`, [rows, p_count, stride] uint64
// scratch, stride = ceil(p_count / 64) rounded up to even; `boxes` is 16-byte
// aligned, box_row_stride 0 (shared boxes) or 4n (per-row boxes).
extern "C" int tpudet_nms_mask(const float* scores, const float* boxes,
                               int64_t box_row_stride, const int* order, int rows, int n,
                               int p_count, float iou_threshold, unsigned long long* mask,
                               void* stream) {
  if (p_count < 0 || p_count > kSortedMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (p_count + kTile - 1) / kTile;
  const int tiles = words * (words + 1) / 2;
  float thr_lo, thr_hi;
  product_bounds(iou_threshold, &thr_lo, &thr_hi);
  if (rows > 0 && tiles > 0) {
    nms_mask_kernel<<<rows * tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        scores, reinterpret_cast<const float4*>(boxes), box_row_stride / 4, order, n,
        p_count, words, tiles, iou_threshold, thr_lo, thr_hi, mask);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scan over `order` and tpudet_nms_mask's `mask` into `sel`, `valid`
// ([rows, max_out]). With `live` (tpudet_nms_select's) it writes each row's
// state into `row_state` ([rows, 2] int32: picks, ran out); both may be null.
extern "C" int tpudet_nms_scan(const float* scores, const int* order,
                               const int* num_select, const int* live, int rows, int n,
                               int p_count, int max_out, const unsigned long long* mask,
                               int* sel, bool* valid, int* row_state, void* stream) {
  if (p_count < 0 || p_count > kSortedMaxWidth || (row_state != nullptr && live == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const size_t smem = sizeof(unsigned long long) * (size_t)p_count * mask_stride(p_count) +
                        2 * sizeof(int) * (size_t)p_count;
    nms_scan_kernel<<<rows, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        scores, order, num_select, mask, n, p_count, max_out, live, sel, valid, row_state);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rows that ran out go on past their pool (`order`, p_count < n wide, and
// `row_state` as tpudet_nms_scan left them) in tiles of at most `tile` (<=
// 1024) positions, appending to `sel` and `valid`; `continued` (one int32)
// counts the rows continued.
extern "C" int tpudet_nms_continue(const float* scores, const float* boxes,
                                   int64_t box_row_stride, const int* order,
                                   const int* num_select, const int* row_state,
                                   int rows, int n, int p_count, int tile, int max_out,
                                   float iou_threshold, int* sel, bool* valid,
                                   int* continued, void* stream) {
  if (p_count <= 0 || p_count >= n || tile <= 0 || tile > kSortedMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    const int clusters = rows < kContinueClusters ? rows : kContinueClusters;
    const int nb = cluster_blocks(clusters, n, g_continue_clusters);
    const int per = (n + nb - 1) / nb;
    const int cap_max = stage_cap_max(tile);
    const int cap = (per + 3) / 4 * 4 < cap_max ? (per + 3) / 4 * 4 : cap_max;
    float thr_lo, thr_hi;
    product_bounds(iou_threshold, &thr_lo, &thr_hi);
    const cudaError_t err = launch_clusters(
        nms_continue_kernel, clusters, nb, layout(tile, cap).end,
        static_cast<cudaStream_t>(stream), scores, reinterpret_cast<const float4*>(boxes),
        box_row_stride / 4, order, num_select, row_state, rows, n, p_count, tile, cap,
        max_out, iou_threshold, thr_lo, thr_hi, sel, valid, continued);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// A whole pool call in one entry, in stream order: the select, mask and scan
// kernels over each row's first p_count positions and, where p_count < n,
// the continuation in tiles of at most `tile`. `work` is [rows * (p_count +
// 3)] int32 scratch: the order, the live counts and the rows' state.
extern "C" int tpudet_nms_pool(const float* scores, const float* boxes,
                               int64_t box_row_stride, const int* num_select, int rows,
                               int n, int p_count, int tile, int max_out,
                               float iou_threshold, int* work, unsigned long long* mask,
                               int* sel, bool* valid, int* continued, void* stream) {
  int* order = work;
  int* live = order + (size_t)rows * p_count;
  int* state = p_count < n ? live + rows : nullptr;
  int err = tpudet_nms_select(scores, rows, n, p_count, order, live, stream);
  if (err == 0) {
    err = tpudet_nms_mask(scores, boxes, box_row_stride, order, rows, n, p_count,
                          iou_threshold, mask, stream);
  }
  if (err == 0) {
    err = tpudet_nms_scan(scores, order, num_select, live, rows, n, p_count, max_out, mask,
                          sel, valid, state, stream);
  }
  if (err == 0 && state != nullptr) {
    err = tpudet_nms_continue(scores, boxes, box_row_stride, order, num_select, state, rows,
                              n, p_count, tile, max_out, iou_threshold, sel, valid,
                              continued, stream);
  }
  return err;
}
