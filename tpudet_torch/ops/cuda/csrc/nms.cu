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
//    sort of the whole row that stood in for it): one 1024-thread block per
//    row writes the first P <= 1024 positions of the stable descending order
//    and the row's live count (scores > -1e30/2). Keys are made canonical
//    (every NaN the same positive NaN, sorted first; -0.0 as +0.0) and mapped
//    to unsigned words whose order is the scores'; a key and ~index make one
//    64-bit rank word, unique, larger = earlier. block_select radix-selects
//    the P-th key in four 8-bit digit passes over the row (histograms in
//    shared memory, warp-aggregated with __match_any_sync, since dead scores
//    share one key), takes the keys above it and the lowest indices of the
//    keys equal to it (an ordered block scan: ties across the pool's edge go
//    to the lowest index), and bitonic-sorts the P winners' rank words in
//    shared memory. Bound: bytes, the row's scores read once (32 x 8828 x 4 B
//    at the mining pool: 0.37 us of HBM); it reads the row six times (the
//    live count, four digit passes, the winners), from L2 after the first,
//    each thread loading kUnroll entries before it uses them.
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
//    full-width rerun): one 1024-thread block per row; a row that did not
//    run out returns at once, a row holding a NaN selects nothing (as
//    tpudet's fallback), and a row that ran out goes on from the pool's
//    picks, tile by tile in stable order after the last position taken:
//    block_select picks the next T <= 1024 live candidates after that rank
//    word, every earlier pick kills what it overlaps (the picks' boxes staged
//    through shared memory), the tile's upper-triangle IoU bitmask is built
//    in shared memory and one warp walks it as the scan does, up to the quota
//    or the last live candidate. It counts the rows it continued in a
//    device-side int32. Bound: bytes or operations of the IoU tests past the
//    pool; its cost is a select (the row from L2) and a T x T triangle a
//    tile, and for a row that did not run out one read of its state.
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegHalf = -5e29f;  // -1e30 / 2: at or below this, no candidate

constexpr int kSortedMaxWidth = 1024;  // 32 words of 32 bits: one a lane of the scan warp
constexpr int kMaxWords = kSortedMaxWidth / 64;
constexpr int kTile = 64;
constexpr int kScanThreads = 512;
constexpr size_t kScanMaxSmem = sizeof(unsigned long long) * kSortedMaxWidth * kMaxWords +
                                2 * sizeof(int) * kSortedMaxWidth;

constexpr int kSelectThreads = 1024;  // one position of a pool or tile a thread
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kRadixBins = 256;
constexpr int kUnroll = 4;  // row entries a thread loads before it uses them
constexpr unsigned long long kNoCursor = ~0ull;

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

struct SelectSmem {
  unsigned* hist;             // [kRadixBins]
  int* warp_count;            // [kUnroll * kSelectWarps]
  int* vars;                  // [4]
  unsigned long long* words;  // [kSelectThreads]: the winners' rank words
};

// Sorts w[0, c) descending in place (c <= kSelectThreads), padding with 0.
__device__ void block_sort_desc(unsigned long long* w, int c) {
  int size = 1;
  while (size < c) size <<= 1;
  for (int i = c + threadIdx.x; i < size; i += kSelectThreads) w[i] = 0ull;
  __syncthreads();
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < size; i += kSelectThreads) {
        const int x = i ^ j;
        if (x > i) {
          const unsigned long long a = w[i], b = w[x];
          if ((i & k) == 0 ? a < b : a > b) {
            w[i] = b;
            w[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Block-wide (kSelectThreads threads, all calling): of the row's candidates,
// the entries i with sort_key(s[i]) > key_floor and a rank word below
// `cursor`, the first c = min(count, their number) in stable descending
// order, left in sm.words[0, c) as rank words. Returns c in every thread.
__device__ int block_select(const float* __restrict__ s, int n, unsigned key_floor,
                            unsigned long long cursor, int count, SelectSmem sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0u, fixed = 0u;  // the key bits decided so far, and which
  int need = count;  // winners still to take among the keys matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = tid; d < kRadixBins; d += kSelectThreads) sm.hist[d] = 0u;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kUnroll * kSelectThreads) {
      unsigned key[kUnroll];  // 0 past the row: no score has it, and it is no candidate
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSelectThreads + tid;
        key[u] = i < n ? sort_key(s[i]) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSelectThreads + tid;
        const bool in = key[u] > key_floor && rank_word(key[u], i) < cursor &&
                        (key[u] & fixed) == prefix;
        const unsigned digit = (key[u] >> shift) & 0xffu;
        const unsigned active = __ballot_sync(0xffffffffu, in);
        if (in) {  // one shared atomic for each distinct digit of the warp
          const unsigned peers = __match_any_sync(active, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&sm.hist[digit], __popc(peers));
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l: a scan over the lanes
      // counts the keys in the bins above each
      unsigned c[8], local = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sm.hist[kRadixBins - 1 - 8 * lane - j];
        local += c[j];
      }
      unsigned incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      int want = need;
      if (shift == 24) want = min(need, static_cast<int>(__shfl_sync(0xffffffffu, incl, 31)));
      if (lane == 0) sm.vars[2] = want;
      unsigned run = incl - local;
      if (want > 0 && run < static_cast<unsigned>(want) &&
          static_cast<unsigned>(want) <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= static_cast<unsigned>(want)) {
            sm.vars[0] = kRadixBins - 1 - 8 * lane - j;
            sm.vars[1] = static_cast<int>(run);
            sm.vars[3] = static_cast<int>(c[j]);
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    const int want = sm.vars[2];
    if (want == 0) return 0;
    prefix |= static_cast<unsigned>(sm.vars[0]) << shift;
    fixed |= 0xffu << shift;
    need = want - sm.vars[1];
    const bool whole_bin = sm.vars[3] == need;
    __syncthreads();  // vars are rewritten below or in the next pass
    if (whole_bin) break;  // every key matching prefix is a winner
  }

  // the winners: keys above prefix, and the first `need` keys equal to it in
  // index order (an ordered count across the block, kUnroll tiles of
  // kSelectThreads entries at a time)
  if (tid == 0) sm.vars[0] = 0;
  int ties_before = 0;
  const unsigned below_lane = (1u << lane) - 1u;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kUnroll * kSelectThreads) {
    unsigned long long w[kUnroll];
    unsigned above = 0u, tie_bits[kUnroll];  // above: bit u for tile u
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kSelectThreads + tid;
      const unsigned key = i < n ? sort_key(s[i]) : 0u;
      w[u] = rank_word(key, i);
      const bool cand = key > key_floor && w[u] < cursor;
      if (cand && (key & fixed) > prefix) above |= 1u << u;
      tie_bits[u] = __ballot_sync(0xffffffffu, cand && (key & fixed) == prefix);
      if (lane == 0) sm.warp_count[u * kSelectWarps + warp] = __popc(tie_bits[u]);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int rank = ties_before + __popc(tie_bits[u] & below_lane);
      int tile_ties = 0;
      for (int v = 0; v < kSelectWarps; ++v) {
        const int cnt = sm.warp_count[u * kSelectWarps + v];
        if (v < warp) rank += cnt;
        tile_ties += cnt;
      }
      ties_before += tile_ties;
      const bool win = ((above >> u) & 1u) || (((tie_bits[u] >> lane) & 1u) && rank < need);
      const unsigned win_bits = __ballot_sync(0xffffffffu, win);
      if (win_bits != 0u) {
        const int leader = __ffs(win_bits) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&sm.vars[0], __popc(win_bits));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (win) sm.words[base + __popc(win_bits & below_lane)] = w[u];
      }
    }
    __syncthreads();  // warp_count is rewritten by the next tiles
  }
  const int c = sm.vars[0];
  block_sort_desc(sm.words, c);
  return c;
}

__global__ void __launch_bounds__(kSelectThreads)
nms_select_kernel(const float* __restrict__ scores, int n, int p_count,
                  int* __restrict__ order, int* __restrict__ live) {
  __shared__ unsigned hist[kRadixBins];
  __shared__ int warp_count[kUnroll * kSelectWarps];
  __shared__ int vars[4];
  __shared__ unsigned long long words[kSelectThreads];
  __shared__ int s_live;
  const int b = blockIdx.x;
  const float* s = scores + (int64_t)b * n;
  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  int mine = 0;
  for (int i0 = 0; i0 < n; i0 += kUnroll * kSelectThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kSelectThreads + threadIdx.x;
      v[u] = i < n ? s[i] : kNegHalf;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mine += v[u] > kNegHalf ? 1 : 0;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_live, mine);
  const int c = block_select(s, n, 0u, kNoCursor, p_count,
                             SelectSmem{hist, warp_count, vars, words});
  for (int j = threadIdx.x; j < c; j += kSelectThreads) {
    order[(int64_t)b * p_count + j] = index_of(words[j]);
  }
  if (threadIdx.x == 0) live[b] = s_live;
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
// Dynamic shared memory of nms_continue_kernel for tiles of `tile` positions:
// the select's rank words, the tile's and a chunk of picks' boxes and areas,
// the tile's indices and new picks, the histogram, the alive bits, counts and
// variables, then the tile's [tile, ceil(tile / 32)] mask of 32-bit words.
constexpr size_t kContinueFixedSmem =
    sizeof(unsigned long long) * kSelectThreads + 2 * sizeof(float4) * kSelectThreads +
    2 * sizeof(float) * kSelectThreads + 2 * sizeof(int) * kSelectThreads +
    sizeof(unsigned) * (kRadixBins + kSelectWarps) +
    sizeof(int) * (kUnroll * kSelectWarps + 8);

__host__ __device__ __forceinline__ size_t continue_smem(int tile) {
  return kContinueFixedSmem + sizeof(unsigned) * (size_t)tile * ((tile + 31) / 32);
}

__global__ void __launch_bounds__(kSelectThreads)
nms_continue_kernel(const float* __restrict__ scores, const float4* __restrict__ boxes,
                    int64_t box_row_stride, const int* __restrict__ order,
                    const int* __restrict__ num_select, const int* __restrict__ row_state,
                    int n, int p_count, int tile, int max_out, float iou_threshold,
                    int* __restrict__ sel, bool* __restrict__ valid,
                    int* __restrict__ continued) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* words = reinterpret_cast<unsigned long long*>(smem);
  float4* t_box = reinterpret_cast<float4*>(words + kSelectThreads);
  float4* p_box = t_box + kSelectThreads;
  float* t_area = reinterpret_cast<float*>(p_box + kSelectThreads);
  float* p_area = t_area + kSelectThreads;
  int* t_idx = reinterpret_cast<int*>(p_area + kSelectThreads);
  int* t_pick = t_idx + kSelectThreads;
  unsigned* hist = reinterpret_cast<unsigned*>(t_pick + kSelectThreads);
  unsigned* alive = hist + kRadixBins;
  int* warp_count = reinterpret_cast<int*>(alive + kSelectWarps);
  int* vars = warp_count + kUnroll * kSelectWarps;  // [0, 4) the select's, [4] the picks made
  unsigned* t_mask = reinterpret_cast<unsigned*>(vars + 8);
  const SelectSmem sm{hist, warp_count, vars, words};

  const int b = blockIdx.x;
  if (row_state[2 * b + 1] == 0) return;  // the pool's picks are the row's
  const float* s = scores + (int64_t)b * n;
  const int* ord = order + (int64_t)b * p_count;
  if (s[ord[0]] != s[ord[0]]) return;  // a NaN sorts first: the row selects nothing
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* bx = boxes + (int64_t)b * box_row_stride;
  int* sel_row = sel + (int64_t)b * max_out;
  bool* val_row = valid + (int64_t)b * max_out;
  const int n_sel = min(num_select[b], max_out);
  int k = row_state[2 * b];
  if (tid == 0) atomicAdd(continued, 1);

  const unsigned live_floor = sort_key(kNegHalf);
  const int last = ord[p_count - 1];
  unsigned long long cursor = rank_word(sort_key(s[last]), last);
  while (k < n_sel) {
    const int c = block_select(s, n, live_floor, cursor, tile, sm);
    if (c == 0) break;
    bool up = tid < c;  // this position is still alive
    float4 cb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float ca = 0.0f;
    if (up) {
      const int i = index_of(words[tid]);
      cb = bx[i];
      ca = area_of(cb);
      t_idx[tid] = i;
      t_box[tid] = cb;
      t_area[tid] = ca;
    }
    cursor = words[c - 1];
    // every earlier pick kills what it overlaps, a chunk of picks at a time
    for (int j0 = 0; j0 < k; j0 += kSelectThreads) {
      __syncthreads();
      if (j0 + tid < k) {
        const float4 pb = bx[sel_row[j0 + tid]];
        p_box[tid] = pb;
        p_area[tid] = area_of(pb);
      }
      __syncthreads();
      const int m = min(kSelectThreads, k - j0);
      for (int u = 0; up && u < m; ++u) {
        const float4 pb = p_box[u];
        up = !iou_above(cb.x, cb.y, cb.z, cb.w, ca, pb.x, pb.y, pb.z, pb.w, p_area[u],
                        iou_threshold);
      }
    }
    const unsigned up_bits = __ballot_sync(0xffffffffu, up);
    if (lane == 0) alive[warp] = up_bits;
    __syncthreads();
    // the triangle: word w of alive position p's row, bit u: IoU(q = 32w + u,
    // p) > thr for p < q < c; a warp takes 32 positions of one word, whose
    // column boxes it reads alike
    const int words32 = (c + 31) / 32;
    for (int pair = tid; pair < words32 * c; pair += kSelectThreads) {
      const int w = pair / c, p = pair - w * c;
      if (w < (p >> 5) || !((alive[p >> 5] >> (p & 31)) & 1u)) continue;
      const float4 pb = t_box[p];
      const float pa = t_area[p];
      const int q_lo = max(32 * w, p + 1), q_hi = min(32 * w + 32, c);
      unsigned bits = 0u;
      for (int q = q_lo; q < q_hi; ++q) {
        const float4 qb = t_box[q];
        if (iou_above(qb.x, qb.y, qb.z, qb.w, t_area[q], pb.x, pb.y, pb.z, pb.w, pa,
                      iou_threshold)) {
          bits |= 1u << (q - 32 * w);
        }
      }
      t_mask[p * words32 + w] = bits;
    }
    __syncthreads();
    if (warp == 0) {  // the scan's walk over the tile
      unsigned removed = 0u;
      int j = 0;
      for (int w = 0; w < words32 && k + j < n_sel; ++w) {
        const int left = c - 32 * w;
        const unsigned range = left >= 32 ? ~0u : (1u << left) - 1u;
        unsigned live = alive[w] & ~__shfl_sync(0xffffffffu, removed, w) & range;
        while (live != 0u && k + j < n_sel) {
          const int p = 32 * w + __ffs(live) - 1;
          t_pick[j++] = p;
          const unsigned* row = t_mask + p * words32;
          live &= ~(row[w] | (live & (0u - live)));
          if (lane > w && lane < words32) removed |= row[lane];
        }
      }
      __syncwarp();
      for (int jj = lane; jj < j; jj += 32) {
        sel_row[k + jj] = t_idx[t_pick[jj]];
        val_row[k + jj] = true;
      }
      if (lane == 0) vars[4] = k + j;
    }
    __syncthreads();
    k = vars[4];
    if (c < tile) break;  // that was the row's last live candidate
  }
}

}  // namespace

// C entries for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launches (0 when
// they were accepted), or cudaErrorInvalidValue for sizes it does not take.

// Once, when the library is loaded (for the current device): the dynamic
// shared-memory limits of the scan and the continuation.
extern "C" int tpudet_nms_init() {
  cudaError_t err = cudaFuncSetAttribute(nms_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kScanMaxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nms_continue_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(continue_smem(kSelectThreads)));
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
    nms_select_kernel<<<rows, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scores, n, p_count, order, live);
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
  float thr_lo = -INFINITY, thr_hi = INFINITY;  // decide every pair by division
  if (iou_threshold >= 0x1p-20f && iou_threshold <= 0x1p20f) {
    thr_lo = static_cast<float>(iou_threshold * (1.0 - 0x1p-20));
    thr_hi = static_cast<float>(iou_threshold * (1.0 + 0x1p-20));
  }
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
// `row_state` as tpudet_nms_scan left them) in tiles of `tile` (<= 1024)
// positions, appending to `sel` and `valid`; `continued` (one int32) counts
// the rows continued.
extern "C" int tpudet_nms_continue(const float* scores, const float* boxes,
                                   int64_t box_row_stride, const int* order,
                                   const int* num_select, const int* row_state,
                                   int rows, int n, int p_count, int tile, int max_out,
                                   float iou_threshold, int* sel, bool* valid,
                                   int* continued, void* stream) {
  if (p_count <= 0 || p_count >= n || tile <= 0 || tile > kSelectThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    nms_continue_kernel<<<rows, kSelectThreads, continue_smem(tile),
                          static_cast<cudaStream_t>(stream)>>>(
        scores, reinterpret_cast<const float4*>(boxes), box_row_stride / 4, order,
        num_select, row_state, n, p_count, tile, max_out, iou_threshold, sel, valid,
        continued);
  }
  return static_cast<int>(cudaGetLastError());
}

// A whole pool call in one entry, in stream order: the select, mask and scan
// kernels over each row's first p_count positions and, where p_count < n,
// the continuation in tiles of `tile`. `work` is [rows * (p_count + 3)]
// int32 scratch: the order, the live counts and the rows' state.
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
