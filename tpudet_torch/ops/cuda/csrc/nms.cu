// Batched greedy non-max suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpudet/ops/pallas/nms_kernel.py:
//   _kernel_xb (rows advance in lockstep, reached through
//   batched_greedy_nms_pallas) and _kernel (one image per grid program).
// Both compute the same function, here in two designs chosen by row width.
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
// What bounds it on this card: neither bytes nor operations. A row reads its
// candidates' scores and boxes once (20 B a candidate) and does ~20 flops a
// candidate for each pick; at the mining pool (32 x 768, ~320 picks a row)
// that is ~0.1 MB and ~85 MFLOP, about a microsecond of the card's float32
// rate. What costs is the chain of dependent picks.
//
// 1. The sorted bitmask scan (rows up to kSortedMaxWidth = 1024 candidates,
//    every pool of the SSD path). Greedy NMS with ties to the lowest index is
//    the same as walking the row in stable descending score order and taking
//    each candidate that no earlier pick has killed. The caller gives that
//    order ([B, P] int32 positions into the full-width row), so:
//    * nms_mask_kernel: the whole card computes mask[b, p, w], a 64-bit word
//      whose bit t is IoU(c_p, c_{64w+t}) > thr for 64w+t > p (c_p = the
//      candidate at sorted position p). One 64-thread block per row and
//      upper-triangle 64x64 tile (32 x 78 blocks at the mining pool), the
//      tile's column boxes in shared memory as float4. One triangle suffices:
//      a pick can only kill later positions, and each bit is the plain
//      version's IoU of the later candidate against the earlier pick (it is
//      symmetric bit for bit in any case). Between two proper boxes (see
//      box_is_proper) two products decide a pair far from the threshold; the
//      64 columns are one branch-free unrolled pass that yields the hits and
//      the pairs it could not decide, and only those go through iou_above
//      and its division. A position's words are padded to an even count, so
//      every row of the mask is 16-byte aligned;
//    * nms_scan_kernel: one block per row copies the row's mask into shared
//      memory with cp.async while it finds the live prefix of the order, then
//      one warp walks it as 32-bit words, one a lane (the 64-bit word w is
//      the 32-bit words 2w and 2w+1): __ffs finds the next live candidate,
//      and a pick clears its mask row out of the live bits of the current
//      word (one shared-memory load and one three-input logic op on the
//      chain) and ORs it into the removed words of the lanes ahead. So the
//      cost follows the picks, not the candidates. A NaN score sorts first
//      and a dead score (<= -1e30/2) sorts last, so the scan stops at the
//      first position whose score is not > -1e30/2.
// 2. One block per row for wider rows (the pool's full-width rerun, later
//    RetinaNet's ~57k-wide decode): nms_rows_kernel fuses the suppression
//    pass of pick k with the argmax scan for pick k+1, with one block-wide
//    argmax per pick, and keeps the row's scores in a scratch row in device
//    memory, so the width is not limited by shared memory. A block-wide
//    "any NaN" flag from the first scan ends a NaN row before pick 0.
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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegHalf = -5e29f;  // -1e30 / 2: at or below this, no candidate
constexpr float kNeg = -1e30f;

constexpr int kSortedMaxWidth = 1024;  // 32 words of 32 bits: one a lane of the scan warp
constexpr int kMaxWords = kSortedMaxWidth / 64;
constexpr int kTile = 64;
constexpr int kScanThreads = 512;
constexpr size_t kScanMaxSmem = sizeof(unsigned long long) * kSortedMaxWidth * kMaxWords +
                                2 * sizeof(int) * kSortedMaxWidth;

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
    const float area = (v.z - v.x) * (v.w - v.y);
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
  const float barea = (pb.z - pb.x) * (pb.w - pb.y);
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
                int max_out, int* __restrict__ sel,
                bool* __restrict__ valid) {
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
}

// ------------------------------------------------------- one block per row
// (score desc, index asc)
__device__ __forceinline__ void take_better(float& bs, int& bi, float s, int i) {
  if (s > bs || (s == bs && i < bi)) {
    bs = s;
    bi = i;
  }
}

// Block-wide argmax of every thread's (bs, bi); every thread gets the result.
__device__ __forceinline__ void block_argmax(float& bs, int& bi, float* red_s,
                                             int* red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_down_sync(0xffffffffu, bs, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bs, bi, os, oi);
  }
  if (lane == 0) {
    red_s[warp] = bs;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bs = lane < kWarps ? red_s[lane] : -INFINITY;
    bi = lane < kWarps ? red_i[lane] : INT32_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, bs, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      take_better(bs, bi, os, oi);
    }
    if (lane == 0) {
      red_s[kWarps] = bs;
      red_i[kWarps] = bi;
    }
  }
  __syncthreads();
  bs = red_s[kWarps];
  bi = red_i[kWarps];
}

__global__ void __launch_bounds__(kThreads)
nms_rows_kernel(const float* __restrict__ scores, float* __restrict__ work,
                const float* __restrict__ boxes, int64_t box_row_stride,
                const int* __restrict__ num_select, int n, int max_out,
                float iou_threshold, int* __restrict__ sel,
                bool* __restrict__ valid) {
  __shared__ float red_s[kWarps + 1];
  __shared__ int red_i[kWarps + 1];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* s_in = scores + (int64_t)row * n;
  float* s = work + (int64_t)row * n;
  const float* bx = boxes + (int64_t)row * box_row_stride;
  int* sel_row = sel + (int64_t)row * max_out;
  bool* val_row = valid + (int64_t)row * max_out;
  const int n_sel = min(num_select[row], max_out);

  for (int k = tid; k < max_out; k += kThreads) {
    sel_row[k] = 0;
    val_row[k] = false;
  }

  float bs = -INFINITY;
  int bi = INT32_MAX;
  int has_nan = 0;
  for (int i = tid; i < n; i += kThreads) {
    const float v = s_in[i];
    s[i] = v;
    has_nan |= v != v;
    take_better(bs, bi, v, i);
  }
  if (__syncthreads_or(has_nan)) return;  // the row's max is NaN: no pick

  for (int k = 0; k < n_sel; ++k) {
    block_argmax(bs, bi, red_s, red_i);
    const float best = bs;
    const int j = bi;
    if (!(best > kNegHalf)) break;  // block-uniform: no live candidate left
    if (tid == 0) {
      sel_row[k] = j;
      val_row[k] = true;
    }
    const float by1 = bx[4 * (int64_t)j + 0];
    const float bx1 = bx[4 * (int64_t)j + 1];
    const float by2 = bx[4 * (int64_t)j + 2];
    const float bx2 = bx[4 * (int64_t)j + 3];
    const float barea = (by2 - by1) * (bx2 - bx1);

    bs = -INFINITY;
    bi = INT32_MAX;
    for (int i = tid; i < n; i += kThreads) {
      float v = s[i];
      if (!(v > kNegHalf)) continue;  // dead: never picked again
      const float y1 = bx[4 * (int64_t)i + 0];
      const float x1 = bx[4 * (int64_t)i + 1];
      const float y2 = bx[4 * (int64_t)i + 2];
      const float x2 = bx[4 * (int64_t)i + 3];
      const float area = (y2 - y1) * (x2 - x1);
      if (i == j || iou_above(y1, x1, y2, x2, area, by1, bx1, by2, bx2, barea,
                              iou_threshold)) {
        s[i] = kNeg;
        continue;
      }
      take_better(bs, bi, v, i);
    }
  }
}

}  // namespace

// C entries for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launches (0 when
// they were accepted).

// One block per row; `work` is [rows, n] float32 scratch.
extern "C" int tpudet_nms_rows(const float* scores, float* work,
                               const float* boxes, int64_t box_row_stride,
                               const int* num_select, int rows, int n,
                               int max_out, float iou_threshold, int* sel,
                               bool* valid, void* stream) {
  if (rows > 0) {
    nms_rows_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        scores, work, boxes, box_row_stride, num_select, n, max_out,
        iou_threshold, sel, valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// The sorted bitmask scan over `order` ([rows, p_count] int32 positions into
// the rows of width n, each row's stable descending score order or a prefix
// of it); `mask` is [rows, p_count, stride] uint64 scratch, stride =
// ceil(p_count / 64) rounded up to even; `boxes` is 16-byte aligned.
extern "C" int tpudet_nms_sorted(const float* scores, const float* boxes,
                                 int64_t box_row_stride, const int* order,
                                 const int* num_select, int rows, int n,
                                 int p_count, int max_out, float iou_threshold,
                                 unsigned long long* mask, int* sel, bool* valid,
                                 void* stream) {
  if (p_count < 0 || p_count > kSortedMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (p_count + kTile - 1) / kTile;
  const int tiles = words * (words + 1) / 2;
  float thr_lo = -INFINITY, thr_hi = INFINITY;  // decide every pair by division
  if (iou_threshold >= 0x1p-20f && iou_threshold <= 0x1p20f) {
    thr_lo = static_cast<float>(iou_threshold * (1.0 - 0x1p-20));
    thr_hi = static_cast<float>(iou_threshold * (1.0 + 0x1p-20));
  }
  if (tiles > 0) {
    nms_mask_kernel<<<rows * tiles, kTile, 0, s>>>(
        scores, reinterpret_cast<const float4*>(boxes), box_row_stride / 4, order, n,
        p_count, words, tiles, iou_threshold, thr_lo, thr_hi, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kScanMaxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(unsigned long long) * (size_t)p_count * mask_stride(p_count) +
                      2 * sizeof(int) * (size_t)p_count;
  nms_scan_kernel<<<rows, kScanThreads, smem, s>>>(scores, order, num_select, mask,
                                                   n, p_count, max_out, sel,
                                                   valid);
  return static_cast<int>(cudaGetLastError());
}
