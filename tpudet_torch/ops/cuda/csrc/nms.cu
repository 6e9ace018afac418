// Batched greedy non-max suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpudet/ops/pallas/nms_kernel.py:
//   _kernel_xb (rows advance in lockstep, reached through
//   batched_greedy_nms_pallas) and _kernel (one image per grid program).
// Both compute the same function; here it is one thread block per row.
//
// What it computes, per row b:
//   n_sel = min(num_select[b], max_out)
//   repeat: pick the highest live score (ties -> lowest index); stop at
//   k == n_sel or when the best score is <= -1e30/2; kill every box whose IoU
//   with the pick is strictly > iou_threshold, and always kill the pick itself
//   (a zero-area pair gives a NaN IoU, and NaN is not >); sel[b,k] = j,
//   valid[b,k] = 1. Unused slots hold 0 / 0.
//
// What bounds it on this card: neither bytes nor operations. A row reads its
// N scores and boxes once (20 B a candidate) and does ~20 flops a candidate
// for each pick; at the decode pool (20 x 512, <= 20 picks) that is ~0.2 MB
// and a few MFLOP, well under a microsecond of the card's memory rate or
// float32 rate. What costs is the chain of dependent picks: each pick needs a
// block-wide argmax (warp shuffles, then shared memory, two __syncthreads)
// before the next suppression pass can start.
//
// What the design does about it:
//   * one block per row, so rows never wait on each other (the TPU kernel
//     moved all rows in lockstep through one program);
//   * the suppression pass of pick k and the argmax scan for pick k+1 are one
//     loop over the row: each thread owns the elements i = tid (mod blockDim),
//     kills its own elements and keeps its own running best, so the only
//     synchronisation per pick is the block reduction;
//   * dead candidates are skipped, so later picks scan live work only;
//   * scores live in a per-row scratch row in device memory (the caller's
//     torch.empty), so N is not limited by shared memory: 512 for the decode
//     pool, 8828 at SSD300 full width, ~57k for RetinaNet.
//
// Bit-exactness with the plain PyTorch version: build with -fmad=false (no
// contraction of `area + barea - inter` into an FMA), never --use_fast_math,
// IEEE division. min/max propagate NaN like torch.minimum/maximum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNegHalf = -5e29f;  // -1e30 / 2: at or below this, no candidate
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

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
  for (int i = tid; i < n; i += kThreads) {
    const float v = s_in[i];
    s[i] = v;
    take_better(bs, bi, v, i);
  }

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
      const float ih = nan_max(nan_min(y2, by2) - nan_max(y1, by1), 0.0f);
      const float iw = nan_max(nan_min(x2, bx2) - nan_max(x1, bx1), 0.0f);
      const float inter = ih * iw;
      const float area = (y2 - y1) * (x2 - x1);
      const float iou = inter / (area + barea - inter);
      if (iou > iou_threshold || i == j) {
        s[i] = kNeg;
        continue;
      }
      take_better(bs, bi, v, i);
    }
  }
}

}  // namespace

// C entry for ctypes. Pointers are device pointers; `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
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
