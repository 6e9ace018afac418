// Batched anchor assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tpudet/ops/pallas/assign_kernel.py:
//   _kernel (one grid program per image, reached through
//   assign_anchors_pallas from ops/matching.py::assign_batch).
//
// What it computes, per image b, over G gt rows and A anchors:
//   iou[g,a] = inter / max(g_area + a_area - inter, 1e-12), with
//     inter = max(min(y2) - max(y1), 0) * max(min(x2) - max(x1), 0),
//   forced to 0 on invalid gt rows; then
//   best_anchor[b,g] = argmax_a iou[g,a]       (ties -> lowest a)
//   best_iou[b,a]    = max over valid g, or -1 (no valid gt)
//   rg[b,a]          = argmax of the same      (ties -> lowest g)
//   best_set[b,a]    = some valid g has best_anchor[b,g] == a.
// Anchors are shared ([A,2], row stride 0) or per image ([B,A,2]).
//
// What bounds it on this card: neither bytes nor operations. At SSD300's
// training shape (B 32, G 60, A 8828) it reads ~0.2 MB and writes ~2.5 MB
// (~0.8 us of the card's memory rate) and computes ~15 float32 operations
// for each (valid gt, anchor) pair (~1.5M pairs for 1-10 objects an image,
// well under a microsecond of the float32 rate). What costs is latency: the
// chain of one block (loads, the walk over the valid gts, the cross-block
// argmax's atomics and the count of arrivals), and the launch.
//
// The design, one launch and no memset:
//   * one thread per (image, 4 anchors), grid (ceil(A/1024), B): 9 blocks an
//     image at SSD300's 8828 anchors, and at most 64 registers a thread so 4
//     blocks fit an SM: the whole batch is one wave on the card, and each gt
//     key sees 9 atomics an image. Each thread keeps its anchors in
//     registers and a running (max, argmax) over g per anchor with a strict
//     '>', which gives best_iou and rg with ties to the lowest g;
//   * the image's gts are staged in shared memory in chunks of 64, with a
//     64-bit mask of the valid ones; the block walks the set bits only (an
//     invalid gt can neither raise best_iou above -1 nor claim an anchor);
//   * a pair that does not intersect takes its zero as the IoU without the
//     division (most pairs at SSD300's shapes; the quotient would be that
//     zero, sign and all, since the union is > 0);
//   * best_anchor: for each valid g, the 64-bit key
//     (float_bits(iou) << 32) | (0xFFFFFFFF - a), maxed over a thread's
//     anchors, then over the warp by two redux.sync (the high word, then the
//     low word among the lanes that hold that high word), then over the
//     block in shared memory, then one atomicMax per block and g. IoU >= 0,
//     so the bits order like the values, and the larger key among equal IoUs
//     is the lower anchor index;
//   * the threads that issued atomics fence them, and the block counts itself
//     in the image's arrival counter; the last block of the image writes the
//     image's best_set (false, then true at each valid gt's decoded key),
//     writes best_anchor, and sets the keys and the counter back to 0. The
//     keys and counters are the caller's scratch, zero before and after
//     every call, so calls that share it must run on one stream.
//
// Bit-exactness with the plain PyTorch version (ops/matching.py::assign_plain):
// build with -fmad=false (no contraction of g_area + a_area - inter), never
// --use_fast_math, IEEE division; the operations run in the plain version's
// order. Inputs must be finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kAnchorsPerBlock = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr int kGChunk = 64;  // the bits of one valid mask
static_assert(kGChunk == 64 && kThreads >= kGChunk, "one gt a thread, 64 a mask");
constexpr float kUnionMin = 1e-12f;

__device__ __forceinline__ unsigned long long argmax_key(float iou, int a) {
  // -0.0 would have the sign bit set: fold it into +0.0 so bits order like values
  const float v = iou == 0.0f ? 0.0f : iou;
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(a));
}

__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long key) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(key >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(kThreads, 4)
assign_kernel(const float* __restrict__ gt_y1x1, const float* __restrict__ gt_y2x2,
              const bool* __restrict__ gt_valid, const float* __restrict__ a_y1x1,
              const float* __restrict__ a_y2x2, int64_t anchor_row_stride,
              int g_count, int a_count, unsigned long long* __restrict__ keys,
              unsigned int* __restrict__ arrivals, int* __restrict__ best_anchor,
              float* __restrict__ best_iou, int* __restrict__ rg,
              bool* __restrict__ best_set) {
  __shared__ float s_y1[kGChunk], s_x1[kGChunk], s_y2[kGChunk], s_x2[kGChunk];
  __shared__ float s_area[kGChunk];
  __shared__ unsigned s_valid[kGChunk / 32];  // bit i: gt g0 + i is valid
  __shared__ unsigned long long s_keys[kWarps][kGChunk];
  __shared__ bool s_last;

  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kAnchorsPerBlock + threadIdx.x;  // then + j * kThreads
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ay1[kPerThread], ax1[kPerThread], ay2[kPerThread], ax2[kPerThread];
  float a_area[kPerThread], run_iou[kPerThread];
  int run_g[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int a = a0 + j * kThreads;
    ay1[j] = ax1[j] = ay2[j] = ax2[j] = a_area[j] = 0.0f;
    run_iou[j] = -1.0f;
    run_g[j] = 0;
    if (a < a_count) {
      const float* p1 = a_y1x1 + b * anchor_row_stride + 2 * (int64_t)a;
      const float* p2 = a_y2x2 + b * anchor_row_stride + 2 * (int64_t)a;
      ay1[j] = p1[0];
      ax1[j] = p1[1];
      ay2[j] = p2[0];
      ax2[j] = p2[1];
      a_area[j] = (ay2[j] - ay1[j]) * (ax2[j] - ax1[j]);
    }
  }
  const float* g1 = gt_y1x1 + (int64_t)b * g_count * 2;
  const float* g2 = gt_y2x2 + (int64_t)b * g_count * 2;
  const bool* gv = gt_valid + (int64_t)b * g_count;
  unsigned long long* key_row = keys + (int64_t)b * g_count;

  for (int g0 = 0; g0 < g_count; g0 += kGChunk) {
    const int n = min(kGChunk, g_count - g0);
    __syncthreads();  // the previous chunk's readers are done with shared memory
    if (threadIdx.x < kGChunk) {  // kGChunk <= kThreads: one gt a thread
      const int i = threadIdx.x;
      bool ok = false;
      if (i < n) {
        const float y1 = g1[2 * (g0 + i)], x1 = g1[2 * (g0 + i) + 1];
        const float y2 = g2[2 * (g0 + i)], x2 = g2[2 * (g0 + i) + 1];
        s_y1[i] = y1;
        s_x1[i] = x1;
        s_y2[i] = y2;
        s_x2[i] = x2;
        s_area[i] = (y2 - y1) * (x2 - x1);
        ok = gv[g0 + i];
      }
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) s_valid[warp] = bits;
    }
    __syncthreads();
    const unsigned long long valid_bits =
        (static_cast<unsigned long long>(s_valid[1]) << 32) | s_valid[0];
    for (unsigned long long left = valid_bits; left != 0ull; left &= left - 1ull) {
      const int i = __ffsll(static_cast<long long>(left)) - 1;  // block-uniform
      const float gy1 = s_y1[i], gx1 = s_x1[i], gy2 = s_y2[i], gx2 = s_x2[i];
      const float g_area = s_area[i];
      unsigned long long key = 0ull;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int a = a0 + j * kThreads;
        const float ih = fmaxf(fminf(gy2, ay2[j]) - fmaxf(gy1, ay1[j]), 0.0f);
        const float iw = fmaxf(fminf(gx2, ax2[j]) - fmaxf(gx1, ax1[j]), 0.0f);
        const float inter = ih * iw;
        const float uni = fmaxf(g_area + a_area[j] - inter, kUnionMin);
        // uni > 0, so a zero intersection's quotient is that zero, sign and
        // all; most pairs do not intersect, and the division is skipped
        const float iou = inter == 0.0f ? inter : inter / uni;
        if (a < a_count) {
          if (iou > run_iou[j]) {
            run_iou[j] = iou;
            run_g[j] = g0 + i;
          }
          const unsigned long long k = argmax_key(iou, a);
          key = k > key ? k : key;
        }
      }
      key = warp_max_key(key);
      if (lane == 0) s_keys[warp][i] = key;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (!((valid_bits >> i) & 1ull)) continue;
      unsigned long long k = s_keys[0][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) k = s_keys[w][i] > k ? s_keys[w][i] : k;
      atomicMax(key_row + g0 + i, k);
      __threadfence();  // the key is in place before this block counts itself
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int a = a0 + j * kThreads;
    if (a < a_count) {
      const int64_t o = (int64_t)b * a_count + a;
      best_iou[o] = run_iou[j];
      rg[o] = run_g[j];
    }
  }

  // the last block of the image to arrive writes best_set and best_anchor
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrivals + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  bool* set_row = best_set + (int64_t)b * a_count;
  for (int a = threadIdx.x; a < a_count; a += kThreads) set_row[a] = false;
  __syncthreads();
  // an invalid gt row scores 0 everywhere, so its argmax is 0
  for (int g = threadIdx.x; g < g_count; g += kThreads) {
    int ba = 0;
    if (gv[g]) {
      const unsigned long long k = atomicExch(key_row + g, 0ull);
      ba = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k & 0xFFFFFFFFull));
      set_row[ba] = true;
    }
    best_anchor[(int64_t)b * g_count + g] = ba;
  }
  if (threadIdx.x == 0) atomicExch(arrivals + b, 0u);
}

}  // namespace

// C entry for ctypes. Pointers are device pointers; `stream` is a cudaStream_t;
// `keys` ([batch, g_count], 8 bytes each) and `arrivals` ([batch], 4 bytes
// each) are scratch that must be zero, and are zero again when the launch
// ends. One launch; returns cudaGetLastError() after it (0 when accepted).
extern "C" int tpudet_assign(const float* gt_y1x1, const float* gt_y2x2,
                             const bool* gt_valid, const float* a_y1x1,
                             const float* a_y2x2, int64_t anchor_row_stride,
                             int batch, int g_count, int a_count,
                             unsigned long long* keys, unsigned int* arrivals,
                             int* best_anchor, float* best_iou, int* rg,
                             bool* best_set, void* stream) {
  if (batch <= 0 || a_count <= 0) return 0;
  const dim3 grid((a_count + kAnchorsPerBlock - 1) / kAnchorsPerBlock, batch);
  assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gt_y1x1, gt_y2x2, gt_valid, a_y1x1, a_y2x2, anchor_row_stride, g_count,
      a_count, keys, arrivals, best_anchor, best_iou, rg, best_set);
  return static_cast<int>(cudaGetLastError());
}
