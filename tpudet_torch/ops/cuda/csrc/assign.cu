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
// well under a microsecond of the float32 rate). What costs is the
// cross-block argmax of best_anchor and the two launches.
//
// The design, kept simple:
//   * one thread per (image, anchor), grid (ceil(A/256), B); each thread
//     keeps its anchor in registers and a running (max, argmax) over g with a
//     strict '>', which gives best_iou and rg with ties to the lowest g;
//   * the image's gts are staged in shared memory in chunks of 64; a gt row
//     that is not valid is skipped by the whole block (it can neither raise
//     best_iou above -1 nor claim an anchor);
//   * best_anchor: for each valid g, a warp reduction of the 64-bit key
//     (float_bits(iou) << 32) | (0xFFFFFFFF - a), then one atomicMax per
//     block and g. IoU >= 0, so the bits order like the values, and the
//     larger key among equal IoUs is the lower anchor index;
//   * a second, small launch decodes the keys and scatters best_set.
//
// Bit-exactness with the plain PyTorch version (ops/matching.py::assign_plain):
// build with -fmad=false (no contraction of g_area + a_area - inter), never
// --use_fast_math, IEEE division; the operations run in the plain version's
// order. Inputs must be finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGChunk = 64;
constexpr float kUnionMin = 1e-12f;

__device__ __forceinline__ unsigned long long argmax_key(float iou, int a) {
  // -0.0 would have the sign bit set: fold it into +0.0 so bits order like values
  const float v = iou == 0.0f ? 0.0f : iou;
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - static_cast<unsigned>(a));
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ gt_y1x1, const float* __restrict__ gt_y2x2,
              const bool* __restrict__ gt_valid, const float* __restrict__ a_y1x1,
              const float* __restrict__ a_y2x2, int64_t anchor_row_stride,
              int g_count, int a_count, unsigned long long* __restrict__ keys,
              float* __restrict__ best_iou, int* __restrict__ rg,
              bool* __restrict__ best_set) {
  __shared__ float s_y1[kGChunk], s_x1[kGChunk], s_y2[kGChunk], s_x2[kGChunk];
  __shared__ float s_area[kGChunk];
  __shared__ int s_valid[kGChunk];
  __shared__ unsigned long long s_keys[kWarps][kGChunk];

  const int b = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const bool live = a < a_count;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ay1 = 0.0f, ax1 = 0.0f, ay2 = 0.0f, ax2 = 0.0f, a_area = 0.0f;
  if (live) {
    const float* p1 = a_y1x1 + b * anchor_row_stride + 2 * (int64_t)a;
    const float* p2 = a_y2x2 + b * anchor_row_stride + 2 * (int64_t)a;
    ay1 = p1[0];
    ax1 = p1[1];
    ay2 = p2[0];
    ax2 = p2[1];
    a_area = (ay2 - ay1) * (ax2 - ax1);
  }
  const float* g1 = gt_y1x1 + (int64_t)b * g_count * 2;
  const float* g2 = gt_y2x2 + (int64_t)b * g_count * 2;
  const bool* gv = gt_valid + (int64_t)b * g_count;
  unsigned long long* key_row = keys + (int64_t)b * g_count;

  float run_iou = -1.0f;
  int run_g = 0;
  for (int g0 = 0; g0 < g_count; g0 += kGChunk) {
    const int n = min(kGChunk, g_count - g0);
    __syncthreads();  // the previous chunk's readers are done with shared memory
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float y1 = g1[2 * (g0 + i)], x1 = g1[2 * (g0 + i) + 1];
      const float y2 = g2[2 * (g0 + i)], x2 = g2[2 * (g0 + i) + 1];
      s_y1[i] = y1;
      s_x1[i] = x1;
      s_y2[i] = y2;
      s_x2[i] = x2;
      s_area[i] = (y2 - y1) * (x2 - x1);
      s_valid[i] = gv[g0 + i] ? 1 : 0;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (!s_valid[i]) continue;  // block-uniform
      const float ih = fmaxf(fminf(s_y2[i], ay2) - fmaxf(s_y1[i], ay1), 0.0f);
      const float iw = fmaxf(fminf(s_x2[i], ax2) - fmaxf(s_x1[i], ax1), 0.0f);
      const float inter = ih * iw;
      const float uni = fmaxf(s_area[i] + a_area - inter, kUnionMin);
      const float iou = inter / uni;
      unsigned long long key = 0ull;
      if (live) {
        if (iou > run_iou) {
          run_iou = iou;
          run_g = g0 + i;
        }
        key = argmax_key(iou, a);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
      }
      if (lane == 0) s_keys[warp][i] = key;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (!s_valid[i]) continue;
      unsigned long long k = s_keys[0][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) k = s_keys[w][i] > k ? s_keys[w][i] : k;
      atomicMax(key_row + g0 + i, k);
    }
  }
  if (live) {
    const int64_t o = (int64_t)b * a_count + a;
    best_iou[o] = run_iou;
    rg[o] = run_g;
    best_set[o] = false;
  }
}

// One block per image: decode each valid gt's key into its anchor and mark it
// in best_set; an invalid gt row scores 0 everywhere, so its argmax is 0.
__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              const bool* __restrict__ gt_valid, int g_count,
                              int a_count, int* __restrict__ best_anchor,
                              bool* __restrict__ best_set) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < g_count; g += blockDim.x) {
    const int64_t o = (int64_t)b * g_count + g;
    int ba = 0;
    if (gt_valid[o]) {
      ba = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(keys[o] & 0xFFFFFFFFull));
      best_set[(int64_t)b * a_count + ba] = true;
    }
    best_anchor[o] = ba;
  }
}

}  // namespace

// C entry for ctypes. Pointers are device pointers; `stream` is a cudaStream_t;
// `keys` is [batch, g_count] scratch of 8 bytes each. Zeroes the keys, then
// runs both launches on the stream. Returns the first CUDA error (0 if none).
extern "C" int tpudet_assign(const float* gt_y1x1, const float* gt_y2x2,
                             const bool* gt_valid, const float* a_y1x1,
                             const float* a_y2x2, int64_t anchor_row_stride,
                             int batch, int g_count, int a_count,
                             unsigned long long* keys, int* best_anchor,
                             float* best_iou, int* rg, bool* best_set,
                             void* stream) {
  if (batch <= 0 || a_count <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      keys, 0, sizeof(unsigned long long) * (size_t)batch * (size_t)g_count, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a_count + kThreads - 1) / kThreads, batch);
  assign_kernel<<<grid, kThreads, 0, s>>>(gt_y1x1, gt_y2x2, gt_valid, a_y1x1,
                                          a_y2x2, anchor_row_stride, g_count,
                                          a_count, keys, best_iou, rg, best_set);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_count > 0) {
    decode_kernel<<<batch, 64, 0, s>>>(keys, gt_valid, g_count, a_count,
                                       best_anchor, best_set);
  }
  return static_cast<int>(cudaGetLastError());
}
