// Row helpers shared by the row-pass kernels (flash_core_fwd.cu,
// flash_core_bwd.cu): a row of C fp32 channels split
// across a pair of lanes. Lane `half` of the pair owns float4 groups
// 2m + half, i.e. channels 8m + 4*half + e (m < C/8, e < 4), so each lane
// keeps C/2 floats of a row in registers and the two partial dot products
// meet through one warp shuffle. Register arrays are indexed only by
// constants.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lane_pair {

template <int C>
__device__ __forceinline__ void load_half(const float* __restrict__ src, int half,
                                          float (&x)[C / 2]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    const float4 t = __ldg(s4 + 2 * m + half);
    x[4 * m] = t.x;
    x[4 * m + 1] = t.y;
    x[4 * m + 2] = t.z;
    x[4 * m + 3] = t.w;
  }
}

template <int C>
__device__ __forceinline__ void store_half(float* __restrict__ dst, int half,
                                           const float (&x)[C / 2]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    d4[2 * m + half] = make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
  }
}

// partial dot product of this lane's half with the matching half of a row
// in shared memory
template <int C>
__device__ __forceinline__ float dot_half(const float (&x)[C / 2], const float* __restrict__ row,
                                          int half) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float d = 0.f;
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    const float4 t = r4[2 * m + half];
    d = fmaf(x[4 * m], t.x, d);
    d = fmaf(x[4 * m + 1], t.y, d);
    d = fmaf(x[4 * m + 2], t.z, d);
    d = fmaf(x[4 * m + 3], t.w, d);
  }
  return d;
}

// the full dot product of a lane pair's two halves, on both lanes (every
// lane of the warp must call it)
template <int C>
__device__ __forceinline__ float dot_pair(const float (&x)[C / 2], const float* __restrict__ row,
                                          int half) {
  const float d = dot_half<C>(x, row, half);
  return d + __shfl_xor_sync(0xffffffffu, d, 1);
}

// y += a * (this lane's half of a shared-memory row)
template <int C>
__device__ __forceinline__ void axpy_half(float a, const float* __restrict__ row, int half,
                                          float (&y)[C / 2]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    const float4 t = r4[2 * m + half];
    y[4 * m] = fmaf(a, t.x, y[4 * m]);
    y[4 * m + 1] = fmaf(a, t.y, y[4 * m + 1]);
    y[4 * m + 2] = fmaf(a, t.z, y[4 * m + 2]);
    y[4 * m + 3] = fmaf(a, t.w, y[4 * m + 3]);
  }
}

// copy `n` rows of C floats (row r at base + r * rs) into a [TILE, C] tile in
// shared memory, zero past n; every thread of a THREADS-thread block calls it
template <int C, int TILE, int THREADS>
__device__ __forceinline__ void stage_tile(float* __restrict__ tile, const float* __restrict__ base,
                                           int64_t rs, int n) {
  for (int idx = threadIdx.x; idx < TILE * C / 4; idx += THREADS) {
    const int r = idx / (C / 4);
    const int c4 = idx % (C / 4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) t = __ldg(reinterpret_cast<const float4*>(base + r * rs) + c4);
    reinterpret_cast<float4*>(tile)[idx] = t;
  }
}

}  // namespace lane_pair
