// Probes of the tensor-core path of csrc/tf32x3.cuh on the card; on no
// model path (gta_tpu_torch/scripts/probe_tf32x3.py drives them).
//
//  * tf32x3_probe_rate: every warp chains mma.sync m16n8k8 .tf32 into 8
//    independent accumulators `iters` times: the instruction's throughput,
//    the ceiling of every kernel built on it.
//  * tf32x3_probe_chain: one warp per 16 x 8 output tile accumulates
//    `steps` products A_s B_s (m16n8k8, single TF32 pass, operands already
//    TF32-exact so that every product is exact) in one tensor-core chain
//    (`tile` = 0) or in chains of `tile` steps added with fp32
//    round-to-nearest adds: how far the tensor cores' fp32 accumulation
//    drifts from the exact sum with the chain's length.
//
// Interface: plain C, bound from Python with ctypes; returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

__global__ void rate_kernel(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {to_tf32(1.f), to_tf32(0.5f), to_tf32(0.25f), to_tf32(2.f)};
  const uint32_t b[2] = {to_tf32(1e-3f), to_tf32(-1e-3f)};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32(d[n], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// A: [steps][16][8], B: [steps][8][8] (row-major, k inner), D: [tiles][16][8]
__global__ void chain_kernel(const float* A, const float* B, float* D, int steps, int tile) {
  const Lane l = lane_coords();
  const float* a_base = A + (int64_t)blockIdx.x * steps * 128;
  const float* b_base = B + (int64_t)blockIdx.x * steps * 64;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    float af[4], bf[2];
    load_a(af, a_base + s * 128, 8, 0, l);
    load_b_kn_std(bf, b_base + s * 64, 8, 0, 0, l);
    const uint32_t au[4] = {__float_as_uint(af[0]), __float_as_uint(af[1]),
                            __float_as_uint(af[2]), __float_as_uint(af[3])};
    const uint32_t bu[2] = {__float_as_uint(bf[0]), __float_as_uint(bf[1])};
    mma_tf32(t, au, bu);
    if (tile > 0 && (s + 1) % tile == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] += t[e];
        t[e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
  float* d = D + (int64_t)blockIdx.x * 128;
  d[l.g * 8 + 2 * l.t] = acc[0];
  d[l.g * 8 + 2 * l.t + 1] = acc[1];
  d[(l.g + 8) * 8 + 2 * l.t] = acc[2];
  d[(l.g + 8) * 8 + 2 * l.t + 1] = acc[3];
}

}  // namespace

extern "C" int tf32x3_probe_rate(float* out, int blocks, int threads, int iters, void* stream) {
  rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int tf32x3_probe_chain(const float* A, const float* B, float* D, int tiles, int steps,
                                  int tile, void* stream) {
  chain_kernel<<<tiles, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B, D, steps, tile);
  return (int)cudaGetLastError();
}
