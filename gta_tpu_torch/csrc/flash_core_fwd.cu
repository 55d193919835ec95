// Plain softmax attention forward for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces gta_tpu/ops/flash_core.py:73 `_fwd_kernel` (the Pallas TPU
// kernel launched by `_fwd_call` :129). Per (batch b, head h):
//
//   out = softmax(q k^T * scale) v        (keys past Tk take no weight)
//   lse = log(sum_k exp(q k^T * scale))   (only when asked, for training)
//
// over token-major operands: q/out [B, Tq, H*C], k/v [B, Tk, H*C], head h in
// channels [h*C, (h+1)*C) of each row; lse [B, H, Tq].
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) against
// (2*Tq + 2*Tk)*C*4 bytes of q, k, v and out. At the SRT shapes (C = 64,
// Tk = 600, Tq = 600 to 16384) that is 100 to 300 flops per byte, far above
// the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20: bound by arithmetic, and
// the fp32 precision policy keeps it on the CUDA cores.
//
// What the design does about it:
//  * The Pallas kernel holds a head's whole K/V in VMEM and takes one
//    softmax pass. Here K/V stream through shared memory in tiles of 32
//    keys with an online softmax (running max and sum, the accumulator
//    rescaled when the max grows), so there is no limit on Tk and a block
//    needs 16 KB of shared memory.
//  * A query row belongs to a pair of lanes (lane_pair.cuh), each holding 32
//    of its 64 channels of q and of the output accumulator:
//    two vectors of 32 floats and the tile's 32 scores in registers, where
//    one row per thread would need 255 registers. The two
//    partial dot products meet through one warp shuffle, after which both
//    lanes hold the same score and compute the same softmax weights.
//  * Both lanes read K/V rows from shared memory as float4 broadcasts: the
//    16 pairs of a warp read the same two 16-byte words, so one shared load
//    feeds four FMAs per lane.
//  * No operand is padded: rows past Tq compute on the last row and store
//    nothing, keys past Tk are zero-filled in the tile and get -inf scores.
// Not yet: tensor-core (wgmma) products, TMA loads, bf16/TF32 operands.
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array; lse may be null. Returns the cudaError_t of
// the launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_pair.cuh"

namespace {

using namespace lane_pair;

constexpr int HEAD_DIM = 64;     // the only head width compiled in
constexpr int ROWS = 128;        // query rows per block
constexpr int THREADS = 2 * ROWS;
constexpr int TILE = 32;         // keys per shared-memory tile

// grid (ceil(Tq/ROWS), H, B); a lane pair per query row
template <int C>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int H, int Tq, int Tk, float scale) {
  constexpr int HALF = C / 2;
  __shared__ __align__(16) float Ks[TILE * C];
  __shared__ __align__(16) float Vs[TILE * C];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
  const bool active = row < Tq;
  const int r = active ? row : Tq - 1;  // rows past Tq compute on the last row, store nothing
  const int64_t D = (int64_t)H * C;
  const int64_t tok = ((int64_t)b * Tq + r) * D + (int64_t)h * C;

  float qr[HALF], acc[HALF];
  load_half<C>(q + tok, half, qr);
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const float* kbase = k + (int64_t)b * Tk * D + (int64_t)h * C;
  const float* vbase = v + (int64_t)b * Tk * D + (int64_t)h * C;

  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    const int n = min(TILE, Tk - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<C, TILE, THREADS>(Ks, kbase + k0 * D, D, n);
    stage_tile<C, TILE, THREADS>(Vs, vbase + k0 * D, D, n);
    __syncthreads();
    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float d = dot_pair<C>(qr, Ks + j * C, half);
      s[j] = j < n ? d * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // online softmax: rescale the running sum and accumulator to the new
    // max (every tile holds at least one key, so mnew is finite)
    const float mnew = fmaxf(m, tmax);
    const float alpha = expf(m - mnew);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - mnew);
      l += p;
      axpy_half<C>(p, Vs + j * C, half, acc);
    }
    m = mnew;
  }

  if (!active) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] *= inv;
  store_half<C>(out + tok, half, acc);
  if (lse != nullptr && !half) lse[((int64_t)b * H + h) * Tq + row] = m + logf(l);
}

}  // namespace

extern "C" int flash_core_fwd(const float* q, const float* k, const float* v, float* out,
                              float* lse, int B, int H, int Tq, int Tk, int C, float scale,
                              void* stream_ptr) {
  if (C != HEAD_DIM || B < 1 || H < 1 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((Tq + ROWS - 1) / ROWS, H, B);
  flash_fwd_kernel<HEAD_DIM><<<grid, THREADS, 0, stream>>>(q, k, v, out, lse, H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_core_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
