// Plain softmax attention backward for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces gta_tpu/ops/flash_core.py:86 `_bwd_kernel` (the Pallas TPU
// recompute backward launched by `_bwd_call` :150, the VJP of
// `flash_core`). Per (batch b, head h), with the forward's output o and
// per-row log-sum-exp lse (csrc/flash_core_fwd.cu) and the cotangent g of o:
//
//   p     = exp(q k^T * scale - lse)       dp = g v^T
//   delta = rowsum(g * o)                  (= the Pallas rowsum(p * dp), as o = p v)
//   ds    = p (dp - delta) * scale
//   dq    = ds k      dk = ds^T q      dv = p^T g
//
// over token-major operands: q/g/o/dq [B, Tq, H*C], k/v/dk/dv [B, Tk, H*C];
// lse and the scratch delta [B, H, Tq].
//
// What bounds it on the H100: 5 products of 2*Tq*Tk*C flops per (b, h)
// (s, dp, dq, dk, dv) against (4*Tq + 4*Tk)*C*4 bytes of q, k, v, g and the
// three gradients: far above the fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// flops per byte), so it is bound by arithmetic on the CUDA cores.
//
// What the design does about it:
//  * The Pallas kernel adds dk and dv into one block across a grid that
//    runs in order. Hopper's blocks run in parallel, so the work is split by
//    who owns each output row: a query pass (one query row per lane pair)
//    writes dq and delta, and a key pass (one key row per lane pair) loops
//    over every query of its (b, h) and writes dk and dv. No row is written
//    by two blocks: no atomics, and the sums are deterministic. Both passes
//    recompute s and dp from the forward's log-sum-exp: 7 products where
//    the function needs 5, the price of having no cross-block sums.
//  * A row's 64 channels are split between the two lanes of a pair
//    (lane_pair.cuh), so each lane keeps 3 (query pass: q, g, dq) or 4 (key
//    pass: k, v, dk, dv) vectors of 32 floats in registers; the other side's
//    rows are staged in shared memory in tiles of 32, read as float4
//    broadcasts.
//  * No operand is padded: rows past Tq or Tk compute on the last row and
//    store nothing; tile rows past the end are zero-filled and get p = 0.
// Not yet: tensor-core (wgmma) products, TMA loads, bf16/TF32 operands.
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array. Returns the cudaError_t of the launches
// (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_pair.cuh"

namespace {

using namespace lane_pair;

constexpr int HEAD_DIM = 64;  // the only head width compiled in
constexpr int ROWS = 64;      // rows per block in either pass
constexpr int THREADS = 2 * ROWS;
constexpr int TILE = 32;      // other-side rows per shared-memory tile

// Query pass: grid (ceil(Tq/ROWS), H, B). Writes dq and delta.
template <int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ o, const float* __restrict__ lse,
                   float* __restrict__ delta_s, float* __restrict__ dq, int H, int Tq, int Tk,
                   float scale) {
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
  const int64_t hrow = ((int64_t)b * H + h) * Tq + r;

  float qr[HALF], gr[HALF], dqr[HALF];
  load_half<C>(q + tok, half, qr);
  load_half<C>(g + tok, half, gr);
  float delta;
  {
    float orow[HALF];
    load_half<C>(o + tok, half, orow);
    float dl = 0.f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) dl = fmaf(gr[c], orow[c], dl);
    delta = dl + __shfl_xor_sync(0xffffffffu, dl, 1);
  }
  if (active && !half) delta_s[hrow] = delta;
  const float lse_r = lse[hrow];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dqr[c] = 0.f;

  const float* kbase = k + (int64_t)b * Tk * D + (int64_t)h * C;
  const float* vbase = v + (int64_t)b * Tk * D + (int64_t)h * C;
  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    const int n = min(TILE, Tk - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<C, TILE, THREADS>(Ks, kbase + k0 * D, D, n);
    stage_tile<C, TILE, THREADS>(Vs, vbase + k0 * D, D, n);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float s = dot_pair<C>(qr, Ks + j * C, half);
      const float dp = dot_pair<C>(gr, Vs + j * C, half);
      const float p = j < n ? expf(s * scale - lse_r) : 0.f;
      axpy_half<C>(p * (dp - delta) * scale, Ks + j * C, half, dqr);
    }
  }
  if (active) store_half<C>(dq + tok, half, dqr);
}

// Key pass: grid (ceil(Tk/ROWS), H, B), a lane pair per key row looping
// over every query of (b, h). Writes dk and dv.
template <int C>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta_s,
                    float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
                    float scale) {
  constexpr int HALF = C / 2;
  __shared__ __align__(16) float Qs[TILE * C];
  __shared__ __align__(16) float Gs[TILE * C];
  __shared__ float Ls[TILE];
  __shared__ float Dl[TILE];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
  const bool active = row < Tk;
  const int r = active ? row : Tk - 1;
  const int64_t D = (int64_t)H * C;
  const int64_t tok = ((int64_t)b * Tk + r) * D + (int64_t)h * C;

  float kr[HALF], vr[HALF], dkr[HALF], dvr[HALF];
  load_half<C>(k + tok, half, kr);
  load_half<C>(v + tok, half, vr);
#pragma unroll
  for (int c = 0; c < HALF; ++c) dkr[c] = dvr[c] = 0.f;

  const float* qbase = q + (int64_t)b * Tq * D + (int64_t)h * C;
  const float* gbase = g + (int64_t)b * Tq * D + (int64_t)h * C;
  const int64_t hbase = ((int64_t)b * H + h) * Tq;
  for (int q0 = 0; q0 < Tq; q0 += TILE) {
    const int n = min(TILE, Tq - q0);
    __syncthreads();
    stage_tile<C, TILE, THREADS>(Qs, qbase + q0 * D, D, n);
    stage_tile<C, TILE, THREADS>(Gs, gbase + q0 * D, D, n);
    if (threadIdx.x < TILE) {
      const bool in = (int)threadIdx.x < n;
      Ls[threadIdx.x] = in ? lse[hbase + q0 + threadIdx.x] : 0.f;
      Dl[threadIdx.x] = in ? delta_s[hbase + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float s = dot_pair<C>(kr, Qs + i * C, half);
      const float dp = dot_pair<C>(vr, Gs + i * C, half);
      const float p = i < n ? expf(s * scale - Ls[i]) : 0.f;
      axpy_half<C>(p * (dp - Dl[i]) * scale, Qs + i * C, half, dkr);
      axpy_half<C>(p, Gs + i * C, half, dvr);
    }
  }
  if (active) {
    store_half<C>(dk + tok, half, dkr);
    store_half<C>(dv + tok, half, dvr);
  }
}

}  // namespace

// q, k, v: the forward's inputs; g: the cotangent of its output o; lse: its
// log-sum-exp residual. delta [B, H, Tq]: scratch. dq, dk, dv: outputs.
extern "C" int flash_core_bwd(const float* q, const float* k, const float* v, const float* g,
                              const float* o, const float* lse, float* delta, float* dq,
                              float* dk, float* dv, int B, int H, int Tq, int Tk, int C,
                              float scale, void* stream_ptr) {
  if (C != HEAD_DIM || B < 1 || H < 1 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  flash_bwd_q_kernel<HEAD_DIM><<<dim3((Tq + ROWS - 1) / ROWS, H, B), THREADS, 0, stream>>>(
      q, k, v, g, o, lse, delta, dq, H, Tq, Tk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_kv_kernel<HEAD_DIM><<<dim3((Tk + ROWS - 1) / ROWS, H, B), THREADS, 0, stream>>>(
      q, k, v, g, lse, delta, dk, dv, H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_core_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
