// Fully fused GTA attention backward for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces gta_tpu/ops/gta_fused.py:235 `_bwd_kernel` (the Pallas TPU
// recompute backward, launched by `_bwd_call` :398 and wrapped by the VJP
// glue `_core_bwd` :440-457). Per (batch b, head h), with the forward of
// csrc/gta_fused_fwd.cu (row vectors, per-view [C, C] matrices, per-lane
// rotor tables) and the cotangent g of its output:
//
//   output chain  dz = rot_q(g)          do = dz @ Mo^T    dMo += z^T dz
//   core          p  = exp(qt kt^T * scale - lse)          dp = do vt^T
//                 delta = rowsum(do * z)  (= rowsum(p * dp), as z = p vt)
//                 ds = p (dp - delta) * scale
//                 dqt = ds kt     dkt = ds^T qt     dvt = p^T do
//   query chain   dzq = rot_q^-1(dqt)    dq = dzq @ Mq^T   dMq += q^T dzq
//   key chain     dzk = rot_k^-1(dkt)    dk = dzk @ Mk^T   dMk += k^T dzk
//                 dzv = rot_k^-1(dvt)    dv = dzv @ Mk^T   dMk += v^T dzv
//
// (the output and value chains only with V_TRANSFORM; without it do = g and
// dv = dvt). Matrix cotangents are summed over heads and over the rows of
// each view; rotor tables get no cotangent (they are functions of data
// coordinates only, as in `_core_bwd`).
//
// What bounds it on the H100: the function needs 5 core products of
// 2*Tq*Tk*C flops per (b, h) (the Pallas count: s, dp, dqt, dkt, dvt) plus
// the C x C transform chains, against (3*Tq + 4*Tk)*C*4 bytes of inputs
// and outputs: far above the fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// flops per byte), so it is bound by arithmetic on the CUDA cores.
//
// What the design does about it:
//  * The Pallas kernel sums dk, dv and dMk into one output block across a
//    grid that runs in order. Hopper's blocks run in parallel, so the work
//    is split by who owns each output row: a query pass (one query row per
//    lane pair) writes dq, and a key pass (one key row per lane pair) loops
//    over all queries and writes dk, dv. No row is written by two blocks,
//    so there are no atomics and the sums are deterministic. Both passes
//    recompute p from the forward's log-sum-exp: 7 core products where the
//    function needs 5, the price of having no cross-block sums.
//  * A row's 64 channels are split between two lanes of a warp (float4
//    groups 2m + half), so each lane keeps 3 (query pass) or 4 (key pass)
//    vectors of 32 floats in registers; the two partial dot products meet
//    through one warp shuffle. The other side's rows are staged in shared
//    memory in tiles of 32 and read as float4 broadcasts.
//  * The forward's transformed K/V scratch [B, H, Tk, C] and z are kept as
//    residuals, so no C x C transform is recomputed on the key side; the
//    query pass stores qt and do ([B, H, Tq, C]) for the key pass.
//  * The matrix cotangents are a separate reduction: each block sums
//    X^T Y over a slice of one view's (row, head) pairs, with a 4 x 4 tile
//    of the 64 x 64 output per thread, into a partial buffer; a second
//    kernel adds the slices in a fixed order.
// Not yet: tensor-core (wgmma) products, TMA loads, bf16/TF32 operands.
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array; absent tables and unused scratch are null
// and flagged off. Returns the cudaError_t of the launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_pair.cuh"

namespace {

using namespace lane_pair;

constexpr int HAS_MQ = 1;
constexpr int HAS_MK = 2;
constexpr int HAS_MO = 4;
constexpr int HAS_ROTQ = 8;
constexpr int HAS_ROTK = 16;
constexpr int V_TRANSFORM = 32;

constexpr int C = 64;          // the only head width compiled in
constexpr int HALF = C / 2;    // channels one lane of a row's pair owns
constexpr int NG = C / 8;      // float4 groups one lane owns
constexpr int ROWS = 64;       // rows per block in the row passes
constexpr int THREADS = 2 * ROWS;
constexpr int TILE = 32;       // other-side rows per shared-memory tile
constexpr int DM_THREADS = 256;
constexpr int DM_ROWS = 32;    // (row, head) pairs staged per step in the dM reduction

// ---------------------------------------------------------------------------
// Row helpers beside lane_pair.cuh's. Lane `half` of a pair owns float4
// groups 2m + half, i.e. channels 8m + 4*half + e (m < NG, e < 4); a rotor
// pair (2k, 2k+1) never straddles two lanes. Register arrays are indexed
// only by constants.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&x)[C]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 t = __ldg(s4 + i);
    x[4 * i] = t.x;
    x[4 * i + 1] = t.y;
    x[4 * i + 2] = t.z;
    x[4 * i + 3] = t.w;
  }
}

// this lane's half of a full row held in registers
__device__ __forceinline__ void own_half(const float (&x)[C], int half, float (&y)[HALF]) {
#pragma unroll
  for (int m = 0; m < NG; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[4 * m + e] = half ? x[8 * m + 4 + e] : x[8 * m + e];
  }
}

// the full row from the two halves of a lane pair (every lane of the warp
// must call it)
__device__ __forceinline__ void gather_row(const float (&x)[HALF], int half, float (&full)[C]) {
#pragma unroll
  for (int m = 0; m < NG; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mine = x[4 * m + e];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      full[8 * m + e] = half ? other : mine;
      full[8 * m + 4 + e] = half ? mine : other;
    }
  }
}

// own half of x @ M, M row-major [C, C]: y_j = sum_i x_i M[i][j]
__device__ __forceinline__ void matvec_half(const float (&x)[C], const float* __restrict__ M,
                                            int half, float (&y)[HALF]) {
#pragma unroll
  for (int j = 0; j < HALF; ++j) y[j] = 0.f;
  const float4* M4 = reinterpret_cast<const float4*>(M);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float xi = x[i];
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const float4 t = __ldg(M4 + i * (C / 4) + 2 * m + half);
      y[4 * m] = fmaf(xi, t.x, y[4 * m]);
      y[4 * m + 1] = fmaf(xi, t.y, y[4 * m + 1]);
      y[4 * m + 2] = fmaf(xi, t.z, y[4 * m + 2]);
      y[4 * m + 3] = fmaf(xi, t.w, y[4 * m + 3]);
    }
  }
}

// own half of x @ M^T: y_j = sum_i x_i M[j][i] (row j of M is contiguous)
__device__ __forceinline__ void matvec_t_half(const float (&x)[C], const float* __restrict__ M,
                                              int half, float (&y)[HALF]) {
  const float4* M4 = reinterpret_cast<const float4*>(M);
#pragma unroll
  for (int m = 0; m < NG; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * m + 4 * half + e;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        const float4 t = __ldg(M4 + j * (C / 4) + i);
        acc = fmaf(x[4 * i], t.x, acc);
        acc = fmaf(x[4 * i + 1], t.y, acc);
        acc = fmaf(x[4 * i + 2], t.z, acc);
        acc = fmaf(x[4 * i + 3], t.w, acc);
      }
      y[4 * m + e] = acc;
    }
  }
}

// x <- c*x + s*swap(x) (INV: c*x - s*swap(x)), swap(x0, x1) = (-x1, x0)
template <bool INV>
__device__ __forceinline__ void rotate_row(float (&x)[C], const float* __restrict__ c,
                                           const float* __restrict__ s) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float sg = INV ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 cc = __ldg(c4 + i);
    const float4 ss = __ldg(s4 + i);
    const float a0 = x[4 * i], a1 = x[4 * i + 1], a2 = x[4 * i + 2], a3 = x[4 * i + 3];
    x[4 * i] = cc.x * a0 - sg * ss.x * a1;
    x[4 * i + 1] = cc.y * a1 + sg * ss.y * a0;
    x[4 * i + 2] = cc.z * a2 - sg * ss.z * a3;
    x[4 * i + 3] = cc.w * a3 + sg * ss.w * a2;
  }
}

// the same on this lane's half
template <bool INV>
__device__ __forceinline__ void rotate_half(float (&x)[HALF], const float* __restrict__ c,
                                            const float* __restrict__ s, int half) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float sg = INV ? -1.f : 1.f;
#pragma unroll
  for (int m = 0; m < NG; ++m) {
    const float4 cc = __ldg(c4 + 2 * m + half);
    const float4 ss = __ldg(s4 + 2 * m + half);
    const float a0 = x[4 * m], a1 = x[4 * m + 1], a2 = x[4 * m + 2], a3 = x[4 * m + 3];
    x[4 * m] = cc.x * a0 - sg * ss.x * a1;
    x[4 * m + 1] = cc.y * a1 + sg * ss.y * a0;
    x[4 * m + 2] = cc.z * a2 - sg * ss.z * a3;
    x[4 * m + 3] = cc.w * a3 + sg * ss.w * a2;
  }
}

// ---------------------------------------------------------------------------
// Query pass: a lane pair per query row. grid (ceil(Tq/ROWS), H, B).
// Writes dq, the key pass's inputs qt_s/do_s [B, H, Tq, C] and delta
// [B, H, Tq], and the reduction's inputs dzq (with HAS_MQ) and dz (with
// HAS_MO), token-major [B, Tq, H*C]. kt/vt are read through (batch, head,
// row) strides, as in the forward: prologue scratch or raw k/v.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
gta_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ kt,
                 const float* __restrict__ vt, const float* __restrict__ mq,
                 const float* __restrict__ mo, const float* __restrict__ cq,
                 const float* __restrict__ sq, const float* __restrict__ g,
                 const float* __restrict__ z, const float* __restrict__ lse,
                 float* __restrict__ qt_s, float* __restrict__ do_s, float* __restrict__ delta_s,
                 float* __restrict__ dzq, float* __restrict__ dz_out, float* __restrict__ dq,
                 int H, int Tq, int Tk, int nq, int64_t k_bs, int64_t k_hs, int64_t k_rs,
                 int64_t v_bs, int64_t v_hs, int64_t v_rs, int flags, float scale) {
  __shared__ __align__(16) float Ks[TILE * C];
  __shared__ __align__(16) float Vs[TILE * C];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
  const bool active = row < Tq;
  const int r = active ? row : Tq - 1;  // rows past Tq compute on the last row, store nothing
  const int64_t D = (int64_t)H * C;
  const int view = r / (Tq / nq);
  const int64_t tok = ((int64_t)b * Tq + r) * D + (int64_t)h * C;
  const int64_t roff = ((int64_t)b * Tq + r) * C;
  const int64_t hrow = ((int64_t)b * H + h) * Tq + r;
  const bool out_tf = flags & V_TRANSFORM;

  // qt = rot_q(q @ Mq)
  float qt[HALF];
  if (flags & HAS_MQ) {
    float x[C];
    load_row(q + tok, x);
    matvec_half(x, mq + ((int64_t)b * nq + view) * C * C, half, qt);
  } else {
    load_half<C>(q + tok, half, qt);
  }
  if (flags & HAS_ROTQ) rotate_half<false>(qt, cq + roff, sq + roff, half);

  // do: the cotangent of z
  float dov[HALF];
  if (out_tf && (flags & HAS_MO)) {
    float dzr[C];
    load_row(g + tok, dzr);
    if (flags & HAS_ROTQ) rotate_row<false>(dzr, cq + roff, sq + roff);
    if (active) {
      float own[HALF];
      own_half(dzr, half, own);
      store_half<C>(dz_out + tok, half, own);
    }
    matvec_t_half(dzr, mo + ((int64_t)b * nq + view) * C * C, half, dov);
  } else {
    load_half<C>(g + tok, half, dov);
    if (out_tf && (flags & HAS_ROTQ)) rotate_half<false>(dov, cq + roff, sq + roff, half);
  }

  float zr[HALF];
  load_half<C>(z + tok, half, zr);
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < HALF; ++c) dl = fmaf(dov[c], zr[c], dl);
  const float delta = dl + __shfl_xor_sync(0xffffffffu, dl, 1);
  const float lse_r = lse[hrow];
  if (active) {
    store_half<C>(qt_s + hrow * C, half, qt);
    store_half<C>(do_s + hrow * C, half, dov);
    if (!half) delta_s[hrow] = delta;
  }

  float dqt[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dqt[c] = 0.f;
  const float* kbase = kt + b * k_bs + h * k_hs;
  const float* vbase = vt + b * v_bs + h * v_hs;
  for (int k0 = 0; k0 < Tk; k0 += TILE) {
    const int n = min(TILE, Tk - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<C, TILE, THREADS>(Ks, kbase + k0 * k_rs, k_rs, n);
    stage_tile<C, TILE, THREADS>(Vs, vbase + k0 * v_rs, v_rs, n);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float* kr = Ks + j * C;
      float s = dot_half<C>(qt, kr, half);
      float dp = dot_half<C>(dov, Vs + j * C, half);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = j < n ? expf(s * scale - lse_r) : 0.f;
      axpy_half<C>(p * (dp - delta) * scale, kr, half, dqt);
    }
  }

  // query chain: dzq = rot_q^-1(dqt), dq = dzq @ Mq^T
  if (flags & HAS_ROTQ) rotate_half<true>(dqt, cq + roff, sq + roff, half);
  if (flags & HAS_MQ) {
    if (active) store_half<C>(dzq + tok, half, dqt);
    float full[C];
    gather_row(dqt, half, full);
    float dqv[HALF];
    matvec_t_half(full, mq + ((int64_t)b * nq + view) * C * C, half, dqv);
    if (active) store_half<C>(dq + tok, half, dqv);
  } else if (active) {
    store_half<C>(dq + tok, half, dqt);
  }
}

// ---------------------------------------------------------------------------
// Key pass: a lane pair per key row, looping over every query of (b, h).
// grid (ceil(Tk/ROWS), H, B). Writes dk, dv and, with HAS_MK, the
// reduction's inputs dzk and dzv, token-major [B, Tk, H*C].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
gta_bwd_kv_kernel(const float* __restrict__ kt, const float* __restrict__ vt,
                  const float* __restrict__ mk, const float* __restrict__ ck,
                  const float* __restrict__ sk, const float* __restrict__ qt_s,
                  const float* __restrict__ do_s, const float* __restrict__ lse,
                  const float* __restrict__ delta_s, float* __restrict__ dzk,
                  float* __restrict__ dzv, float* __restrict__ dk, float* __restrict__ dv, int H,
                  int Tq, int Tk, int nk, int64_t k_bs, int64_t k_hs, int64_t k_rs, int64_t v_bs,
                  int64_t v_hs, int64_t v_rs, int flags, float scale) {
  __shared__ __align__(16) float Qs[TILE * C];
  __shared__ __align__(16) float Ds[TILE * C];
  __shared__ float Ls[TILE];
  __shared__ float Dl[TILE];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
  const bool active = row < Tk;
  const int r = active ? row : Tk - 1;
  const int64_t D = (int64_t)H * C;
  const int view = r / (Tk / nk);
  const int64_t tok = ((int64_t)b * Tk + r) * D + (int64_t)h * C;
  const int64_t roff = ((int64_t)b * Tk + r) * C;

  float ktr[HALF], vtr[HALF];
  load_half<C>(kt + b * k_bs + h * k_hs + r * k_rs, half, ktr);
  load_half<C>(vt + b * v_bs + h * v_hs + r * v_rs, half, vtr);
  float dkt[HALF], dvt[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) dkt[c] = dvt[c] = 0.f;

  const int64_t hbase = ((int64_t)b * H + h) * Tq;
  for (int q0 = 0; q0 < Tq; q0 += TILE) {
    const int n = min(TILE, Tq - q0);
    __syncthreads();
    stage_tile<C, TILE, THREADS>(Qs, qt_s + (hbase + q0) * C, C, n);
    stage_tile<C, TILE, THREADS>(Ds, do_s + (hbase + q0) * C, C, n);
    if (threadIdx.x < TILE) {
      const bool in = (int)threadIdx.x < n;
      Ls[threadIdx.x] = in ? lse[hbase + q0 + threadIdx.x] : 0.f;
      Dl[threadIdx.x] = in ? delta_s[hbase + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float* qr = Qs + i * C;
      const float* dr = Ds + i * C;
      float s = dot_half<C>(ktr, qr, half);
      float dp = dot_half<C>(vtr, dr, half);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = i < n ? expf(s * scale - Ls[i]) : 0.f;
      axpy_half<C>(p * (dp - Dl[i]) * scale, qr, half, dkt);
      axpy_half<C>(p, dr, half, dvt);
    }
  }

  // key / value chain
  const bool v_tf = flags & V_TRANSFORM;
  if (flags & HAS_ROTK) {
    rotate_half<true>(dkt, ck + roff, sk + roff, half);
    if (v_tf) rotate_half<true>(dvt, ck + roff, sk + roff, half);
  }
  if (flags & HAS_MK) {
    const float* M = mk + ((int64_t)b * nk + view) * C * C;
    float full[C], y[HALF];
    if (active) store_half<C>(dzk + tok, half, dkt);
    gather_row(dkt, half, full);
    matvec_t_half(full, M, half, y);
    if (active) store_half<C>(dk + tok, half, y);
    if (v_tf) {
      if (active) store_half<C>(dzv + tok, half, dvt);
      gather_row(dvt, half, full);
      matvec_t_half(full, M, half, y);
      if (active) store_half<C>(dv + tok, half, y);
    } else if (active) {
      store_half<C>(dv + tok, half, dvt);
    }
  } else if (active) {
    store_half<C>(dk + tok, half, dkt);
    store_half<C>(dv + tok, half, dvt);
  }
}

// ---------------------------------------------------------------------------
// Matrix cotangents: part[b, view, split] = sum over a slice of the view's
// (row, head) pairs of X1^T Y1 (+ X2^T Y2). X*, Y* are token-major
// [B, T, H*C], read as [B, T*H, C]: a view's pairs are contiguous, `rpv`
// of them. grid (splits, n, B); each thread owns a 4 x 4 output tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(DM_THREADS)
gta_bwd_dm_kernel(const float* __restrict__ X1, const float* __restrict__ Y1,
                  const float* __restrict__ X2, const float* __restrict__ Y2,
                  float* __restrict__ part, int64_t rows, int rpv, int splits) {
  __shared__ __align__(16) float Xs[DM_ROWS * C];
  __shared__ __align__(16) float Ys[DM_ROWS * C];
  const int split = blockIdx.x;
  const int view = blockIdx.y;
  const int b = blockIdx.z;
  const int n = gridDim.y;
  const int per = (rpv + splits - 1) / splits;
  const int64_t r0 = (int64_t)view * rpv + (int64_t)split * per;
  const int64_t r_end = (int64_t)view * rpv + rpv;
  const int64_t r1 = r0 + per < r_end ? r0 + per : r_end;
  const int a0 = 4 * (threadIdx.x / 16);
  const int c0 = 4 * (threadIdx.x % 16);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int pair = 0; pair < 2; ++pair) {
    const float* X = pair ? X2 : X1;
    const float* Y = pair ? Y2 : Y1;
    if (X == nullptr) continue;
    const float* xb = X + (int64_t)b * rows * C;
    const float* yb = Y + (int64_t)b * rows * C;
    for (int64_t s0 = r0; s0 < r1; s0 += DM_ROWS) {
      const int cnt = r1 - s0 < DM_ROWS ? (int)(r1 - s0) : DM_ROWS;
      __syncthreads();
      for (int idx = threadIdx.x; idx < DM_ROWS * C / 4; idx += DM_THREADS) {
        const int rr = idx / (C / 4);
        const int c4 = idx % (C / 4);
        float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
        if (rr < cnt) {
          xv = __ldg(reinterpret_cast<const float4*>(xb + (s0 + rr) * C) + c4);
          yv = __ldg(reinterpret_cast<const float4*>(yb + (s0 + rr) * C) + c4);
        }
        reinterpret_cast<float4*>(Xs)[idx] = xv;
        reinterpret_cast<float4*>(Ys)[idx] = yv;
      }
      __syncthreads();
#pragma unroll 8
      for (int rr = 0; rr < DM_ROWS; ++rr) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + rr * C + a0);
        const float4 yv = *reinterpret_cast<const float4*>(Ys + rr * C + c0);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float yc[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], yc[j], acc[i][j]);
      }
    }
  }
  float* out = part + (((int64_t)b * n + view) * splits + split) * C * C;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (a0 + i) * C + c0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dm[bn] = sum over splits of part[bn, split], in split order
__global__ void gta_bwd_dm_sum_kernel(const float* __restrict__ part, float* __restrict__ dm,
                                      int64_t total, int splits) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t bn = idx / (C * C), e = idx % (C * C);
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(bn * splits + k) * C * C + e];
  dm[idx] = s;
}

cudaError_t reduce_dm(const float* X1, const float* Y1, const float* X2, const float* Y2,
                      float* part, float* dm, int B, int n, int T, int H, int splits,
                      cudaStream_t stream) {
  const int rpv = (T / n) * H;
  gta_bwd_dm_kernel<<<dim3(splits, n, B), DM_THREADS, 0, stream>>>(X1, Y1, X2, Y2, part,
                                                                     (int64_t)T * H, rpv, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * n * C * C;
  gta_bwd_dm_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, dm, total,
                                                                             splits);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, tables: the forward's inputs. g: the cotangent of its output.
// z, lse, kt, vt: its residuals (kt/vt null without a K/V transform; vt
// null without V_TRANSFORM). qt_s, do_s [B, H, Tq, C], delta [B, H, Tq],
// dzq, dz [B, Tq, H*C], dzk, dzv [B, Tk, H*C] (each null where its flag is
// off) and part [B * max(nq * splits_q, nk * splits_k), C, C]: scratch.
extern "C" int gta_fused_bwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, const float* g, const float* z,
                             const float* lse, const float* kt, const float* vt, float* qt_s,
                             float* do_s, float* delta, float* dzq, float* dz, float* dzk,
                             float* dzv, float* part, float* dq, float* dk, float* dv, float* dmq,
                             float* dmk, float* dmo, int B, int H, int Tq, int Tk, int c, int nq,
                             int nk, int splits_q, int splits_k, int flags, float scale,
                             void* stream_ptr) {
  if (c != C || B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      splits_q < 1 || splits_k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t D = (int64_t)H * C;
  const bool kv_transform = flags & (HAS_MK | HAS_ROTK);
  const bool v_side = kv_transform && (flags & V_TRANSFORM);
  // strides (in floats) of the transformed K and V rows, as in the forward
  const int64_t scratch_bs = (int64_t)H * Tk * C, scratch_hs = (int64_t)Tk * C;
  const int64_t input_bs = (int64_t)Tk * D, input_hs = C;
  const float* kp = kv_transform ? kt : k;
  const float* vp = v_side ? vt : v;
  const int64_t k_bs = kv_transform ? scratch_bs : input_bs;
  const int64_t k_hs = kv_transform ? scratch_hs : input_hs;
  const int64_t k_rs = kv_transform ? (int64_t)C : D;
  const int64_t v_bs = v_side ? scratch_bs : input_bs;
  const int64_t v_hs = v_side ? scratch_hs : input_hs;
  const int64_t v_rs = v_side ? (int64_t)C : D;

  gta_bwd_q_kernel<<<dim3((Tq + ROWS - 1) / ROWS, H, B), THREADS, 0, stream>>>(
      q, kp, vp, mq, mo, cq, sq, g, z, lse, qt_s, do_s, delta, dzq, dz, dq, H, Tq, Tk, nq, k_bs,
      k_hs, k_rs, v_bs, v_hs, v_rs, flags, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gta_bwd_kv_kernel<<<dim3((Tk + ROWS - 1) / ROWS, H, B), THREADS, 0, stream>>>(
      kp, vp, mk, ck, sk, qt_s, do_s, lse, delta, dzk, dzv, dk, dv, H, Tq, Tk, nk, k_bs, k_hs,
      k_rs, v_bs, v_hs, v_rs, flags, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (flags & HAS_MQ) {
    err = reduce_dm(q, dzq, nullptr, nullptr, part, dmq, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if ((flags & HAS_MO) && (flags & V_TRANSFORM)) {
    err = reduce_dm(z, dz, nullptr, nullptr, part, dmo, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (flags & HAS_MK) {
    const bool vt_side = flags & V_TRANSFORM;
    err = reduce_dm(k, dzk, vt_side ? v : nullptr, vt_side ? dzv : nullptr, part, dmk, B, nk, Tk,
                    H, splits_k, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* gta_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
