// The softmax attention core of every attention kernel of this directory,
// forward and backward, at fp32 accuracy on Hopper's tensor cores (3xTF32
// mma.sync, csrc/tf32x3.cuh). Shared by the fused GTA kernels
// (csrc/gta_fused_fwd.cu, csrc/gta_fused_bwd.cu), which run it over the
// transformed qt, kt, vt of their row launches, and by flash_core
// (csrc/flash_core_fwd.cu, csrc/flash_core_bwd.cu), which runs it over the
// raw token-major q, k, v. It is the attention core of the TPU kernels
// gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` and :235 `_bwd_kernel`, and
// the whole of gta_tpu/ops/flash_core.py:73 `_fwd_kernel` and :86
// `_bwd_kernel`. Per (batch b, head h), head width C = 64 or 96:
//
//   forward   o   = softmax(q k^T * scale) v   (online over K tiles)
//             lse = log(sum_k exp(q k^T * scale))   (natural log; optional)
//   backward  p   = exp(q k^T * scale - lse)    dp = do v^T
//             ds  = p (dp - delta) * scale      delta = rowsum(do * o)
//             dq  = ds k     dk = ds^T q     dv = p^T do
//
// Every operand is addressed through (batch, head, row) strides (`Layout`):
// token-major [B, T, H*C] and heads-first [B, H, T, C] alike. The kernels'
// operand names follow the GTA callers (qt, kt, vt: transformed rows; z:
// the output before GTA's output transform); flash_core passes its raw q,
// k, v and its output o in their places.
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) forward, 10*Tq*Tk*C
// backward (the function's 5 products), against a few bytes per row: 75 to
// 300 flops per byte at this repo's shapes (Tk = 600, Tq = 600 to 16384). So
// it is bound by operations, at 165 TFLOP/s for fp32-accurate products on
// the tensor cores (3xTF32, 495 / 3) or 67 TFLOP/s on the CUDA cores.
//
// What the design does about it:
//  * Every product is 3xTF32 m16n8k8 mma.sync. A block of 4 warps owns 64
//    rows, a warp 16; the other side streams through dynamic shared memory
//    in double-buffered tiles (cp.async). Score accumulators feed the next
//    product as A fragments in place (tf32x3.cuh renames their columns).
//  * Forward (attn_fwd_kernel): the block's q rows are split into TF32 parts
//    once, in shared memory; K/V tiles of 32 keys (70 KB a block at C = 64,
//    3 blocks per SM; 102 KB at C = 96, 2). The online softmax lives in the
//    S accumulators, its row max reduced across each quad of lanes by
//    shuffles, and stays in the scores' units, so that where one key
//    dominates, lse = max exactly.
//  * Backward: Hopper's blocks run in parallel, so the work is split by who
//    owns each output row. A query pass (attn_bwd_q_kernel: S, dP, dq += dS k;
//    32-key tiles, 68 KB, 3 blocks per SM at C = 64; 102 KB, 2 at C = 96)
//    writes dq; a key pass (attn_bwd_kv_kernel: S^T, dP^T, dv += P^T do,
//    dk += dS^T q; 64-query tiles, 103 KB, 2 blocks per SM) writes dk and dv.
//    At C = 96 one key pass would hold 96 accumulator floats a thread for dk
//    and dv, 48 for a tile product's partial sum and 64 for S^T and dP^T:
//    past the 255 registers of a thread. So C = 96 runs two key passes over
//    32-query tiles (102 KB, 2 blocks per SM): one writes dv (S^T, P^T do),
//    the other dk (S^T, dP^T, dS^T q), 8 products where C = 64 runs 7.
//    No row is written by two blocks: no atomics, every sum in a fixed
//    order, bit-identical reruns. Both passes recompute P from lse: 7
//    products where the function needs 5, the price of having no
//    cross-block sums.
//  * Centres: a layer's rows share a large component, and the tensor cores
//    truncate each sum by ~1e-6 of its value, which broke the cancellation
//    in dq = dS k (attn_bwd_q_kernel). So the core takes o = c_v + P (v -
//    c_v), dP = do (v - c_v)^T and dq = dS (k - c_k) about centre rows c_k,
//    c_v of each (b, h), exact rewrites (P's rows sum to 1, dS's to 0) that
//    keep every product at the scale of the rows' spread. flash_core
//    centres its raw rows about the first key's rows (`centres` null); the
//    fused GTA kernels centre their transformed kt, vt about the rows'
//    means (`centres` [2, B, H, C]: a first row, far from a zero-mean set's
//    centre, costs z its accuracy). A per-view transform keeps a
//    token-common component common within a view; one centre removes it
//    when there is one view, and not the part that differs between views or
//    turns with the rotors (PERF.md, section 7).
//  * delta: the query pass computes delta = rowsum(do * (o - c_v)) in its
//    prologue. When every key fits one tile, it takes delta = rowsum(P * dP)
//    from its own products, so each row's dS sums to zero as the plain
//    version's does (one key: dS = 0 exactly).
//  * Precision: the tensor cores' fp32 accumulation truncates (tf32x3.cuh),
//    so every mma chain is one shared-memory tile long, starts from zero
//    and joins its running sum by rounded fp32 adds. A longer chain passes
//    the kernel-vs-plain checks and fails a gradient check.
//  * Ragged Tq and Tk need no padding: rows past the end are zero-filled,
//    masked (-inf scores, p = 0) and store nothing.
// ptxas registers and spills of every instance: chip_smoke.py's build report
// (PERF.md's kernel table).
// The loops reach about half of mma.sync's rate (tf32x3.cuh), bound by the
// latency of each fragment's load, split and dependent mma chain.
// Not yet: wgmma and TMA (wgmma's TF32 form takes only K-major operands, so
// P*V needs a transposed V tile); 5 backward products in place of 7 (a
// cross-block sum of dk/dv).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace attn {

using namespace tf32x3;

// strides (floats) of an operand over (batch, head, row)
struct Layout {
  int64_t bs, hs, rs;
};

// token-major [B, T, H*C]
__host__ __device__ inline Layout tokens(int T, int H, int C) {
  return {(int64_t)T * H * C, C, (int64_t)H * C};
}

// heads-first [B, H, T, C]
__host__ __device__ inline Layout heads_first(int T, int H, int C) {
  return {(int64_t)H * T * C, (int64_t)T * C, C};
}

__device__ __forceinline__ int64_t offset(const Layout& L, int b, int h, int row) {
  return b * L.bs + h * L.hs + row * L.rs;
}

constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // own rows per block
constexpr int BN = 32;          // keys per shared-memory tile in the forward
constexpr int BN_Q = 32;        // keys per shared-memory tile in the query pass
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// blocks per SM of the forward and the query pass (their launch bounds):
// 3 at C = 64; at C = 96 shared memory (102 KB a block) and registers allow 2
template <int C>
__host__ __device__ constexpr int min_blocks() {
  return C > 64 ? 2 : 3;
}

// queries per shared-memory tile in the key pass, and whether it splits into
// a dv pass and a dk pass (C = 96: registers, see above)
template <int C>
__host__ __device__ constexpr int bn_k() {
  return C > 64 ? 32 : 64;
}
template <int C>
__host__ __device__ constexpr bool split_kv() {
  return C > 64;
}

// what a key pass writes
constexpr int KV_BOTH = 0, KV_DV = 1, KV_DK = 2;

template <int C>
__host__ __device__ constexpr int fwd_smem_bytes() {
  // q hi and lo parts of the block's rows, K and V tiles (two stages each),
  // the centre of V
  return (2 * BM * (C + 4) + 2 * 2 * BN * (C + 4) + C) * (int)sizeof(float);
}

template <int C>
__host__ __device__ constexpr int q_smem_bytes() {
  // own q and do rows, K and V tiles (two stages each), the centres of K
  // and V
  return (2 * BM * (C + 4) + 2 * 2 * BN_Q * (C + 4) + 2 * C) * (int)sizeof(float);
}

template <int C>
__host__ __device__ constexpr int kv_smem_bytes() {
  // own K and V rows, Q and dO tiles (two stages each), lse and delta
  // tiles, the centre of V: 2 blocks per SM
  return (2 * BM * (C + 4) + 2 * 2 * bn_k<C>() * (C + 4) + 2 * 2 * bn_k<C>() + C) *
         (int)sizeof(float);
}

// the centre rows of (b, h): c_k (which 0) or c_v (which 1)
// from `centres` [2][B][H][C], or the first key's row `first` when null;
// grids are (row blocks, H, B)
template <int C>
__device__ __forceinline__ const float* centre_row(const float* centres, int which, int b, int h,
                                                   int H, const float* first) {
  return centres ? centres + (((int64_t)which * gridDim.z + b) * H + h) * C : first;
}

// rows (g, g+8) of an accumulator tile [16 x C] into an operand, through
// (batch, head, row) strides; rows at or past T are not stored
template <int C>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Layout& L, int b, int h,
                                           const int (&row)[2], int T, const float (&acc)[C / 8][4],
                                           Lane ln) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    float* d = dst + offset(L, b, h, row[r]);
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      *reinterpret_cast<float2*>(d + 8 * n + 2 * ln.t) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// acc += t with fp32 round-to-nearest adds. Products accumulate on the
// tensor cores over one tile at a time: their fp32 accumulation truncates
// toward zero (csrc/tf32x3.cuh), by more the longer the chain: one chain
// over every row of the other side (2568 queries) would drift by ~40x one
// tile's share.
template <int C>
__device__ __forceinline__ void add_tile(float (&acc)[C / 8][4], const float (&t)[C / 8][4]) {
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
  }
}

// acc += A T for a [16 x 8*NT] accumulator tile A (its 8-column tiles are
// the k-steps) and an [8*NT x C] shared-memory tile T, through a zeroed
// tile sum; with CENTER, A (T - centre) for a row `centre` [C] in shared
// memory
template <int C, int NT, bool CENTER = false>
__device__ __forceinline__ void tile_product(float (&acc)[C / 8][4], const float (&A)[NT][4],
                                             const float* T, Lane ln,
                                             const float* centre = nullptr) {
  float t[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float af[4];
    a_from_acc(af, A[j]);
    const FragA a = split(af);
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      float bf[2];
      load_b_kn(bf, T, C + 4, 8 * j, 8 * n, ln);
      if constexpr (CENTER) {  // both elements are channel 8n + g
        const float c = centre[8 * n + ln.g];
        bf[0] -= c;
        bf[1] -= c;
      }
      mma3(t[n], a, split(bf));
    }
  }
  add_tile<C>(acc, t);
}

// ---------------------------------------------------------------------------
// Forward: z[b, row, h] = softmax(qt kt^T * scale) vt for the block's 64
// rows, and lse when non-null. grid (ceil(Tq/BM), H, B). Taken as
// z = c_v + softmax(...) (vt - c_v) for the centre c_v of (b, h)
// (`centre_row`): the products then sum at the scale of the rows' spread,
// and z keeps no truncation of a large common component for the backward's
// delta = rowsum(do * (z - c_v)) to inherit (attn_bwd_q_kernel).
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, min_blocks<C>())
attn_fwd_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                const float* __restrict__ vt, const float* __restrict__ centres,
                float* __restrict__ z, float* __restrict__ lse, int H, int Tq, int Tk, Layout ql,
                Layout kl, Layout vl, Layout zl, float scale) {
  static_assert(C % 8 == 0, "head width must be a multiple of 8");
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;   // k-steps over channels
  constexpr int NT = BN / 8;  // 8-key tiles per K tile
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;              // [BM][LD] qt, TF32 big parts
  float* Ql = Qh + BM * LD;      // [BM][LD] qt, small parts
  float* Ks = Ql + BM * LD;      // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;  // [2][BN][LD]
  float* Cv = Vs + 2 * BN * LD;  // [C] c_v

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const Lane ln = lane_coords();
  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * BM;
  const int row[2] = {q0 + warp * 16 + ln.g, q0 + warp * 16 + ln.g + 8};

  float acc[KS][4];  // O, 16 rows x C: rows (g, g+8), channels 8n + 2t (+1)
#pragma unroll
  for (int n = 0; n < KS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores
  float l[2] = {0.f, 0.f};              // this lane's part of the running sum

  // qt rows (split once: every warp reads them at every K tile) and the
  // first K/V tile; rows past Tq are zero and store nothing
  const float* kbase = kt + b * kl.bs + h * kl.hs;
  const float* vbase = vt + b * vl.bs + h * vl.hs;
  const int ntiles = (Tk + BN - 1) / BN;
  stage_rows<C, BM, THREADS>(Qh, qt + offset(ql, b, h, q0), ql.rs, Tq - q0);
  stage_rows<C, BN, THREADS>(Ks, kbase, kl.rs, Tk);
  stage_rows<C, BN, THREADS>(Vs, vbase, vl.rs, Tk);
  cp_async_commit();
  const float* cv = centre_row<C>(centres, 1, b, h, H, vbase);
  for (int c = threadIdx.x; c < C; c += THREADS) Cv[c] = cv[c];
  cp_async_wait<0>();
  __syncthreads();
  split_rows<C, BM, THREADS>(Qh, Ql);
  const float* Qhw = Qh + warp * 16 * LD;
  const float* Qlw = Ql + warp * 16 * LD;

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {  // the next tile streams in while this one computes
      const int k1 = (i + 1) * BN;
      stage_rows<C, BN, THREADS>(Ks + (buf ^ 1) * BN * LD, kbase + k1 * kl.rs, kl.rs, Tk - k1);
      stage_rows<C, BN, THREADS>(Vs + (buf ^ 1) * BN * LD, vbase + k1 * vl.rs, vl.rs, Tk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* K = Ks + buf * BN * LD;
    const float* V = Vs + buf * BN * LD;

    // S = qt kt^T: rows (g, g+8), keys 8n + 2t (+1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragA a;
      load_a_split(a, Qhw, Qlw, LD, 8 * ks, ln);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float bf[2];
        load_b_nk(bf, K, LD, 8 * n, 8 * ks, ln);
        mma3(s[n], a, split(bf));
      }
    }

    // online softmax, exponentials in base 2; keys past Tk score -inf. The
    // max stays in the scores' own units, so that where one key dominates,
    // lse = max exactly and the backward's exp(s * scale - lse) is 1
    const int kvalid = Tk - i * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * ln.t + (e & 1);
        const float x = key < kvalid ? s[n][e] * scale : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);  // finite: every tile has a valid key
      alpha[r] = exp2f((m[r] - mnew) * LOG2E);
      m[r] = mnew;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }

    // O = alpha * O + P vt. P's 8-key tile j is the A operand of k-step j.
    // The tile's product starts from zero and joins O by a rounded fp32 add
    // (the tensor cores' accumulation truncates; tf32x3.cuh).
    float pv[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pa[4];
      a_from_acc(pa, s[j]);
      const FragA a = split(pa);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float bf[2];
        load_b_kn(bf, V, LD, 8 * j, 8 * n, ln);
        const float c = Cv[8 * n + ln.g];  // both elements are channel 8n + g
        bf[0] -= c;
        bf[1] -= c;
        mma3(pv[n], a, split(bf));
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    }
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= Tq) continue;
    const float inv = 1.f / l[r];
    float* zr = z + offset(zl, b, h, row[r]);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const float2 c = *reinterpret_cast<const float2*>(Cv + 8 * n + 2 * ln.t);
      *reinterpret_cast<float2*>(zr + 8 * n + 2 * ln.t) =
          make_float2(acc[n][2 * r] * inv + c.x, acc[n][2 * r + 1] * inv + c.y);
    }
    if (lse && ln.t == 0) lse[((int64_t)b * H + h) * Tq + row[r]] = m[r] + logf(l[r]);
  }
}

// rows [0, ROWS) of a [ROWS][C + 4] tile in shared memory minus `centre`
// [C]; every thread of the block calls it
template <int C, int ROWS>
__device__ __forceinline__ void centre_rows(float* tile, const float* centre) {
  for (int idx = threadIdx.x; idx < ROWS * C / 4; idx += THREADS) {
    float4* x = reinterpret_cast<float4*>(tile + (idx / (C / 4)) * (C + 4) + 4 * (idx % (C / 4)));
    const float4 c = reinterpret_cast<const float4*>(centre)[idx % (C / 4)];
    *x = make_float4(x->x - c.x, x->y - c.y, x->z - c.z, x->w - c.w);
  }
}

// ---------------------------------------------------------------------------
// Query pass: a warp per 16 query rows, looping over every key of (b, h).
// grid (ceil(Tq/BM), H, B). Writes dq through `dql`.
// dP and dq are taken about the centres c_k, c_v of (b, h) (`centre_row`;
// rows that share large components):
//   dP - delta = do (v - c_v)^T - rowsum(do * (o - c_v))
//   dq = dS k = dS (k - c_k)          (each row of dS sums to zero)
// exact rewrites that keep every product and partial sum at the scale of
// the rows' spread. The tensor cores truncate each product's sum toward
// zero by ~1e-6 of its value (tf32x3.cuh): about uncentred rows that is
// ~1e-6 of the common component, dS's rows no longer sum to zero, and dq
// gains that sum times the common key (2.7e-3 relative L2 on an SRT
// decoder layer's to_q gradient, against 1.8e-5 for fp32 on the CPU).
// delta = rowsum(do * (o - c_v)) is computed here from `o` (the forward's
// output, in do's layout) and written for the key pass.
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, min_blocks<C>())
attn_bwd_q_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                  const float* __restrict__ vt, const float* __restrict__ centres,
                  const float* __restrict__ do_s, const float* __restrict__ o,
                  const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dqt, int H, int Tq, int Tk,
                  Layout ql, Layout kl, Layout vl, Layout dol, Layout dql, float scale) {
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;
  constexpr int NT = BN_Q / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qown = smem;               // [BM][LD]
  float* Down = Qown + BM * LD;     // [BM][LD]
  float* Ks = Down + BM * LD;       // [2][BN_Q][LD]
  float* Vs = Ks + 2 * BN_Q * LD;   // [2][BN_Q][LD]
  float* Ck = Vs + 2 * BN_Q * LD;   // [C] c_k
  float* Cv = Ck + C;               // [C] c_v

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const Lane ln = lane_coords();
  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * BM;
  const int row[2] = {q0 + warp * 16 + ln.g, q0 + warp * 16 + ln.g + 8};
  const int ra = min(row[0], Tq - 1), rb = min(row[1], Tq - 1);
  stage_rows<C, BM, THREADS>(Qown, qt + offset(ql, b, h, q0), ql.rs, Tq - q0);
  stage_rows<C, BM, THREADS>(Down, do_s + offset(dol, b, h, q0), dol.rs, Tq - q0);
  const float* Qw = Qown + warp * 16 * LD;
  const float* Dw = Down + warp * 16 * LD;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const float ls[2] = {lse[hrow + ra], lse[hrow + rb]};
  const float* kbase = kt + b * kl.bs + h * kl.hs;
  const float* vbase = vt + b * vl.bs + h * vl.hs;
  float dl[2];
  const float* ck = centre_row<C>(centres, 0, b, h, H, kbase);
  const float* cv = centre_row<C>(centres, 1, b, h, H, vbase);
  for (int i = threadIdx.x; i < C; i += THREADS) {  // read after the loop's first barrier
    Ck[i] = ck[i];
    Cv[i] = cv[i];
  }
  // delta = rowsum(do * (o - c_v)): this lane's channels 8n + 2t (+1),
  // summed across the quad
  const int rr[2] = {ra, rb};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* dr = do_s + offset(dol, b, h, rr[r]) + 2 * ln.t;
    const float* orow = o + offset(dol, b, h, rr[r]) + 2 * ln.t;
    float d = 0.f;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(dr + 8 * n);
      const float2 y = *reinterpret_cast<const float2*>(orow + 8 * n);
      const float2 c = *reinterpret_cast<const float2*>(cv + 2 * ln.t + 8 * n);
      d = fmaf(x.x, y.x - c.x, fmaf(x.y, y.y - c.y, d));
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dl[r] = d;
    if (ln.t == 0 && row[r] < Tq) delta[hrow + row[r]] = d;
  }

  float dq[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int ntiles = (Tk + BN_Q - 1) / BN_Q;
  stage_rows<C, BN_Q, THREADS>(Ks, kbase, kl.rs, Tk);
  stage_rows<C, BN_Q, THREADS>(Vs, vbase, vl.rs, Tk);
  cp_async_commit();

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BN_Q;
      stage_rows<C, BN_Q, THREADS>(Ks + (buf ^ 1) * BN_Q * LD, kbase + k1 * kl.rs, kl.rs, Tk - k1);
      stage_rows<C, BN_Q, THREADS>(Vs + (buf ^ 1) * BN_Q * LD, vbase + k1 * vl.rs, vl.rs, Tk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* K = Ks + buf * BN_Q * LD;
    const float* V = Vs + buf * BN_Q * LD;
    centre_rows<C, BN_Q>(Vs + buf * BN_Q * LD, Cv);  // V is read only as v - c_v here
    __syncthreads();

    // S = qt kt^T and dP = do vt^T: rows (g, g+8), keys 8n + 2t (+1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float af[4];
      load_a(af, Qw, LD, 8 * ks, ln);
      const FragA aq = split(af);
      load_a(af, Dw, LD, 8 * ks, ln);
      const FragA ad = split(af);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float bf[2];
        load_b_nk(bf, K, LD, 8 * n, 8 * ks, ln);
        mma3(s[n], aq, split(bf));
        load_b_nk(bf, V, LD, 8 * n, 8 * ks, ln);
        mma3(dp[n], ad, split(bf));
      }
    }

    // P = exp(S * scale - lse); keys past Tk get 0
    const int kvalid = Tk - i * BN_Q;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * ln.t + (e & 1);
        s[n][e] = key < kvalid ? exp2f((s[n][e] * scale - ls[e >> 1]) * LOG2E) : 0.f;
      }
    }
    if (ntiles == 1) {
      // every key is in this tile: delta = rowsum(P * dP) from these very
      // products (rowsum(do * o) in exact arithmetic), so each row's dS sums
      // to zero as the plain version's does; the key pass reads it back
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float d = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          d = fmaf(s[n][2 * r], dp[n][2 * r], fmaf(s[n][2 * r + 1], dp[n][2 * r + 1], d));
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        dl[r] = d;
        if (ln.t == 0 && row[r] < Tq) delta[hrow + row[r]] = d;
      }
    }
    // dS = P (dP - delta) * scale
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
    }

    // dqt += dS (kt - c_k): the tile's product from zero, then a rounded
    // add
    tile_product<C, NT, true>(dq, s, K, ln, Ck);
    __syncthreads();
  }
  store_rows<C>(dqt, dql, b, h, row, Tq, dq, ln);
}

// ---------------------------------------------------------------------------
// Key pass: a warp per 16 key rows, looping over every query of (b, h).
// grid (ceil(Tk/BM), H, B). Writes dk and dv through `dkl` (PART KV_BOTH),
// or dv alone (KV_DV: S^T and P^T do) or dk alone (KV_DK). Its dP^T is
// (v - c_v) do^T, as in the query pass.
// ---------------------------------------------------------------------------
template <int C, int PART>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_kv_kernel(const float* __restrict__ kt, const float* __restrict__ vt,
                   const float* __restrict__ centres, const float* __restrict__ qt,
                   const float* __restrict__ do_s,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dkt, float* __restrict__ dvt, int H, int Tq, int Tk,
                   Layout kl, Layout vl, Layout ql, Layout dol, Layout dkl, float scale) {
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;
  constexpr int BNK = bn_k<C>();
  constexpr int NT = BNK / 8;
  constexpr bool DV = PART != KV_DK, DK = PART != KV_DV;
  extern __shared__ __align__(16) float smem[];
  float* Kown = smem;               // [BM][LD]
  float* Vown = Kown + BM * LD;     // [BM][LD] (dk)
  float* Qs = Vown + BM * LD;       // [2][BNK][LD]
  float* Ds = Qs + 2 * BNK * LD;    // [2][BNK][LD]
  float* Ls = Ds + 2 * BNK * LD;    // [2][BNK]
  float* Dl = Ls + 2 * BNK;         // [2][BNK] (dk)
  float* Cv = Dl + 2 * BNK;         // [C] c_v (dk)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const Lane ln = lane_coords();
  const int warp = threadIdx.x / 32;
  const int k0 = blockIdx.x * BM;
  const int row[2] = {k0 + warp * 16 + ln.g, k0 + warp * 16 + ln.g + 8};

  const float* qbase = qt + b * ql.bs + h * ql.hs;
  const float* dbase = do_s + b * dol.bs + h * dol.hs;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const int ntiles = (Tq + BNK - 1) / BNK;
  stage_rows<C, BM, THREADS>(Kown, kt + offset(kl, b, h, k0), kl.rs, Tk - k0);
  if constexpr (DK) stage_rows<C, BM, THREADS>(Vown, vt + offset(vl, b, h, k0), vl.rs, Tk - k0);
  stage_rows<C, BNK, THREADS>(Qs, qbase, ql.rs, Tq);
  stage_rows<C, BNK, THREADS>(Ds, dbase, dol.rs, Tq);
  stage_vec<BNK, THREADS>(Ls, lse + hrow, Tq);
  if constexpr (DK) stage_vec<BNK, THREADS>(Dl, delta + hrow, Tq);
  cp_async_commit();
  if constexpr (DK) {  // read after the loop's first barrier
    const float* cv = centre_row<C>(centres, 1, b, h, H, vt + b * vl.bs + h * vl.hs);
    for (int i = threadIdx.x; i < C; i += THREADS) Cv[i] = cv[i];
  }

  float dk[KS][4], dv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  const float* Kw = Kown + warp * 16 * LD;
  const float* Vw = Vown + warp * 16 * LD;

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      const int q1 = (i + 1) * BNK;
      stage_rows<C, BNK, THREADS>(Qs + (buf ^ 1) * BNK * LD, qbase + q1 * ql.rs, ql.rs, Tq - q1);
      stage_rows<C, BNK, THREADS>(Ds + (buf ^ 1) * BNK * LD, dbase + q1 * dol.rs, dol.rs, Tq - q1);
      stage_vec<BNK, THREADS>(Ls + (buf ^ 1) * BNK, lse + hrow + q1, Tq - q1);
      if constexpr (DK) stage_vec<BNK, THREADS>(Dl + (buf ^ 1) * BNK, delta + hrow + q1, Tq - q1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Q = Qs + buf * BNK * LD;
    const float* Dt = Ds + buf * BNK * LD;
    const float* L = Ls + buf * BNK;
    const float* Dlt = Dl + buf * BNK;
    if constexpr (DK) {
      if (i == 0) {  // the own V rows have landed with the first tile
        centre_rows<C, BM>(Vown, Cv);
        __syncthreads();
      }
    }

    // S^T = kt qt^T and dP^T = vt do^T: key rows (g, g+8), queries 8n + 2t
    // (+1); mma3_t sums the query pass's products in its order, so both
    // passes see the same P and dS bit for bit
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float af[4];
      load_a(af, Kw, LD, 8 * ks, ln);
      const FragA ak = split(af);
      FragA av;
      if constexpr (DK) {
        load_a(af, Vw, LD, 8 * ks, ln);
        av = split(af);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float bf[2];
        load_b_nk(bf, Q, LD, 8 * n, 8 * ks, ln);
        mma3_t(st[n], ak, split(bf));
        if constexpr (DK) {
          load_b_nk(bf, Dt, LD, 8 * n, 8 * ks, ln);
          mma3_t(dpt[n], av, split(bf));
        }
      }
    }

    // P^T = exp(S^T * scale - lse[q]), dS^T = P^T (dP^T - delta[q]) * scale;
    // queries past Tq get 0
    const int qvalid = Tq - i * BNK;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * n + 2 * ln.t + (e & 1);
        const float p = q < qvalid ? exp2f((st[n][e] * scale - L[q]) * LOG2E) : 0.f;
        st[n][e] = p;
        if constexpr (DK) dpt[n][e] = p * (dpt[n][e] - Dlt[q]) * scale;
      }
    }

    // dvt += P^T do, then dkt += dS^T qt: each tile's product from zero,
    // then a rounded add
    if constexpr (DV) tile_product<C, NT>(dv, st, Dt, ln);
    if constexpr (DK) tile_product<C, NT>(dk, dpt, Q, ln);
    __syncthreads();
  }
  if constexpr (DK) store_rows<C>(dkt, dkl, b, h, row, Tk, dk, ln);
  if constexpr (DV) store_rows<C>(dvt, dkl, b, h, row, Tk, dv, ln);
}

// ---------------------------------------------------------------------------
// Host launchers: each sets its kernels' shared-memory limit and launches on
// `stream`; returns the launch's cudaError_t.
// ---------------------------------------------------------------------------

// the forward over (q, k, v) into o (and lse when non-null), about
// `centres` [2, B, H, C] (c_k, c_v), or the first key's rows when null
template <int C>
cudaError_t run_fwd(const float* q, const float* k, const float* v, const float* centres, float* o,
                    float* lse, int B, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl,
                    Layout ol, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<C><<<dim3((Tq + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      q, k, v, centres, o, lse, H, Tq, Tk, ql, kl, vl, ol, scale);
  return cudaGetLastError();
}

// one key pass writing PART
template <int C, int PART>
cudaError_t run_kv(const float* q, const float* k, const float* v, const float* centres,
                   const float* dout, const float* lse, const float* delta, float* dk, float* dv,
                   int B, int H,
                   int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout dol, Layout dkl,
                   float scale, cudaStream_t stream) {
  constexpr int kv_smem = kv_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kv_kernel<C, PART>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<C, PART><<<dim3((Tk + BM - 1) / BM, H, B), THREADS, kv_smem, stream>>>(
      k, v, centres, q, dout, lse, delta, dk, dv, H, Tq, Tk, kl, vl, ql, dol, dkl, scale);
  return cudaGetLastError();
}

// the query pass (dq through dql), then the key pass (dk, dv through dkl;
// two of them at C = 96, dv then dk), about `centres` as run_fwd; the query
// pass computes delta from `o` (in do's layout) and writes it.
template <int C>
cudaError_t run_bwd(const float* q, const float* k, const float* v, const float* centres,
                    const float* dout, const float* o, const float* lse, float* delta, float* dq,
                    float* dk,
                    float* dv, int B, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl,
                    Layout dol, Layout dql, Layout dkl, float scale,
                    cudaStream_t stream) {
  constexpr int q_smem = q_smem_bytes<C>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attn_bwd_q_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem)))
    return err;
  attn_bwd_q_kernel<C><<<dim3((Tq + BM - 1) / BM, H, B), THREADS, q_smem, stream>>>(
      q, k, v, centres, dout, o, lse, delta, dq, H, Tq, Tk, ql, kl, vl, dol, dql, scale);
  if ((err = cudaGetLastError())) return err;
  if constexpr (split_kv<C>()) {
    err = run_kv<C, KV_DV>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql,
                                   kl, vl, dol, dkl, scale, stream);
    if (err != cudaSuccess) return err;
    return run_kv<C, KV_DK>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql,
                                    kl, vl, dol, dkl, scale, stream);
  } else {
    return run_kv<C, KV_BOTH>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql,
                                      kl, vl, dol, dkl, scale, stream);
  }
}

}  // namespace attn
