// Fully fused GTA attention backward for Hopper (sm_90a): fp32 accuracy, the
// attention core on the tensor cores (3xTF32 mma.sync, csrc/tf32x3.cuh).
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
// the C x C chains, against (3*Tq + 4*Tk)*C*4 bytes of inputs and outputs:
// bound by operations, at 165 TFLOP/s for fp32-accurate products on the
// tensor cores (3xTF32) or 67 TFLOP/s on the CUDA cores.
//
// What the design does about it (each launch of the C entry point runs up
// to eleven kernels on the stream):
//  * Every product of the core is 3xTF32 m16n8k8 mma.sync: a warp owns 16
//    rows, the other side streams through dynamic shared memory in
//    double-buffered tiles (cp.async) of 32 keys in the query pass (68 KB a
//    block, 3 blocks per SM) and 64 queries in the key pass (103 KB, 2 per
//    SM), and score accumulators feed the next product as A fragments in
//    place (tf32x3.cuh). Each tile's products start from zero and join the
//    running dq, dk, dv by rounded fp32 adds.
//  * The Pallas kernel sums dk, dv and dMk into one output block across a
//    grid that runs in order. Hopper's blocks run in parallel, so the work
//    is split by who owns each output row: a query pass (S, dP, dqt += dS kt)
//    writes dqt, and a key pass (S^T, dP^T, dvt += P^T do, dkt += dS^T qt)
//    writes dkt and dvt. No row is written by two blocks, so there are no
//    atomics and every sum has a fixed order: two launches on the same
//    inputs give bit-identical outputs. Both passes recompute p from the
//    forward's log-sum-exp: 7 core products where the function needs 5, the
//    price of having no cross-block sums.
//  * The C x C chains run outside the passes' loops, on the tensor cores
//    (csrc/gta_rows.cuh): do and delta before the passes (into
//    [B, H, Tq, C] scratch), then dq, dk, dv in place. qt, kt, vt are the
//    forward's residuals: no transform is recomputed.
//  * The matrix cotangents are a separate reduction, X^T Y over each view's
//    (row, head) pairs, itself a [C x rows] x [rows x C] product on the
//    tensor cores: each block sums a slice of one view's pairs into a
//    partial buffer, and a second kernel adds the slices in a fixed order.
// ptxas (CUDA 12.8, sm_90a), no spills anywhere: query pass 168 registers
// (3 blocks of 128 threads per SM), key pass 244 (2 blocks), dM reduction
// 120, its sum 30, row launches 94-114. Like the forward, the passes reach
// about half of mma.sync's rate (latency-bound at 8-12 warps per SM).
// Not yet: wgmma and TMA, 5 products in place of 7 (a cross-block sum
// of dk/dv).
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array; absent tables and unused scratch are null
// and flagged off. Returns the cudaError_t of the launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gta_rows.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using gta_rows::Layout;
using gta_rows::offset;
using gta_rows::RowJob;

constexpr int HAS_MQ = 1;
constexpr int HAS_MK = 2;
constexpr int HAS_MO = 4;
constexpr int HAS_ROTQ = 8;
constexpr int HAS_ROTK = 16;
constexpr int V_TRANSFORM = 32;

constexpr int HEAD_DIM = 64;  // the only head width instantiated
constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // own rows per block
constexpr int BN_Q = 32;        // keys per shared-memory tile in the query pass
constexpr int BN_K = 64;        // queries per shared-memory tile in the key pass
constexpr int THREADS = 32 * WARPS;
constexpr int DM_THREADS = 128;
constexpr int DM_ROWS = 32;  // (row, head) pairs staged per step in the dM reduction
constexpr float LOG2E = 1.4426950408889634f;

template <int C>
constexpr int q_smem_bytes() {
  // own qt and do rows, K and V tiles (two stages each): 3 blocks per SM
  return (2 * BM * (C + 4) + 2 * 2 * BN_Q * (C + 4)) * (int)sizeof(float);
}

template <int C>
constexpr int kv_smem_bytes() {
  // own K and V rows, Q and dO tiles (two stages each), lse and delta
  // tiles: 2 blocks per SM
  return (2 * BM * (C + 4) + 2 * 2 * BN_K * (C + 4) + 2 * 2 * BN_K) * (int)sizeof(float);
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
// tile sum
template <int C, int NT>
__device__ __forceinline__ void tile_product(float (&acc)[C / 8][4], const float (&A)[NT][4],
                                             const float* T, Lane ln) {
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
      mma3(t[n], a, split(bf));
    }
  }
  add_tile<C>(acc, t);
}

// ---------------------------------------------------------------------------
// Query pass: a warp per 16 query rows, looping over every key of (b, h).
// grid (ceil(Tq/BM), H, B). Writes dqt through `dql` (token-major, in the dq
// output, for the query chain to finish in place).
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, 3)
gta_bwd_q_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                 const float* __restrict__ vt, const float* __restrict__ do_s,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dqt, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl,
                 Layout dol, Layout dql, float scale) {
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;
  constexpr int NT = BN_Q / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qown = smem;               // [BM][LD]
  float* Down = Qown + BM * LD;     // [BM][LD]
  float* Ks = Down + BM * LD;       // [2][BN_Q][LD]
  float* Vs = Ks + 2 * BN_Q * LD;   // [2][BN_Q][LD]

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
  float dl[2] = {delta[hrow + ra], delta[hrow + rb]};

  float dq[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const float* kbase = kt + b * kl.bs + h * kl.hs;
  const float* vbase = vt + b * vl.bs + h * vl.hs;
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
      // products (rowsum(do * z) in exact arithmetic), so each row's dS sums
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

    // dqt += dS kt: the tile's product from zero, then a rounded add
    tile_product<C, NT>(dq, s, K, ln);
    __syncthreads();
  }
  store_rows<C>(dqt, dql, b, h, row, Tq, dq, ln);
}

// ---------------------------------------------------------------------------
// Key pass: a warp per 16 key rows, looping over every query of (b, h).
// grid (ceil(Tk/BM), H, B). Writes dkt and dvt through `dkl` (token-major,
// in the dk and dv outputs, for the key chain to finish in place).
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, 2)
gta_bwd_kv_kernel(const float* __restrict__ kt, const float* __restrict__ vt,
                  const float* __restrict__ qt, const float* __restrict__ do_s,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dkt, float* __restrict__ dvt, int H, int Tq, int Tk,
                  Layout kl, Layout vl, Layout ql, Layout dol, Layout dkl, float scale) {
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;
  constexpr int NT = BN_K / 8;
  extern __shared__ __align__(16) float smem[];
  float* Kown = smem;               // [BM][LD]
  float* Vown = Kown + BM * LD;     // [BM][LD]
  float* Qs = Vown + BM * LD;       // [2][BN_K][LD]
  float* Ds = Qs + 2 * BN_K * LD;   // [2][BN_K][LD]
  float* Ls = Ds + 2 * BN_K * LD;   // [2][BN_K]
  float* Dl = Ls + 2 * BN_K;        // [2][BN_K]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const Lane ln = lane_coords();
  const int warp = threadIdx.x / 32;
  const int k0 = blockIdx.x * BM;
  const int row[2] = {k0 + warp * 16 + ln.g, k0 + warp * 16 + ln.g + 8};

  const float* qbase = qt + b * ql.bs + h * ql.hs;
  const float* dbase = do_s + b * dol.bs + h * dol.hs;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const int ntiles = (Tq + BN_K - 1) / BN_K;
  stage_rows<C, BM, THREADS>(Kown, kt + offset(kl, b, h, k0), kl.rs, Tk - k0);
  stage_rows<C, BM, THREADS>(Vown, vt + offset(vl, b, h, k0), vl.rs, Tk - k0);
  stage_rows<C, BN_K, THREADS>(Qs, qbase, ql.rs, Tq);
  stage_rows<C, BN_K, THREADS>(Ds, dbase, dol.rs, Tq);
  stage_vec<BN_K, THREADS>(Ls, lse + hrow, Tq);
  stage_vec<BN_K, THREADS>(Dl, delta + hrow, Tq);
  cp_async_commit();

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
      const int q1 = (i + 1) * BN_K;
      stage_rows<C, BN_K, THREADS>(Qs + (buf ^ 1) * BN_K * LD, qbase + q1 * ql.rs, ql.rs, Tq - q1);
      stage_rows<C, BN_K, THREADS>(Ds + (buf ^ 1) * BN_K * LD, dbase + q1 * dol.rs, dol.rs, Tq - q1);
      stage_vec<BN_K, THREADS>(Ls + (buf ^ 1) * BN_K, lse + hrow + q1, Tq - q1);
      stage_vec<BN_K, THREADS>(Dl + (buf ^ 1) * BN_K, delta + hrow + q1, Tq - q1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Q = Qs + buf * BN_K * LD;
    const float* Dt = Ds + buf * BN_K * LD;
    const float* L = Ls + buf * BN_K;
    const float* Dlt = Dl + buf * BN_K;

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
      load_a(af, Vw, LD, 8 * ks, ln);
      const FragA av = split(af);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float bf[2];
        load_b_nk(bf, Q, LD, 8 * n, 8 * ks, ln);
        mma3_t(st[n], ak, split(bf));
        load_b_nk(bf, Dt, LD, 8 * n, 8 * ks, ln);
        mma3_t(dpt[n], av, split(bf));
      }
    }

    // P^T = exp(S^T * scale - lse[q]), dS^T = P^T (dP^T - delta[q]) * scale;
    // queries past Tq get 0
    const int qvalid = Tq - i * BN_K;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * n + 2 * ln.t + (e & 1);
        const float p = q < qvalid ? exp2f((st[n][e] * scale - L[q]) * LOG2E) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Dlt[q]) * scale;
      }
    }

    // dvt += P^T do, then dkt += dS^T qt: each tile's product from zero,
    // then a rounded add
    tile_product<C, NT>(dv, st, Dt, ln);
    tile_product<C, NT>(dk, dpt, Q, ln);
    __syncthreads();
  }
  store_rows<C>(dkt, dkl, b, h, row, Tk, dk, ln);
  store_rows<C>(dvt, dkl, b, h, row, Tk, dv, ln);
}

// ---------------------------------------------------------------------------
// Matrix cotangents: part[b, view, split] = sum over a slice of the view's
// (row, head) pairs of X1^T Y1 (+ X2^T Y2), on the tensor cores. X*, Y* are
// token-major [B, T, H*C], read as [B, T*H, C]: a view's pairs are
// contiguous, `rpv` of them. grid (splits, n, B); a warp owns 16 rows of the
// C x C output. Pairs stream through shared memory DM_ROWS at a time
// (double-buffered); each step's product starts from zero and joins the
// running sum by rounded fp32 adds, as in the passes.
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(DM_THREADS)
gta_bwd_dm_kernel(const float* __restrict__ X1, const float* __restrict__ Y1,
                  const float* __restrict__ X2, const float* __restrict__ Y2,
                  float* __restrict__ part, int64_t rows, int rpv, int splits) {
  static_assert(C == 16 * (DM_THREADS / 32), "a warp per 16 rows of the C x C output");
  constexpr int LD = C + 8;  // load_a_t and load_b_kn_std: conflict-free
  constexpr int KS = C / 8;
  __shared__ __align__(16) float Xs[2][DM_ROWS * LD];
  __shared__ __align__(16) float Ys[2][DM_ROWS * LD];
  const int slice = blockIdx.x;
  const int view = blockIdx.y;
  const int b = blockIdx.z;
  const int n = gridDim.y;
  const int per = (rpv + splits - 1) / splits;
  const int64_t v0 = (int64_t)view * rpv;
  const int64_t r0 = v0 + (slice * per < rpv ? slice * per : rpv);
  const int64_t r1 = r0 + per < v0 + rpv ? r0 + per : v0 + rpv;
  const Lane ln = lane_coords();
  const int m0 = 16 * (threadIdx.x / 32);

  float acc[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int pair = 0; pair < 2; ++pair) {
    const float* X = pair ? X2 : X1;
    const float* Y = pair ? Y2 : Y1;
    if (X == nullptr) continue;
    const float* xb = X + (int64_t)b * rows * C;
    const float* yb = Y + (int64_t)b * rows * C;
    const int steps = (int)((r1 - r0 + DM_ROWS - 1) / DM_ROWS);
    for (int st = 0; st < steps; ++st) {
      const int buf = st & 1;
      if (st == 0) {
        stage_rows<C, DM_ROWS, DM_THREADS, LD>(Xs[0], xb + r0 * C, C, (int)(r1 - r0));
        stage_rows<C, DM_ROWS, DM_THREADS, LD>(Ys[0], yb + r0 * C, C, (int)(r1 - r0));
        cp_async_commit();
      }
      if (st + 1 < steps) {
        const int64_t s1 = r0 + (int64_t)(st + 1) * DM_ROWS;
        stage_rows<C, DM_ROWS, DM_THREADS, LD>(Xs[buf ^ 1], xb + s1 * C, C, (int)(r1 - s1));
        stage_rows<C, DM_ROWS, DM_THREADS, LD>(Ys[buf ^ 1], yb + s1 * C, C, (int)(r1 - s1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float t[KS][4];
#pragma unroll
      for (int j = 0; j < KS; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DM_ROWS / 8; ++ks) {
        float af[4];
        load_a_t(af, Xs[buf], LD, m0, 8 * ks, ln);
        const FragA a = split(af);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          float bf[2];
          load_b_kn_std(bf, Ys[buf], LD, 8 * ks, 8 * j, ln);
          mma3(t[j], a, split(bf));
        }
      }
      add_tile<C>(acc, t);
      __syncthreads();  // every warp is done with this buffer before it is restaged
    }
  }
  float* out = part + (((int64_t)b * n + view) * splits + slice) * C * C;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int col = 8 * j + 2 * ln.t;
    *reinterpret_cast<float2*>(out + (m0 + ln.g) * C + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (m0 + ln.g + 8) * C + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

// dm[bn] = sum over splits of part[bn, split], in split order
template <int C>
__global__ void gta_bwd_dm_sum_kernel(const float* __restrict__ part, float* __restrict__ dm,
                                      int64_t total, int splits) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t bn = idx / (C * C), e = idx % (C * C);
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(bn * splits + k) * C * C + e];
  dm[idx] = s;
}

template <int C>
cudaError_t reduce_dm(const float* X1, const float* Y1, const float* X2, const float* Y2,
                      float* part, float* dm, int B, int n, int T, int H, int splits,
                      cudaStream_t stream) {
  const int rpv = (T / n) * H;
  gta_bwd_dm_kernel<C><<<dim3(splits, n, B), DM_THREADS, 0, stream>>>(X1, Y1, X2, Y2, part,
                                                                      (int64_t)T * H, rpv, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * n * C * C;
  gta_bwd_dm_sum_kernel<C><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, dm, total,
                                                                                splits);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, tables: the forward's inputs. g: the cotangent of its output.
// z, lse, qt, kt, vt: its residuals (qt null without a Q transform, kt
// null without a K/V transform, vt null without V_TRANSFORM). do_s
// [B, H, Tq, C], delta [B, H, Tq], dzq, dz [B, Tq, H*C], dzk, dzv
// [B, Tk, H*C] (each null where its flag is off) and part
// [B * max(nq * splits_q, nk * splits_k), C, C]: scratch.
extern "C" int gta_fused_bwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, const float* g, const float* z,
                             const float* lse, const float* qt, const float* kt, const float* vt,
                             float* do_s, float* delta, float* dzq, float* dz, float* dzk,
                             float* dzv, float* part, float* dq, float* dk, float* dv, float* dmq,
                             float* dmk, float* dmo, int B, int H, int Tq, int Tk, int c, int nq,
                             int nk, int splits_q, int splits_k, int flags, float scale,
                             void* stream_ptr) {
  constexpr int C = HEAD_DIM;
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool vt_flag = flags & V_TRANSFORM;
  const bool v_side = kv_tf && vt_flag;
  const bool has_mo = vt_flag && (flags & HAS_MO);
  const bool rq = flags & HAS_ROTQ, rk = flags & HAS_ROTK;
  if (c != C || B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      splits_q < 1 || splits_k < 1 || B > 65535 || H > 65535 || (q_tf && !qt) ||
      (kv_tf && !kt) || (v_side && !vt)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = gta_rows::tokens(Tq, H, C), tok_k = gta_rows::tokens(Tk, H, C);
  const Layout hf_q = gta_rows::heads_first(Tq, H, C), hf_k = gta_rows::heads_first(Tk, H, C);
  cudaError_t err;

  // output chain: dz = R_q(g) (stored for dMo), do = dz @ Mo^T, delta = rowsum(do * z)
  {
    const RowJob j{g, do_s, tok_q, hf_q, has_mo ? mo : nullptr, vt_flag && rq ? cq : nullptr,
                   vt_flag && rq ? sq : nullptr, has_mo ? dz : nullptr, z, delta, Tq, nq, 1, 0};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }

  const float* qp = q_tf ? qt : q;
  const float* kp = kv_tf ? kt : k;
  const float* vp = v_side ? vt : v;
  const Layout ql = q_tf ? hf_q : tok_q, kl = kv_tf ? hf_k : tok_k, vl = v_side ? hf_k : tok_k;

  constexpr int q_smem = q_smem_bytes<C>(), kv_smem = kv_smem_bytes<C>();
  if ((err = cudaFuncSetAttribute(gta_bwd_q_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  q_smem)))
    return (int)err;
  if ((err = cudaFuncSetAttribute(gta_bwd_kv_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem)))
    return (int)err;
  gta_bwd_q_kernel<C><<<dim3((Tq + BM - 1) / BM, H, B), THREADS, q_smem, stream>>>(
      qp, kp, vp, do_s, lse, delta, dq, H, Tq, Tk, ql, kl, vl, hf_q, tok_q, scale);
  if ((err = cudaGetLastError())) return (int)err;
  gta_bwd_kv_kernel<C><<<dim3((Tk + BM - 1) / BM, H, B), THREADS, kv_smem, stream>>>(
      kp, vp, qp, do_s, lse, delta, dk, dv, H, Tq, Tk, kl, vl, ql, hf_q, tok_k, scale);
  if ((err = cudaGetLastError())) return (int)err;

  // query chain, in place on dq: dzq = R_q^-1(dqt) (stored for dMq), dq = dzq @ Mq^T
  if (q_tf) {
    const RowJob j{dq, dq, tok_q, tok_q, flags & HAS_MQ ? mq : nullptr, rq ? cq : nullptr,
                   rq ? sq : nullptr, flags & HAS_MQ ? dzq : nullptr, nullptr, nullptr, Tq, nq,
                   1, 1};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }
  // key / value chains, in place on dk and dv
  if (kv_tf) {
    const float* Mk = flags & HAS_MK ? mk : nullptr;
    const RowJob jk{dk, dk, tok_k, tok_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                    Mk ? dzk : nullptr, nullptr, nullptr, Tk, nk, 1, 1};
    if ((err = gta_rows::run_rows<C>(jk, B, H, stream))) return (int)err;
    if (vt_flag) {
      const RowJob jv{dv, dv, tok_k, tok_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                      Mk ? dzv : nullptr, nullptr, nullptr, Tk, nk, 1, 1};
      if ((err = gta_rows::run_rows<C>(jv, B, H, stream))) return (int)err;
    }
  }

  if (flags & HAS_MQ) {
    err = reduce_dm<C>(q, dzq, nullptr, nullptr, part, dmq, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (has_mo) {
    err = reduce_dm<C>(z, dz, nullptr, nullptr, part, dmo, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (flags & HAS_MK) {
    err = reduce_dm<C>(k, dzk, vt_flag ? v : nullptr, vt_flag ? dzv : nullptr, part, dmk, B, nk,
                       Tk, H, splits_k, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" const char* gta_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
