// The fp32 softmax attention core of the attention kernels of this
// directory, forward and backward, on Hopper's tensor cores at fp32
// accuracy (3xTF32 mma.sync, csrc/tf32x3.cuh), the JAX package's fp32
// policy. Shared by the fp32 instances of the fused GTA kernels
// (csrc/gta_fused_fwd.cu, csrc/gta_fused_bwd.cu), which run it over the
// transformed qt, kt, vt of their row launches, and of flash_core
// (csrc/flash_core_fwd.cu, csrc/flash_core_bwd.cu), which runs it over the
// raw token-major q, k, v. (The bf16 instances of both run
// csrc/attn_sm90.cuh.) It is the attention core of the TPU kernels
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
// k, v and its output o in their places. The file also holds what the
// kernels of this directory share around their cores: `Layout`, element
// I/O in fp32 and bf16, and the centre launches.
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) forward, 10*Tq*Tk*C
// backward (the function's 5 products), against a few bytes per row: 75 to
// 300 flops per byte at this repo's shapes (Tk = 600 to 1280, Tq = 600 to
// 16384). So it is bound by operations: at 165 TFLOP/s for fp32-accurate
// products on the tensor cores (3xTF32, 495 / 3).
//
// What the design does about it:
//  * Every product is one warp-level 3xTF32 m16n8k8 mma.sync. A block of 4
//    warps owns 64 rows, a warp 16; the other side streams through dynamic
//    shared memory in double-buffered tiles (cp.async). Score accumulators
//    feed the next product as A fragments in place (tf32x3.cuh renames
//    their columns).
//  * Forward (attn_fwd_kernel): K/V tiles of 32 keys (70 KB a block at
//    C = 64, 3 blocks per SM; 102 KB at C = 96, 2; the block's q rows split
//    into TF32 parts once, in shared memory). The online softmax lives in
//    the S accumulators, its row max reduced across each quad of lanes by
//    shuffles, and stays in the scores' units, so that where one key
//    dominates, lse = max exactly.
//  * Backward: Hopper's blocks run in parallel, so the work is split by who
//    owns each output row. A query pass (attn_bwd_q_kernel: S, dP, dq += dS k;
//    32-key tiles) writes dq; a key pass (attn_bwd_kv_kernel: S^T, dP^T,
//    dv += P^T do, dk += dS^T q; 64-query tiles, 2 blocks per SM) writes dk
//    and dv. At C = 96 one key pass would hold 96 accumulator floats a
//    thread for dk and dv, 48 for a tile product's partial sum and 64 for
//    S^T and dP^T: past the 255 registers of a thread. So C = 96 runs two
//    key passes over 32-query tiles: one writes dv (S^T, P^T do), the other
//    dk (S^T, dP^T, dS^T q). No row is written by two blocks: no atomics,
//    every sum in a fixed order, bit-identical reruns. Both passes
//    recompute P from lse.
//  * Centres: a layer's rows share a large component. The core takes
//    o = c_v + P (v - c_v), dP = do (v - c_v)^T and dq = dS (k - c_k) about
//    centre rows c_k, c_v of each (b, h) (exact rewrites: P's rows sum to 1,
//    dS's to 0; scores about k - c_k shift each row by q.c_k, which the
//    softmax ignores), subtracted in the kernels: the tensor cores truncate
//    each sum by ~1e-6 of its value, which about uncentred rows broke the
//    cancellation in dq. Every caller centres about the means of the rows
//    it hands the core (`centres` [2, B, H, C], from `run_mean`): flash_core
//    its raw k, v rows, the fused GTA kernels their kt, vt rows.
//  * delta = rowsum(do * (o - c_v)) in the query pass's prologue; when
//    every key fits one tile, it takes delta = rowsum(P * dP) from its own
//    products, so each row's dS sums to zero as the plain version's does
//    (one key: dS = 0 exactly). (From its own products over more tiles, a
//    first sweep, left it 2-3x further from fp64 on rows with a common
//    component, PERF.md.)
//  * Precision: the tensor-core accumulation truncates (tf32x3.cuh), so
//    every mma chain is one shared-memory tile long, starts from zero and
//    joins its running sum by rounded fp32 adds.
//  * Ragged Tq and Tk need no padding: rows past the end are zero-filled,
//    masked (-inf scores, p = 0) and store nothing.
// ptxas registers and spills of every instance: chip_smoke.py's build report
// (PERF.md's kernel table).
// Not yet: wgmma and TMA (wgmma's TF32 form takes only K-major operands, so
// P*V needs a transposed V tile); 5 backward products in place of 7 (a
// cross-block sum of dk/dv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace attn {

using namespace tf32x3;
using bf16 = __nv_bfloat16;

// strides (elements) of an operand over (batch, head, row)
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

// shared-memory tiles are [rows][C + PAD] fp32 elements (conflict-free
// fragment loads)
constexpr int PAD = 4;
constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // own rows per block
constexpr int BN = 32;          // keys per shared-memory tile in the forward
constexpr int BN_Q = 32;        // keys per shared-memory tile in the query pass
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// blocks per SM of the forward and the query pass (their launch bounds):
// 3 at C = 64; at C = 96 shared memory (102 KB a block at fp32) and
// registers allow 2
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

// bytes of a [rows][C + PAD] fp32 tile
template <int C>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * (C + PAD) * (int)sizeof(float);
}

template <int C>
__host__ __device__ constexpr int fwd_smem_bytes() {
  // q rows (TF32 big and small parts), K and V tiles (two stages each), the
  // centre of V
  return 2 * tile_bytes<C>(BM) + 2 * 2 * tile_bytes<C>(BN) + C * (int)sizeof(float);
}

template <int C>
__host__ __device__ constexpr int q_smem_bytes() {
  // own q and do rows, K and V tiles (two stages each), the centres of K
  // and V
  return 2 * tile_bytes<C>(BM) + 2 * 2 * tile_bytes<C>(BN_Q) + 2 * C * (int)sizeof(float);
}

template <int C>
__host__ __device__ constexpr int kv_smem_bytes() {
  // own K and V rows, Q and dO tiles (two stages each), lse and delta
  // tiles, the centre of V: 2 blocks per SM
  return 2 * tile_bytes<C>(BM) + 2 * 2 * tile_bytes<C>(bn_k<C>()) + (2 * 2 * bn_k<C>() + C) * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// Element I/O in fp32 or bf16 (4 or 2 consecutive elements, converted to or
// from fp32), for the kernels of this directory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  uint2 u;
  u.x = bf16mma::pack(x.x, x.y);
  u.y = bf16mma::pack(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rows [0, ROWS) of an operand whose row r starts at base + r * rs
// (elements, 16-byte aligned) into a [ROWS][C + PAD] tile by cp.async;
// rows at or past n are zero-filled. Every thread of the block calls it.
template <int C, int ROWS>
__device__ __forceinline__ void stage(float* tile, const float* base, int64_t rs, int n) {
  constexpr int CHUNKS = C / 4;  // 16-byte chunks of a row
  constexpr int LD = C + PAD;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool ok = r < n;
    cp_async16(tile + r * LD + 4 * c, base + (ok ? r : 0) * rs + 4 * c, ok);
  }
}

// the centre rows of (b, h): c_k (which 0) or c_v (which 1)
// from `centres` [2][B][H][C]; grids are (row blocks, H, B)
template <int C>
__device__ __forceinline__ const float* centre_row(const float* centres, int which, int b, int h, int H) {
  return centres + (((int64_t)which * gridDim.z + b) * H + h) * C;
}

// rows (g, g+8) of an accumulator tile [16 x C] into an fp32 operand,
// through (batch, head, row) strides; rows at or past T are not stored
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

// ---------------------------------------------------------------------------
// The products (3xTF32)
// ---------------------------------------------------------------------------

// s += A T^T over the C channels: A the warp's 16 own rows [16][C + PAD], T
// a tile of 8*NT rows [8*NT][C + PAD]; s[n] holds rows (g, g+8), T rows
// 8n + 2t (+1). With PRESPLIT, A holds TF32 big parts and A_lo the small
// parts (`split_rows`); with SWAP, the key pass's order of the three TF32
// products (`mma3_t`: S^T = K Q^T equals S = Q K^T bit for bit).
template <int C, int NT, bool SWAP = false, bool PRESPLIT = false>
__device__ __forceinline__ void qk_product(float (&s)[NT][4], const float* A, const float* T, Lane ln,
                                           const float* A_lo = nullptr) {
  constexpr int LD = C + PAD;
#pragma unroll
  for (int ks = 0; ks < C / 8; ++ks) {
    FragA a;
    if constexpr (PRESPLIT) {
      load_a_split(a, A, A_lo, LD, 8 * ks, ln);
    } else {
      float af[4];
      load_a(af, A, LD, 8 * ks, ln);
      a = split(af);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float bf[2];
      load_b_nk(bf, T, LD, 8 * n, 8 * ks, ln);
      if constexpr (SWAP) {
        mma3_t(s[n], a, split(bf));
      } else {
        mma3(s[n], a, split(bf));
      }
    }
  }
}

// t += A T for a [16 x 8*NT] accumulator tile A (its 8-column tiles are the
// k-steps) and an [8*NT x C] shared-memory tile T; with CENTER:
// A (T - centre) for a row `centre` [C] in shared memory
template <int C, int NT, bool CENTER = false>
__device__ __forceinline__ void tile_mma(float (&t)[C / 8][4], const float (&A)[NT][4], const float* T, Lane ln,
                                         const float* centre = nullptr) {
  constexpr int LD = C + PAD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float af[4];
    a_from_acc(af, A[j]);
    const FragA a = split(af);
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      float bf[2];
      load_b_kn(bf, T, LD, 8 * j, 8 * n, ln);
      if constexpr (CENTER) {  // both elements are channel 8n + g
        const float c = centre[8 * n + ln.g];
        bf[0] -= c;
        bf[1] -= c;
      }
      mma3(t[n], a, split(bf));
    }
  }
}

// acc += A T through a zeroed tile sum joined by rounded fp32 adds
template <int C, int NT, bool CENTER = false>
__device__ __forceinline__ void tile_product(float (&acc)[C / 8][4], const float (&A)[NT][4], const float* T,
                                             Lane ln, const float* centre = nullptr) {
  float t[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n) t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
  tile_mma<C, NT, CENTER>(t, A, T, ln, centre);
  add_tile<C>(acc, t);
}

// rows [0, ROWS) of a [ROWS][C + 4] fp32 tile in shared memory minus
// `centre` [C]; every thread of the block calls it
template <int C, int ROWS>
__device__ __forceinline__ void centre_rows(float* tile, const float* centre) {
  for (int idx = threadIdx.x; idx < ROWS * C / 4; idx += THREADS) {
    float4* x = reinterpret_cast<float4*>(tile + (idx / (C / 4)) * (C + 4) + 4 * (idx % (C / 4)));
    const float4 c = reinterpret_cast<const float4*>(centre)[idx % (C / 4)];
    *x = make_float4(x->x - c.x, x->y - c.y, x->z - c.z, x->w - c.w);
  }
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
attn_fwd_kernel(const float* __restrict__ qt, const float* __restrict__ kt, const float* __restrict__ vt,
                const float* __restrict__ centres, float* __restrict__ z, float* __restrict__ lse, int H, int Tq,
                int Tk, Layout ql, Layout kl, Layout vl, Layout zl, float scale) {
  static_assert(C % 16 == 0, "head width must be a multiple of 16");
  constexpr int LD = C + PAD;
  constexpr int KS = C / 8;   // 8-channel tiles
  constexpr int NT = BN / 8;  // 8-key tiles per K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [BM][LD] qt: TF32 big parts
  float* Ql = Qh + BM * LD;                        // [BM][LD] the small parts
  float* Ks = Ql + BM * LD;                        // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;                    // [2][BN][LD]
  float* Cv = Vs + 2 * BN * LD;                    // [C] c_v

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

  // qt rows (split once, as every warp reads them at every K tile) and the
  // first K/V tile; rows past Tq are zero and store nothing
  const float* kbase = kt + b * kl.bs + h * kl.hs;
  const float* vbase = vt + b * vl.bs + h * vl.hs;
  const int ntiles = (Tk + BN - 1) / BN;
  stage<C, BM>(Qh, qt + offset(ql, b, h, q0), ql.rs, Tq - q0);
  stage<C, BN>(Ks, kbase, kl.rs, Tk);
  stage<C, BN>(Vs, vbase, vl.rs, Tk);
  cp_async_commit();
  const float* cv = centre_row<C>(centres, 1, b, h, H);
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
      stage<C, BN>(Ks + (buf ^ 1) * BN * LD, kbase + k1 * kl.rs, kl.rs, Tk - k1);
      stage<C, BN>(Vs + (buf ^ 1) * BN * LD, vbase + k1 * vl.rs, vl.rs, Tk - k1);
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
    qk_product<C, NT, false, true>(s, Qhw, K, ln, Qlw);

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

    // O = alpha * O + P (vt - c_v). The tile's product starts from zero and
    // joins O by a rounded fp32 add (the tensor cores' accumulation
    // truncates; tf32x3.cuh).
    float pv[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
    tile_mma<C, NT, true>(pv, s, V, ln, Cv);
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
      store2(zr + 8 * n + 2 * ln.t, acc[n][2 * r] * inv + c.x, acc[n][2 * r + 1] * inv + c.y);
    }
    if (lse && ln.t == 0) lse[((int64_t)b * H + h) * Tq + row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// Query pass: a warp per 16 query rows, looping over every key of (b, h).
// grid (ceil(Tq/BM), H, B). Writes dq (fp32) through `dql`, and delta.
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
// delta = rowsum(do * (o - c_v)) from `o` (the forward's output, in do's
// layout) in the prologue, written for the key pass.
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, min_blocks<C>())
attn_bwd_q_kernel(const float* __restrict__ qt, const float* __restrict__ kt, const float* __restrict__ vt,
                  const float* __restrict__ centres, const float* __restrict__ do_s, const float* __restrict__ o,
                  const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dqt, int H, int Tq,
                  int Tk, Layout ql, Layout kl, Layout vl, Layout dol, Layout dql, float scale) {
  constexpr int LD = C + PAD;
  constexpr int KS = C / 8;
  constexpr int NT = BN_Q / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qown = reinterpret_cast<float*>(smem_raw);  // [BM][LD]
  float* Down = Qown + BM * LD;                      // [BM][LD]
  float* Ks = Down + BM * LD;                        // [2][BN_Q][LD]
  float* Vs = Ks + 2 * BN_Q * LD;                    // [2][BN_Q][LD]
  float* Ck = Vs + 2 * BN_Q * LD;                    // [C] c_k
  float* Cv = Ck + C;                                // [C] c_v

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const Lane ln = lane_coords();
  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * BM;
  const int row[2] = {q0 + warp * 16 + ln.g, q0 + warp * 16 + ln.g + 8};
  const int ra = min(row[0], Tq - 1), rb = min(row[1], Tq - 1);
  stage<C, BM>(Qown, qt + offset(ql, b, h, q0), ql.rs, Tq - q0);
  stage<C, BM>(Down, do_s + offset(dol, b, h, q0), dol.rs, Tq - q0);
  const float* Qw = Qown + warp * 16 * LD;
  const float* Dw = Down + warp * 16 * LD;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const float ls[2] = {lse[hrow + ra], lse[hrow + rb]};
  const float* kbase = kt + b * kl.bs + h * kl.hs;
  const float* vbase = vt + b * vl.bs + h * vl.hs;
  const float* ck = centre_row<C>(centres, 0, b, h, H);
  const float* cv = centre_row<C>(centres, 1, b, h, H);
  for (int i = threadIdx.x; i < C; i += THREADS) {  // read after the loop's first barrier
    Ck[i] = ck[i];
    Cv[i] = cv[i];
  }
  // delta = rowsum(do * (o - c_v)): this lane's channels 8n + 2t (+1),
  // summed across the quad
  float dl[2];
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
  stage<C, BN_Q>(Ks, kbase, kl.rs, Tk);
  stage<C, BN_Q>(Vs, vbase, vl.rs, Tk);
  cp_async_commit();

  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      const int k1 = (i + 1) * BN_Q;
      stage<C, BN_Q>(Ks + (buf ^ 1) * BN_Q * LD, kbase + k1 * kl.rs, kl.rs, Tk - k1);
      stage<C, BN_Q>(Vs + (buf ^ 1) * BN_Q * LD, vbase + k1 * vl.rs, vl.rs, Tk - k1);
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
    qk_product<C, NT>(s, Qw, K, ln);
    qk_product<C, NT>(dp, Dw, V, ln);

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
// grid (ceil(Tk/BM), H, B). Writes dk and dv (fp32) through `dkl` (PART
// KV_BOTH), or dv alone (KV_DV: S^T and P^T do) or dk alone (KV_DK). Its
// dP^T is (v - c_v) do^T, as in the query pass.
// ---------------------------------------------------------------------------
template <int C, int PART>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_kv_kernel(const float* __restrict__ kt, const float* __restrict__ vt, const float* __restrict__ centres,
                   const float* __restrict__ qt, const float* __restrict__ do_s, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dkt, float* __restrict__ dvt, int H, int Tq,
                   int Tk, Layout kl, Layout vl, Layout ql, Layout dol, Layout dkl, float scale) {
  constexpr int LD = C + PAD;
  constexpr int KS = C / 8;
  constexpr int BNK = bn_k<C>();
  constexpr int NT = BNK / 8;
  constexpr bool DV = PART != KV_DK, DK = PART != KV_DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kown = reinterpret_cast<float*>(smem_raw);  // [BM][LD]
  float* Vown = Kown + BM * LD;                      // [BM][LD] (dk)
  float* Qs = Vown + BM * LD;                        // [2][BNK][LD]
  float* Ds = Qs + 2 * BNK * LD;                     // [2][BNK][LD]
  float* Ls = Ds + 2 * BNK * LD;                     // [2][BNK]
  float* Dl = Ls + 2 * BNK;                          // [2][BNK] (dk)
  float* Cv = Dl + 2 * BNK;                          // [C] c_v (dk)

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
  stage<C, BM>(Kown, kt + offset(kl, b, h, k0), kl.rs, Tk - k0);
  if constexpr (DK) stage<C, BM>(Vown, vt + offset(vl, b, h, k0), vl.rs, Tk - k0);
  stage<C, BNK>(Qs, qbase, ql.rs, Tq);
  stage<C, BNK>(Ds, dbase, dol.rs, Tq);
  stage_vec<BNK, THREADS>(Ls, lse + hrow, Tq);
  if constexpr (DK) stage_vec<BNK, THREADS>(Dl, delta + hrow, Tq);
  cp_async_commit();
  if constexpr (DK) {  // read after the loop's first barrier
    const float* cv = centre_row<C>(centres, 1, b, h, H);
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
      stage<C, BNK>(Qs + (buf ^ 1) * BNK * LD, qbase + q1 * ql.rs, ql.rs, Tq - q1);
      stage<C, BNK>(Ds + (buf ^ 1) * BNK * LD, dbase + q1 * dol.rs, dol.rs, Tq - q1);
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
    // (+1); mma3_t sums the query pass's products in its order, so
    // both passes see the same P and dS bit for bit
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
    qk_product<C, NT, true>(st, Kw, Q, ln);
    if constexpr (DK) qk_product<C, NT, true>(dpt, Vw, Dt, ln);

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
// Centres around the cores
// ---------------------------------------------------------------------------

// centre[b, h, :] = the mean of the T rows of (b, h) of `src`: the centre
// the fused GTA kernels take the core's products about. With GRID (the bf16
// instances), each channel's mean rounded to a multiple of the bf16 ulp of
// the channel's largest magnitude: rows whose elements are bf16 already
// (channels a transform leaves as they are) then stay exact when centred,
// where a centre off that grid would round every one of them by the same
// amount, an error that no average over keys removes (relative L2 6.5e-3
// against the bf16 emulation's 4.2e-3 at 2100 keys; 3.7e-3 on the grid).
// grid (H, B), C * MEAN_SPLIT threads: each sums every MEAN_SPLIT-th row of
// one channel, then the block adds the partial sums in a fixed order
// (bit-identical reruns).
constexpr int MEAN_SPLIT = 8;

template <int C, bool GRID = false>
__global__ void __launch_bounds__(C * MEAN_SPLIT)
mean_rows_kernel(const float* __restrict__ src, const Layout l, int T, float* __restrict__ centre) {
  __shared__ float part[MEAN_SPLIT][C], peak[GRID ? MEAN_SPLIT : 1][C];
  const int b = blockIdx.y, h = blockIdx.x;
  const int c = threadIdx.x % C, sp = threadIdx.x / C;
  const float* p = src + b * l.bs + h * l.hs + c;
  float acc = 0.f, mx = 0.f;
  for (int r = sp; r < T; r += MEAN_SPLIT) {
    const float x = p[r * l.rs];
    acc += x;
    if constexpr (GRID) mx = fmaxf(mx, fabsf(x));
  }
  part[sp][c] = acc;
  if constexpr (GRID) peak[sp][c] = mx;
  __syncthreads();
  if (sp == 0) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < MEAN_SPLIT; ++i) sum += part[i][c];
    float mean = sum / T;
    if constexpr (GRID) {
#pragma unroll
      for (int i = 0; i < MEAN_SPLIT; ++i) mx = fmaxf(mx, peak[i][c]);
      if (mx > 0.f) {
        const float ulp = exp2f(floorf(log2f(mx)) - 7.f);  // bf16: 8 significant bits
        mean = rintf(mean / ulp) * ulp;
      }
    }
    centre[((int64_t)b * gridDim.x + h) * C + c] = mean;
  }
}

template <int C, bool GRID = false>
cudaError_t run_mean(const float* src, Layout l, int T, int B, int H, float* centre,
                     cudaStream_t stream) {
  mean_rows_kernel<C, GRID><<<dim3(H, B), C * MEAN_SPLIT, 0, stream>>>(src, l, T, centre);
  return cudaGetLastError();
}

// dst[b, h, t, :] = bf16(src row t of (b, h) - centre[b, h, :]), dst
// heads-first [B, H, T, C]: the centred bf16 rows that the fused GTA
// kernels' bf16 instances give csrc/attn_sm90.cuh, the
// difference of fp32 rows taken before the rounding. grid
// (ceil(T*C/4 / 256), H, B).
constexpr int CENTRE_THREADS = 256;

template <int C>
__global__ void __launch_bounds__(CENTRE_THREADS)
centre_bf16_kernel(const float* __restrict__ src, const Layout l, int T,
                   const float* __restrict__ centre, bf16* __restrict__ dst) {
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int idx = blockIdx.x * CENTRE_THREADS + threadIdx.x;
  if (idx >= T * (C / 4)) return;
  const int r = idx / (C / 4), c4 = idx % (C / 4);
  const float4 x = load4(src + offset(l, b, h, r) + 4 * c4);
  const float4 c = reinterpret_cast<const float4*>(centre + ((int64_t)b * H + h) * C)[c4];
  store4(dst + (((int64_t)b * H + h) * T + r) * C + 4 * c4,
         make_float4(x.x - c.x, x.y - c.y, x.z - c.z, x.w - c.w));
}

// the mean of the fp32 rows of (b, h) of `src`, on the bf16 grid of their
// largest magnitude, into `centre` [B, H, C], then the rows minus it into
// `dst` (bf16, heads-first)
template <int C>
cudaError_t run_centre_bf16(const float* src, Layout l, int T, int B, int H, float* centre,
                            bf16* dst, cudaStream_t stream) {
  cudaError_t err = run_mean<C, true>(src, l, T, B, H, centre, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((T * (C / 4) + CENTRE_THREADS - 1) / CENTRE_THREADS, H, B);
  centre_bf16_kernel<C><<<grid, CENTRE_THREADS, 0, stream>>>(src, l, T, centre, dst);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host launchers: each sets its kernels' shared-memory limit and launches on
// `stream`; returns the launch's cudaError_t.
// ---------------------------------------------------------------------------

// the forward over (q, k, v) into o (and lse when non-null), about
// `centres` [2, B, H, C] (c_k, c_v)
template <int C>
cudaError_t run_fwd(const float* q, const float* k, const float* v, const float* centres, float* o, float* lse,
                    int B, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout ol, float scale,
                    cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<C><<<dim3((Tq + BM - 1) / BM, H, B), THREADS, smem, stream>>>(
      q, k, v, centres, o, lse, H, Tq, Tk, ql, kl, vl, ol, scale);
  return cudaGetLastError();
}

// one key pass writing PART
template <int C, int PART>
cudaError_t run_kv(const float* q, const float* k, const float* v, const float* centres, const float* dout,
                   const float* lse, const float* delta, float* dk, float* dv, int B, int H, int Tq, int Tk,
                   Layout ql, Layout kl, Layout vl, Layout dol, Layout dkl, float scale, cudaStream_t stream) {
  constexpr int kv_smem = kv_smem_bytes<C>();
  cudaError_t err =
      cudaFuncSetAttribute(attn_bwd_kv_kernel<C, PART>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<C, PART><<<dim3((Tk + BM - 1) / BM, H, B), THREADS, kv_smem, stream>>>(
      k, v, centres, q, dout, lse, delta, dk, dv, H, Tq, Tk, kl, vl, ql, dol, dkl, scale);
  return cudaGetLastError();
}

// the query pass (dq through dql, delta from `o`, in do's layout), then the
// key pass (dk, dv through dkl; two of them at C = 96, dv then dk), about
// `centres` as run_fwd
template <int C>
cudaError_t run_bwd(const float* q, const float* k, const float* v, const float* centres, const float* dout,
                    const float* o, const float* lse, float* delta, float* dq, float* dk, float* dv, int B, int H,
                    int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout dol, Layout dql, Layout dkl, float scale,
                    cudaStream_t stream) {
  constexpr int q_smem = q_smem_bytes<C>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attn_bwd_q_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem)))
    return err;
  attn_bwd_q_kernel<C><<<dim3((Tq + BM - 1) / BM, H, B), THREADS, q_smem, stream>>>(
      q, k, v, centres, dout, o, lse, delta, dq, H, Tq, Tk, ql, kl, vl, dol, dql, scale);
  if ((err = cudaGetLastError())) return err;
  if constexpr (split_kv<C>()) {
    err = run_kv<C, KV_DV>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql, kl, vl, dol, dkl, scale,
                           stream);
    if (err != cudaSuccess) return err;
    return run_kv<C, KV_DK>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql, kl, vl, dol, dkl, scale,
                            stream);
  } else {
    return run_kv<C, KV_BOTH>(q, k, v, centres, dout, lse, delta, dk, dv, B, H, Tq, Tk, ql, kl, vl, dol, dkl,
                              scale, stream);
  }
}

}  // namespace attn
