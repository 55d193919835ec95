// Per-row C x C transforms and SO(2) rotors of fused GTA attention, shared
// by csrc/gta_fused_fwd.cu and csrc/gta_fused_bwd.cu.
//
// The attention core of both kernels (csrc/attn_core.cuh) runs over
// operands that are already transformed. Every per-row chain runs here
// instead, outside the core's loops:
//   forward form   y = R(x @ M[view])                 (qt, kt, vt; out = R^-1(z @ Mo))
//   backward form  w = R(x), y = w @ M[view]^T        (do, dq, dk, dv)
// with R(x) = c*x + s*swap(x), R^-1(x) = c*x - s*swap(x), swap(x0, x1) =
// (-x1, x0) on lane pairs, per-view row-major [C, C] matrices and per-lane
// rotor tables [B, T, C]; a row's view is row / (T / n_views). M and the
// rotor tables may each be absent (then the job is a copy, converting
// between the element types). The backward form can also store w (the
// matrix cotangents' input, fp32).
//
// Element types: rows are read as TI and written as TO, fp32 or bf16
// (`RowJobT`); M and the rotor tables are fp32, rotors run in fp32. The
// bf16 instances of the fused kernels read bf16 q, k, v and cotangents,
// write fp32 kt, vt for the core's centring (attn_core.cuh
// `centre_bf16_kernel`) or bf16 qt, and turn the core's fp32 gradients into
// bf16 dq, dk, dv.
//
// What bounds it: 2*C*C flops per row and matrix against 8*C bytes moved
// (16 flops per byte at C = 64, 24 at C = 96): by bytes at the tensor cores' rate, by
// operations on the CUDA cores. So a chain with a matrix runs on the tensor
// cores: a block owns 64 rows of one view of one (b, h) (the bf16 kernel 4
// x 64; blocks never straddle a view), stages the view's matrix and its rows
// in dynamic shared memory, and each warp multiplies 16 rows by M (or M^T)
// with mma.sync.
// Rotors act on the output fragments, whose column pairs (2t, 2t+1) are
// rotor pairs, or on the rows as they are staged. Chains with no matrix
// (rotors alone) run one row per thread. The product's precision follows
// the job's element types:
//  * fp32 rows in and out (the fp32 instances): 3xTF32 like the fp32
//    attention core (csrc/tf32x3.cuh), m16n8k8, fp32 tiles (36 KB at
//    C = 64, 64 KB at C = 96). The small-part products gather in an
//    accumulator of their own, so the large part's truncating tensor-core
//    chain is 8 steps long.
//  * bf16 rows on either side (the bf16 instances): the TPU kernel's
//    rounding (`_per_view` with mxu = bfloat16): the row (after the
//    backward form's rotor) and M rounded to bf16, one bf16 m16n8k16 product
//    with fp32 accumulation (csrc/bf16_mma.cuh), bf16 tiles (18 KB at C = 64,
//    33 KB at C = 96).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_core.cuh"  // Layout: the operands' (batch, head, row) strides; element I/O
#include "tf32x3.cuh"

namespace gta_rows {

using attn::Layout;
using attn::offset;

constexpr int ROW_THREADS = 128;
constexpr int MMA_ROWS = 64;  // rows per block of the tensor-core kernel (4 warps x 16)
constexpr int BF16_CHUNKS = 4;  // MMA_ROWS-row chunks per block of the bf16 kernel (M staged once)

// M is read as B[k][n] = M[k][n] (forward form) or M[n][k] (backward form);
// each wants its own row stride for conflict-free fragment loads
template <int C, bool BWD>
__host__ __device__ constexpr int ldm() {
  return BWD ? C + 4 : C + 8;
}

template <int C, bool BWD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (C * ldm<C, BWD>() + MMA_ROWS * (C + 4)) * (int)sizeof(float);
}

// the bf16 products' tiles: M [C][C + 8] and the rows [MMA_ROWS][C + 8]
template <int C>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return (C + MMA_ROWS) * (C + 8) * (int)sizeof(attn::bf16);
}

// whether a job's products take the bf16 instances' rounding
template <class TI, class TO>
__host__ __device__ constexpr bool bf16_job() {
  return sizeof(TI) == 2 || sizeof(TO) == 2;
}

template <int C, class TI>
__device__ __forceinline__ void load_row(const TI* __restrict__ src, float (&x)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4 t = attn::load4(src + 4 * i);
    x[4 * i] = t.x;
    x[4 * i + 1] = t.y;
    x[4 * i + 2] = t.z;
    x[4 * i + 3] = t.w;
  }
}

template <int C, class TO>
__device__ __forceinline__ void store_row(TO* __restrict__ dst, const float (&x)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    attn::store4(dst + 4 * i, make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]));
  }
}

// x <- c*x + sg*s*swap(x), sg = +1 (R) or -1 (R^-1)
template <int C>
__device__ __forceinline__ void rotate(float (&x)[C], const float* __restrict__ c,
                                       const float* __restrict__ s, float sg) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const float4* s4 = reinterpret_cast<const float4*>(s);
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

// One transform of every (b, h, row < T) of an operand. m, c/s and mid may
// be null. src and dst may be the same array (every row is read before it
// is written, by the block that writes it). mid is token-major [B, T, H*C].
template <class TI, class TO>
struct RowJobT {
  const TI* src;
  TO* dst;
  Layout src_l, dst_l;
  const float* m;  // [B, n_views, C, C]
  const float* c;  // [B, T, C]
  const float* s;
  float* mid;
  int T, n_views;
  int backward;  // 0: y = R(x @ M); 1: w = R(x), y = w @ M^T
  int inverse;   // R^-1 in place of R
};
using RowJob = RowJobT<float, float>;

// A job without a matrix: y = R(x), one row per thread.
// grid (ceil(T/ROW_THREADS), H, B).
template <int C, class TI, class TO>
__global__ void __launch_bounds__(ROW_THREADS) gta_rows_kernel(const RowJobT<TI, TO> j, int H) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (row >= j.T) return;
  const int64_t roff = ((int64_t)b * j.T + row) * C;
  const int64_t tok = ((int64_t)b * j.T + row) * H * C + (int64_t)h * C;

  float x[C];
  load_row<C>(j.src + offset(j.src_l, b, h, row), x);
  if (j.c) rotate<C>(x, j.c + roff, j.s + roff, j.inverse ? -1.f : 1.f);
  if (j.mid) store_row<C>(j.mid + tok, x);
  store_row<C>(j.dst + offset(j.dst_l, b, h, row), x);
}

// The output of warp w's 16 rows from its product fragments y (rows (g,
// g+8), channels 8n + 2t (+1): a rotor pair): the forward form's rotor,
// then the store of rows below n_rows
template <int C, bool BWD, class TI, class TO>
__device__ __forceinline__ void store_out(const RowJobT<TI, TO>& j, const float (&y)[C / 8][4], int b, int h,
                                          int r0, int n_rows, int w, tf32x3::Lane ln) {
  const float sg = j.inverse ? -1.f : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = w * 16 + ln.g + 8 * r;
    const bool ok = lr < n_rows;
    const int row = r0 + min(lr, n_rows - 1);
    const int64_t roff = ((int64_t)b * j.T + row) * C;
    TO* dst = j.dst + offset(j.dst_l, b, h, row);
    float2 cc[C / 8], ss[C / 8];  // the row's rotor pairs, every load in flight before the stores
    if (!BWD && j.c) {
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        cc[n] = __ldg(reinterpret_cast<const float2*>(j.c + roff + 8 * n + 2 * ln.t));
        ss[n] = __ldg(reinterpret_cast<const float2*>(j.s + roff + 8 * n + 2 * ln.t));
      }
    }
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const int col = 8 * n + 2 * ln.t;
      float y0 = y[n][2 * r];
      float y1 = y[n][2 * r + 1];
      if (!BWD && j.c) {
        const float a0 = y0, a1 = y1;
        y0 = cc[n].x * a0 - sg * ss[n].x * a1;
        y1 = cc[n].y * a1 + sg * ss[n].y * a0;
      }
      if (ok) attn::store2(dst + col, y0, y1);
    }
  }
}

// rows [0, MMA_ROWS) of the block into a [MMA_ROWS][ld] tile of TX (fp32 or
// bf16), zero at or past n_rows; BWD: w = R(x) as they are staged (and
// stored to mid, fp32)
template <int C, bool BWD, class TI, class TO, class TX>
__device__ __forceinline__ void stage_job_rows(const RowJobT<TI, TO>& j, TX* Xs, int ld, int b, int h, int r0,
                                               int n_rows, int H) {
  constexpr int PER = MMA_ROWS * C / 4 / ROW_THREADS;  // groups of 4 elements a thread
  constexpr int BATCH = 4;                             // loads in flight a thread
  static_assert(PER % BATCH == 0, "whole batches");
  const float sg = j.inverse ? -1.f : 1.f;
#pragma unroll
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float4 x[BATCH], cc[BATCH], ss[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {  // every load of the batch first
      const int idx = threadIdx.x + (i0 + i) * ROW_THREADS;
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      x[i] = cc[i] = ss[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows) {
        const int row = r0 + r;
        x[i] = attn::load4(j.src + offset(j.src_l, b, h, row) + 4 * c4);
        if (BWD && j.c) {
          const int64_t roff = ((int64_t)b * j.T + row) * C + 4 * c4;
          cc[i] = __ldg(reinterpret_cast<const float4*>(j.c + roff));
          ss[i] = __ldg(reinterpret_cast<const float4*>(j.s + roff));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int idx = threadIdx.x + (i0 + i) * ROW_THREADS;
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      if (BWD && j.c) {
        x[i] = make_float4(cc[i].x * x[i].x - sg * ss[i].x * x[i].y, cc[i].y * x[i].y + sg * ss[i].y * x[i].x,
                           cc[i].z * x[i].z - sg * ss[i].z * x[i].w, cc[i].w * x[i].w + sg * ss[i].w * x[i].z);
      }
      if (BWD && j.mid && r < n_rows) {
        const int64_t tok = ((int64_t)b * j.T + r0 + r) * H * C + (int64_t)h * C;
        reinterpret_cast<float4*>(j.mid + tok)[c4] = x[i];
      }
      attn::store4(Xs + r * ld + 4 * c4, x[i]);
    }
  }
}

// The same transform for a job with a matrix, on the tensor cores.
// grid (ceil(T / n_views / MMA_ROWS), H, B * n_views).
template <int C, bool BWD, class TI, class TO>
__global__ void __launch_bounds__(ROW_THREADS) gta_rows_mma_kernel(const RowJobT<TI, TO> j, int H) {
  using namespace tf32x3;
  static_assert(ROW_THREADS == 2 * MMA_ROWS, "a warp per 16 rows");
  constexpr int LDX = C + 4;
  constexpr int LDM = ldm<C, BWD>();
  constexpr int KS = C / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ms = smem;          // [C][LDM]
  float* Xs = Ms + C * LDM;  // [MMA_ROWS][LDX]

  const int b = blockIdx.z / j.n_views;
  const int view = blockIdx.z % j.n_views;
  const int h = blockIdx.y;
  const int rpv = j.T / j.n_views;
  const int l0 = blockIdx.x * MMA_ROWS;
  const int n_rows = min(MMA_ROWS, rpv - l0);
  const int r0 = view * rpv + l0;

  const float* M = j.m + ((int64_t)b * j.n_views + view) * C * C;
  for (int idx = threadIdx.x; idx < C * C / 4; idx += ROW_THREADS) {
    const int r = idx / (C / 4), c4 = idx % (C / 4);
    cp_async16(Ms + r * LDM + 4 * c4, M + r * C + 4 * c4, true);
  }
  if constexpr (!BWD && sizeof(TI) == sizeof(float)) {
    stage_rows<C, MMA_ROWS, ROW_THREADS>(Xs, reinterpret_cast<const float*>(j.src) + offset(j.src_l, b, h, r0),
                                         j.src_l.rs, n_rows);
  } else {  // rows converted to fp32 as they are staged; BWD: w = R(x) (and stored to mid)
    stage_job_rows<C, BWD>(j, Xs, LDX, b, h, r0, n_rows, H);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Y = X M (X M^T) for this warp's 16 rows: large parts in `big`, the two
  // small-part products in `small`
  const Lane ln = lane_coords();
  const int w = threadIdx.x / 32;
  const float* Xw = Xs + w * 16 * LDX;
  float big[KS][4], small[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float af[4];
    load_a(af, Xw, LDX, 8 * ks, ln);
    const FragA a = split(af);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      float bf[2];
      if (BWD) {
        load_b_nk(bf, Ms, LDM, 8 * n, 8 * ks, ln);
      } else {
        load_b_kn_std(bf, Ms, LDM, 8 * ks, 8 * n, ln);
      }
      const FragB bb = split(bf);
      mma_tf32(small[n], a.lo, bb.hi);
      mma_tf32(small[n], a.hi, bb.lo);
      mma_tf32(big[n], a.hi, bb.hi);
    }
  }

#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) big[n][e] += small[n][e];
  }
  store_out<C, BWD>(j, big, b, h, r0, n_rows, w, ln);
}

// The bf16 instances' form of gta_rows_mma_kernel: M and the staged rows
// rounded to bf16, one bf16 product with fp32 accumulation. M stays
// row-major in shared memory: the forward form reads B[k][n] = M[k][n]
// (ldmatrix.trans), the backward form B[k][n] = M[n][k]. A block stages M
// once for BF16_CHUNKS chunks of 64 rows of its view.
// grid (ceil(T / n_views / (MMA_ROWS * BF16_CHUNKS)), H, B * n_views).
template <int C, bool BWD, class TI, class TO>
__global__ void __launch_bounds__(ROW_THREADS) gta_rows_bf16_kernel(const RowJobT<TI, TO> j, int H) {
  static_assert(ROW_THREADS == 2 * MMA_ROWS, "a warp per 16 rows");
  using attn::bf16;
  constexpr int LD = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ms = reinterpret_cast<bf16*>(smem_raw);  // [C][LD]
  bf16* Xs = Ms + C * LD;                        // [MMA_ROWS][LD]

  const int b = blockIdx.z / j.n_views;
  const int view = blockIdx.z % j.n_views;
  const int h = blockIdx.y;
  const int rpv = j.T / j.n_views;

  const float* M = j.m + ((int64_t)b * j.n_views + view) * C * C;
  for (int idx = threadIdx.x; idx < C * C / 4; idx += ROW_THREADS) {
    const int r = idx / (C / 4), c4 = idx % (C / 4);
    attn::store4(Ms + r * LD + 4 * c4, __ldg(reinterpret_cast<const float4*>(M + r * C + 4 * c4)));
  }
  const int w = threadIdx.x / 32;
  const bf16* Xw = Xs + w * 16 * LD;
  const tf32x3::Lane ln = tf32x3::lane_coords();
  for (int chunk = 0; chunk < BF16_CHUNKS; ++chunk) {
    const int l0 = (blockIdx.x * BF16_CHUNKS + chunk) * MMA_ROWS;
    if (l0 >= rpv) break;
    const int n_rows = min(MMA_ROWS, rpv - l0);
    const int r0 = view * rpv + l0;
    stage_job_rows<C, BWD>(j, Xs, LD, b, h, r0, n_rows, H);
    __syncthreads();
    float y[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t a[4];
      bf16mma::load_a(a, Xw, LD, 16 * ks);
#pragma unroll
      for (int n = 0; n < C / 8; n += 2) {
        uint32_t bb[4];
        if constexpr (BWD) {
          bf16mma::load_b_nk2(bb, Ms, LD, 8 * n, 16 * ks);
        } else {
          bf16mma::load_b_kn2(bb, Ms, LD, 16 * ks, 8 * n);
        }
        bf16mma::mma(y[n], a, bb[0], bb[1]);
        bf16mma::mma(y[n + 1], a, bb[2], bb[3]);
      }
    }
    store_out<C, BWD>(j, y, b, h, r0, n_rows, w, ln);
    __syncthreads();  // every warp is done with Xs before it is restaged
  }
}

template <int C, bool BWD, class TI, class TO>
cudaError_t run_rows_mma(const RowJobT<TI, TO>& j, int B, int H, cudaStream_t stream) {
  const int rpv = j.T / j.n_views;
  auto launch = [&](void (*kernel)(const RowJobT<TI, TO>, int), int smem, int rows_per_block) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((rpv + rows_per_block - 1) / rows_per_block, H, B * j.n_views);
    kernel<<<grid, ROW_THREADS, smem, stream>>>(j, H);
    return cudaGetLastError();
  };
  if constexpr (bf16_job<TI, TO>()) {
    return launch(gta_rows_bf16_kernel<C, BWD, TI, TO>, bf16_smem_bytes<C>(), MMA_ROWS * BF16_CHUNKS);
  } else {
    return launch(gta_rows_mma_kernel<C, BWD, TI, TO>, mma_smem_bytes<C, BWD>(), MMA_ROWS);
  }
}

template <int C, class TI, class TO>
cudaError_t run_rows(const RowJobT<TI, TO>& j, int B, int H, cudaStream_t stream) {
  if (j.m) {
    return j.backward ? run_rows_mma<C, true>(j, B, H, stream) : run_rows_mma<C, false>(j, B, H, stream);
  } else {
    const dim3 grid((j.T + ROW_THREADS - 1) / ROW_THREADS, H, B);
    gta_rows_kernel<C, TI, TO><<<grid, ROW_THREADS, 0, stream>>>(j, H);
  }
  return cudaGetLastError();
}

}  // namespace gta_rows
