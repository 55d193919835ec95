// Fully fused GTA attention backward for Hopper (sm_90a), in two precision
// policies: fp32 accuracy (the attention core as 3xTF32 mma.sync,
// csrc/tf32x3.cuh) and bf16 operands with fp32 accumulation (the attention
// core as wgmma fed by TMA, csrc/attn_sm90.cuh).
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
//                 (dp, delta and dqt = ds kt about the means of the kt
//                 and vt rows: csrc/attn_core.cuh)
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
// to thirteen kernels on the stream, fourteen at C = 96):
//  * The attention core's two passes (csrc/attn_core.cuh, shared with
//    flash_core): every product 3xTF32 m16n8k8 mma.sync, split by who owns
//    each output row. The Pallas kernel sums dk, dv and dMk into one output
//    block across a grid that runs in order; Hopper's blocks run in
//    parallel, so a query pass writes dqt and a key pass writes dkt and dvt.
//    No row is written by two blocks, so there are no atomics and every sum
//    has a fixed order: two launches on the same inputs give bit-identical
//    outputs. Both passes recompute p from the forward's log-sum-exp: 7 core
//    products where the function needs 5.
//  * The C x C chains run outside the passes' loops, on the tensor cores
//    (csrc/gta_rows.cuh): do before the passes (into token-major scratch,
//    the layout of z; the query pass computes delta), then dq, dk, dv in
//    place. qt, kt, vt are the
//    forward's residuals: no transform is recomputed.
//  * The matrix cotangents are a separate reduction, X^T Y over each view's
//    (row, head) pairs, itself a [C x rows] x [rows x C] product on the
//    tensor cores: each block sums a slice of one view's pairs into a
//    partial buffer, and a second kernel adds the slices in a fixed order.
//  * bf16 (`gta_fused_bwd_bf16`): the cotangent, do and the core's
//    operands are bf16 (qt, and transformed kt, vt centred on their means:
//    the forward's residuals; raw rows as they are). The core is
//    csrc/attn_sm90.cuh's query pass and one key pass (wgmma, TMA-fed
//    tiles, no dv/dk split at either head width); it writes dqt, dkt, dvt
//    in fp32, the chains (bf16 products, the TPU kernel's rounding) read
//    them in fp32 and write dq, dk, dv in bf16, and the dM reduction reads
//    the bf16 q, k, v, z beside the fp32 chain rows, rounded to bf16 as the
//    TPU kernel rounds them, with fp32 sums (`gta_bwd_dm_bf16_kernel`). The
//    core takes delta from its own products, so z is read for dMo alone.
// Instances: head width C = 64 (CLEVR-TR) and C = 96 (msn), dispatched on
// the C argument; at C = 96 the fp32 core runs two key passes
// (attn_core.cuh) and the dM reduction 6 warps a block. Registers and
// spills of every kernel: PERF.md.
// Not yet, fp32: wgmma and TMA, 5 products in place of 7 (attn_core.cuh).
//
// Interface: plain C, bound from Python with ctypes. `gta_fused_bwd`: every
// pointer a contiguous fp32 device array. `gta_fused_bwd_bf16`: q, k, v, g,
// z, qt, kt, vt, do_s and dq, dk, dv bf16, the rest fp32. Absent tables and
// unused scratch are null and flagged off. Returns the cudaError_t of the
// launches (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_core.cuh"
#include "attn_sm90.cuh"
#include "gta_rows.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using attn::bf16;
using attn::Layout;
using gta_rows::RowJob;
using gta_rows::RowJobT;

constexpr int HAS_MQ = 1;
constexpr int HAS_MK = 2;
constexpr int HAS_MO = 4;
constexpr int HAS_ROTQ = 8;
constexpr int HAS_ROTK = 16;
constexpr int V_TRANSFORM = 32;

constexpr int DM_ROWS = 32;  // (row, head) pairs staged per step in the dM reduction

// a warp per 16 rows of the C x C output
template <int C>
__host__ __device__ constexpr int dm_threads() {
  return 32 * (C / 16);
}

template <int C>
__host__ __device__ constexpr int dm_smem_bytes() {
  return 2 * 2 * DM_ROWS * (C + 8) * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// Matrix cotangents: part[b, view, split] = sum over a slice of the view's
// (row, head) pairs of X1^T Y1 (+ X2^T Y2), on the tensor cores. X*, Y* are
// token-major [B, T, H*C], read as [B, T*H, C]: a view's pairs are
// contiguous, `rpv` of them. grid (splits, n, B); a warp owns 16 rows of the
// C x C output. Pairs stream through dynamic shared memory DM_ROWS at a time
// (double-buffered; 36 KB at C = 64, 52 KB at C = 96); each step's product
// starts from zero and joins the running sum by rounded fp32 adds, as in
// the passes. The fp32 instance's form (the bf16 one's is below).
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(dm_threads<C>())
gta_bwd_dm_kernel(const float* __restrict__ X1, const float* __restrict__ Y1,
                  const float* __restrict__ X2, const float* __restrict__ Y2,
                  float* __restrict__ part, int64_t rows, int rpv, int splits) {
  constexpr int THREADS = dm_threads<C>();
  static_assert(C == 16 * (THREADS / 32), "a warp per 16 rows of the C x C output");
  constexpr int LD = C + 8;  // load_a_t and load_b_kn_std: conflict-free
  constexpr int KS = C / 8;
  extern __shared__ __align__(16) float smem[];
  constexpr int STAGE = DM_ROWS * LD;
  float* Xs = smem;              // [2][DM_ROWS][LD]
  float* Ys = smem + 2 * STAGE;  // [2][DM_ROWS][LD]
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
        stage_rows<C, DM_ROWS, THREADS, LD>(Xs, xb + r0 * C, C, (int)(r1 - r0));
        stage_rows<C, DM_ROWS, THREADS, LD>(Ys, yb + r0 * C, C, (int)(r1 - r0));
        cp_async_commit();
      }
      if (st + 1 < steps) {
        const int64_t s1 = r0 + (int64_t)(st + 1) * DM_ROWS;
        stage_rows<C, DM_ROWS, THREADS, LD>(Xs + (buf ^ 1) * STAGE, xb + s1 * C, C, (int)(r1 - s1));
        stage_rows<C, DM_ROWS, THREADS, LD>(Ys + (buf ^ 1) * STAGE, yb + s1 * C, C, (int)(r1 - s1));
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
        load_a_t(af, Xs + buf * STAGE, LD, m0, 8 * ks, ln);
        const FragA a = split(af);
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          float bf[2];
          load_b_kn_std(bf, Ys + buf * STAGE, LD, 8 * ks, 8 * j, ln);
          mma3(t[j], a, split(bf));
        }
      }
      attn::add_tile<C>(acc, t);
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

// The bf16 instance's form of gta_bwd_dm_kernel: the TPU kernel's rounding
// (`_dot` with mxu = bfloat16), X and Y rounded to bf16, one bf16
// m16n8k16 product a step with fp32 accumulation across every step (a
// chain's truncation, ~1e-7 of the sum a step, is far below the operands'
// rounding; scripts/probe_wgmma.py). A warp owns 16 rows of the C x C
// output; DM_ROWS_BF16 pairs a step staged as [DM_ROWS_BF16][C + 8] bf16
// tiles (18 KB at C = 64, 26 KB at C = 96). Same grid and partial sums.
constexpr int DM_ROWS_BF16 = 64;

template <int C>
__host__ __device__ constexpr int dm_bf16_smem_bytes() {
  return 2 * DM_ROWS_BF16 * (C + 8) * (int)sizeof(bf16);
}

// DM_ROWS_BF16 rows of X and Y (row stride C) in registers, a thread's
// share of them, zero at or past n; then rounded to bf16 into
// [DM_ROWS_BF16][C + 8] tiles. The next step's rows load while this
// step's products run.
template <int C>
struct DmRows {
  static constexpr int PER = DM_ROWS_BF16 * C / 4 / dm_threads<C>();
  float4 x[PER], y[PER];

  __device__ __forceinline__ void load(const bf16* xb, const float* yb, int n) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * dm_threads<C>();
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      x[i] = y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n) {
        x[i] = attn::load4(xb + (int64_t)r * C + 4 * c4);
        y[i] = attn::load4(yb + (int64_t)r * C + 4 * c4);
      }
    }
  }

  __device__ __forceinline__ void store(bf16* Xs, bf16* Ys) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * dm_threads<C>();
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      attn::store4(Xs + r * (C + 8) + 4 * c4, x[i]);
      attn::store4(Ys + r * (C + 8) + 4 * c4, y[i]);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(dm_threads<C>())
gta_bwd_dm_bf16_kernel(const bf16* __restrict__ X1, const float* __restrict__ Y1, const bf16* __restrict__ X2,
                       const float* __restrict__ Y2, float* __restrict__ part, int64_t rows, int rpv,
                       int splits) {
  constexpr int LD = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [DM_ROWS_BF16][LD]
  bf16* Ys = Xs + DM_ROWS_BF16 * LD;             // [DM_ROWS_BF16][LD]
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

  float acc[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int pair = 0; pair < 2; ++pair) {
    const bf16* X = pair ? X2 : X1;
    const float* Y = pair ? Y2 : Y1;
    if (X == nullptr) continue;
    const bf16* xb = X + (int64_t)b * rows * C;
    const float* yb = Y + (int64_t)b * rows * C;
    auto count = [&](int64_t s0) { return (int)(r1 - s0 < DM_ROWS_BF16 ? r1 - s0 : DM_ROWS_BF16); };
    DmRows<C> rowsr;
    if (r0 < r1) rowsr.load(xb + r0 * C, yb + r0 * C, count(r0));
    for (int64_t s0 = r0; s0 < r1; s0 += DM_ROWS_BF16) {
      rowsr.store(Xs, Ys);
      __syncthreads();
      const int64_t s1 = s0 + DM_ROWS_BF16;
      if (s1 < r1) rowsr.load(xb + s1 * C, yb + s1 * C, count(s1));
#pragma unroll
      for (int ks = 0; ks < DM_ROWS_BF16 / 16; ++ks) {
        uint32_t a[4];
        bf16mma::load_a_t(a, Xs, LD, m0, 16 * ks);
#pragma unroll
        for (int j = 0; j < C / 8; j += 2) {
          uint32_t bb[4];
          bf16mma::load_b_kn2(bb, Ys, LD, 16 * ks, 8 * j);
          bf16mma::mma(acc[j], a, bb[0], bb[1]);
          bf16mma::mma(acc[j + 1], a, bb[2], bb[3]);
        }
      }
      __syncthreads();  // every warp is done with the tiles before they are restaged
    }
  }
  float* out = part + (((int64_t)b * n + view) * splits + slice) * C * C;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const int col = 8 * j + 2 * ln.t;
    *reinterpret_cast<float2*>(out + (m0 + ln.g) * C + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (m0 + ln.g + 8) * C + col) = make_float2(acc[j][2], acc[j][3]);
  }
}

template <int C, class TX>
cudaError_t reduce_dm(const TX* X1, const float* Y1, const TX* X2, const float* Y2,
                      float* part, float* dm, int B, int n, int T, int H, int splits,
                      cudaStream_t stream) {
  const int rpv = (T / n) * H;
  const dim3 grid(splits, n, B);
  cudaError_t err;
  if constexpr (sizeof(TX) == sizeof(bf16)) {
    constexpr int smem = dm_bf16_smem_bytes<C>();
    err = cudaFuncSetAttribute(gta_bwd_dm_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gta_bwd_dm_bf16_kernel<C><<<grid, dm_threads<C>(), smem, stream>>>(X1, Y1, X2, Y2, part, (int64_t)T * H,
                                                                       rpv, splits);
  } else {
    constexpr int smem = dm_smem_bytes<C>();
    err = cudaFuncSetAttribute(gta_bwd_dm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gta_bwd_dm_kernel<C><<<grid, dm_threads<C>(), smem, stream>>>(X1, Y1, X2, Y2, part, (int64_t)T * H, rpv,
                                                                  splits);
  }
  if ((err = cudaGetLastError())) return err;
  const int64_t total = (int64_t)B * n * C * C;
  gta_bwd_dm_sum_kernel<C><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, dm, total,
                                                                                splits);
  return cudaGetLastError();
}

// q, k, v, tables: the forward's inputs. g: the cotangent of its output.
// z, lse, qt, kt, vt: its residuals (qt null without a Q transform, kt
// null without a K/V transform, vt null without V_TRANSFORM). do_s
// [B, Tq, H*C], delta [B, H, Tq], dzq, dz [B, Tq, H*C], dzk, dzv
// [B, Tk, H*C] (each null where its flag is off), part
// [B * max(nq * splits_q, nk * splits_k), C, C] and centres [2, B, H, C]:
// scratch.
template <int C>
int fused_bwd(const float* q, const float* k, const float* v, const float* mq, const float* mk,
              const float* mo, const float* cq, const float* sq, const float* ck, const float* sk,
              const float* g, const float* z, const float* lse, const float* qt, const float* kt,
              const float* vt, float* do_s, float* delta, float* dzq, float* dz, float* dzk,
              float* dzv, float* part, float* centres, float* dq, float* dk, float* dv, float* dmq,
              float* dmk, float* dmo, int B, int H, int Tq, int Tk, int nq, int nk, int splits_q,
              int splits_k, int flags, float scale, void* stream_ptr) {
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool vt_flag = flags & V_TRANSFORM;
  const bool v_side = kv_tf && vt_flag;
  const bool has_mo = vt_flag && (flags & HAS_MO);
  const bool rq = flags & HAS_ROTQ, rk = flags & HAS_ROTK;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      splits_q < 1 || splits_k < 1 || B > 65535 || H > 65535 || (q_tf && !qt) ||
      (kv_tf && !kt) || (v_side && !vt) || !centres) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = attn::tokens(Tq, H, C), tok_k = attn::tokens(Tk, H, C);
  const Layout hf_q = attn::heads_first(Tq, H, C), hf_k = attn::heads_first(Tk, H, C);
  cudaError_t err;

  // output chain: dz = R_q(g) (stored for dMo), do = dz @ Mo^T
  {
    const RowJob j{g, do_s, tok_q, tok_q, has_mo ? mo : nullptr, vt_flag && rq ? cq : nullptr,
                   vt_flag && rq ? sq : nullptr, has_mo ? dz : nullptr, Tq, nq, 1, 0};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }

  const float* qp = q_tf ? qt : q;
  const float* kp = kv_tf ? kt : k;
  const float* vp = v_side ? vt : v;
  const Layout ql = q_tf ? hf_q : tok_q, kl = kv_tf ? hf_k : tok_k, vl = v_side ? hf_k : tok_k;

  // the core's centres, as the forward took them: the means of the key and
  // value rows
  if ((err = attn::run_mean<C>(kp, kl, Tk, B, H, centres, stream))) return (int)err;
  if ((err = attn::run_mean<C>(vp, vl, Tk, B, H, centres + (int64_t)B * H * C, stream)))
    return (int)err;

  // the core's passes: dqt into dq (delta = rowsum(do * (z - c_v)) on the
  // way), dkt and dvt into dk and dv
  err = attn::run_bwd<C>(qp, kp, vp, centres, do_s, z, lse, delta, dq, dk, dv, B, H, Tq, Tk, ql, kl, vl, tok_q,
                         tok_q, tok_k, scale, stream);
  if (err != cudaSuccess) return (int)err;

  // query chain, in place on dq: dzq = R_q^-1(dqt) (stored for dMq), dq = dzq @ Mq^T
  if (q_tf) {
    const RowJob j{dq, dq, tok_q, tok_q, flags & HAS_MQ ? mq : nullptr, rq ? cq : nullptr,
                   rq ? sq : nullptr, flags & HAS_MQ ? dzq : nullptr, Tq, nq, 1, 1};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }
  // key / value chains, in place on dk and dv
  if (kv_tf) {
    const float* Mk = flags & HAS_MK ? mk : nullptr;
    const RowJob jk{dk, dk, tok_k, tok_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                    Mk ? dzk : nullptr, Tk, nk, 1, 1};
    if ((err = gta_rows::run_rows<C>(jk, B, H, stream))) return (int)err;
    if (vt_flag) {
      const RowJob jv{dv, dv, tok_k, tok_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                      Mk ? dzv : nullptr, Tk, nk, 1, 1};
      if ((err = gta_rows::run_rows<C>(jv, B, H, stream))) return (int)err;
    }
  }

  if (flags & HAS_MQ) {
    err = reduce_dm<C, float>(q, dzq, nullptr, nullptr, part, dmq, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (has_mo) {
    err = reduce_dm<C, float>(z, dz, nullptr, nullptr, part, dmo, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (flags & HAS_MK) {
    err = reduce_dm<C, float>(k, dzk, vt_flag ? v : nullptr, vt_flag ? dzv : nullptr, part, dmk, B, nk,
                       Tk, H, splits_k, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}


// The bf16 instance. q, k, v, g, z: the forward's bf16 inputs, cotangent and
// residual; lse, qt, kt, vt: its residuals, null as for the fp32 instance
// (kt, vt centred on their means). do_s [B, Tq, H*C] bf16, delta,
// dzq, dz, dzk, dzv as above, dq32 [B, Tq, H*C], dk32 and dv32 [B, Tk, H*C]
// (fp32, the core's gradients before the chains) and part: scratch.
template <int C>
int fused_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mq, const float* mk,
                   const float* mo, const float* cq, const float* sq, const float* ck,
                   const float* sk, const bf16* g, const bf16* z, const float* lse, const bf16* qt,
                   const bf16* kt, const bf16* vt, bf16* do_s, float* delta, float* dzq, float* dz,
                   float* dzk, float* dzv, float* dq32, float* dk32, float* dv32, float* part,
                   bf16* dq, bf16* dk, bf16* dv, float* dmq, float* dmk, float* dmo, int B, int H,
                   int Tq, int Tk, int nq, int nk, int splits_q, int splits_k, int flags, float scale,
                   void* stream_ptr) {
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool vt_flag = flags & V_TRANSFORM;
  const bool has_mo = vt_flag && (flags & HAS_MO);
  const bool rq = flags & HAS_ROTQ, rk = flags & HAS_ROTK;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      splits_q < 1 || splits_k < 1 || B > 65535 || H > 65535 || (q_tf && !qt) || (kv_tf && !kt) ||
      (kv_tf && vt_flag && !vt) || !dq32 || !dk32 || !dv32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = attn::tokens(Tq, H, C), tok_k = attn::tokens(Tk, H, C);
  const Layout hf_q = attn::heads_first(Tq, H, C), hf_k = attn::heads_first(Tk, H, C);
  const float* Mk = flags & HAS_MK ? mk : nullptr;
  cudaError_t err;

  // output chain: dz = R_q(g) (stored for dMo), do = dz @ Mo^T, in bf16
  {
    const RowJobT<bf16, bf16> j{g, do_s, tok_q, tok_q, has_mo ? mo : nullptr,
                                vt_flag && rq ? cq : nullptr, vt_flag && rq ? sq : nullptr,
                                has_mo ? dz : nullptr, Tq, nq, 1, 0};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }

  // the core's passes over the residuals (transformed kt, vt centred; raw
  // rows as they are): dqt, dkt, dvt in fp32
  const bool v_side = kv_tf && vt_flag;
  err = sm90::run_bwd<sm90::Cfg<C>>(q_tf ? qt : q, kv_tf ? kt : k, v_side ? vt : v, do_s, lse, delta, dq32,
                                    dk32, dv32, B, H, Tq, Tk, q_tf ? hf_q : tok_q, kv_tf ? hf_k : tok_k,
                                    v_side ? hf_k : tok_k, tok_q, tok_q, tok_k, scale, stream);
  if (err != cudaSuccess) return (int)err;

  // query chain into bf16 dq: dzq = R_q^-1(dqt) (stored for dMq), dq = dzq @ Mq^T
  {
    const RowJobT<float, bf16> j{dq32, dq, tok_q, tok_q, flags & HAS_MQ ? mq : nullptr,
                                 rq ? cq : nullptr, rq ? sq : nullptr,
                                 flags & HAS_MQ ? dzq : nullptr, Tq, nq, 1, 1};
    if ((err = gta_rows::run_rows<C>(j, B, H, stream))) return (int)err;
  }
  // key / value chains into bf16 dk, dv
  {
    const RowJobT<float, bf16> jk{dk32, dk, tok_k, tok_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                                  Mk ? dzk : nullptr, Tk, nk, 1, 1};
    if ((err = gta_rows::run_rows<C>(jk, B, H, stream))) return (int)err;
    const RowJobT<float, bf16> jv{dv32, dv, tok_k, tok_k, v_side ? Mk : nullptr,
                                  v_side && rk ? ck : nullptr, v_side && rk ? sk : nullptr,
                                  v_side && Mk ? dzv : nullptr, Tk, nk, 1, 1};
    if ((err = gta_rows::run_rows<C>(jv, B, H, stream))) return (int)err;
  }

  if (flags & HAS_MQ) {
    err = reduce_dm<C, bf16>(q, dzq, nullptr, nullptr, part, dmq, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (has_mo) {
    err = reduce_dm<C, bf16>(z, dz, nullptr, nullptr, part, dmo, B, nq, Tq, H, splits_q, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (flags & HAS_MK) {
    err = reduce_dm<C, bf16>(k, dzk, vt_flag ? v : nullptr, vt_flag ? dzv : nullptr, part, dmk, B,
                             nk, Tk, H, splits_k, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int gta_fused_bwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, const float* g, const float* z,
                             const float* lse, const float* qt, const float* kt, const float* vt,
                             float* do_s, float* delta, float* dzq, float* dz, float* dzk,
                             float* dzv, float* part, float* centres, float* dq, float* dk,
                             float* dv, float* dmq, float* dmk, float* dmo, int B, int H, int Tq,
                             int Tk, int C, int nq, int nk, int splits_q, int splits_k, int flags,
                             float scale, void* stream_ptr) {
  if (C == 64) {
    return fused_bwd<64>(q, k, v, mq, mk, mo, cq, sq, ck, sk, g, z, lse, qt, kt, vt, do_s, delta,
                         dzq, dz, dzk, dzv, part, centres, dq, dk, dv, dmq, dmk, dmo, B, H, Tq, Tk,
                         nq, nk, splits_q, splits_k, flags, scale, stream_ptr);
  }
  if (C == 96) {
    return fused_bwd<96>(q, k, v, mq, mk, mo, cq, sq, ck, sk, g, z, lse, qt, kt, vt, do_s, delta,
                         dzq, dz, dzk, dzv, part, centres, dq, dk, dv, dmq, dmk, dmo, B, H, Tq, Tk,
                         nq, nk, splits_q, splits_k, flags, scale, stream_ptr);
  }
  return (int)cudaErrorInvalidValue;  // no instance of this head width
}

extern "C" int gta_fused_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mq,
                                  const float* mk, const float* mo, const float* cq,
                                  const float* sq, const float* ck, const float* sk, const bf16* g,
                                  const bf16* z, const float* lse, const bf16* qt, const bf16* kt,
                                  const bf16* vt, bf16* do_s, float* delta, float* dzq, float* dz,
                                  float* dzk, float* dzv, float* dq32, float* dk32, float* dv32,
                                  float* part, bf16* dq, bf16* dk, bf16* dv, float* dmq, float* dmk,
                                  float* dmo, int B, int H, int Tq, int Tk, int C, int nq, int nk,
                                  int splits_q, int splits_k, int flags, float scale,
                                  void* stream_ptr) {
  if (C == 64) {
    return fused_bwd_bf16<64>(q, k, v, mq, mk, mo, cq, sq, ck, sk, g, z, lse, qt, kt, vt, do_s, delta,
                              dzq, dz, dzk, dzv, dq32, dk32, dv32, part, dq, dk, dv, dmq, dmk, dmo, B,
                              H, Tq, Tk, nq, nk, splits_q, splits_k, flags, scale, stream_ptr);
  }
  if (C == 96) {
    return fused_bwd_bf16<96>(q, k, v, mq, mk, mo, cq, sq, ck, sk, g, z, lse, qt, kt, vt, do_s, delta,
                              dzq, dz, dzk, dzv, dq32, dk32, dv32, part, dq, dk, dv, dmq, dmk, dmo, B,
                              H, Tq, Tk, nq, nk, splits_q, splits_k, flags, scale, stream_ptr);
  }
  return (int)cudaErrorInvalidValue;  // no instance of this head width
}

extern "C" const char* gta_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
