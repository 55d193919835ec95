// Fully fused GTA attention forward for Hopper (sm_90a): fp32 accuracy, the
// attention core on the tensor cores (3xTF32 mma.sync, csrc/tf32x3.cuh).
//
// Replaces gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` (the Pallas TPU
// kernel, with its helpers `_transform_sides`, `_per_view`, `_rot_fwd`,
// `_rot_inv`, `_pair_swap_neg`). Per (batch b, head h), with a row-vector
// convention and per-view [C, C] matrices:
//
//   qt = rot_q(q @ Mq[view])            kt = rot_k(k @ Mk[view])
//   vt = rot_k(v @ Mk[view])            (only with V_TRANSFORM)
//   z  = softmax(qt kt^T * scale) vt    (fp32 accuracy, online over K tiles)
//   out = rot_q^-1(z @ Mo[view])        (only with V_TRANSFORM)
//
// where rot(x) = c*x + s*swap(x), swap(x0, x1) = (-x1, x0) on lane pairs,
// and rot^-1(x) = c*x - s*swap(x). A row's view is row / tokens_per_view;
// views need not align with any tile (CLEVR encoder views hold 300 tokens,
// decoder views 856).
//
// What bounds it on the H100: the core does 4*Tq*Tk*C flops per (b, h)
// against (4*Tq + 4*Tk)*C*4 bytes of q, k, v, out and rotor tables, 75 to
// 145 flops per byte at the flagship shapes (C = 64, Tk = 600, Tq = 600 to
// 16384): bound by operations, at 165 TFLOP/s for fp32-accurate products
// on the tensor cores (3xTF32, 495 / 3) or 67 TFLOP/s on the CUDA cores.
//
// What the design does about it (each launch of the C entry point runs up
// to five kernels on the stream):
//  * Row launches (csrc/gta_rows.cuh, on the tensor cores) transform Q, K
//    and V once into scratch laid out [B, H, T, C]; the main kernel's loop
//    holds no C x C product. The Q scratch doubles as a training residual:
//    the backward reads it instead of recomputing qt.
//  * The main kernel: a block of 64 query rows, a warp per 16 rows; its qt
//    rows are split into TF32 parts once, in shared memory. K/V tiles of 32
//    keys are double-buffered in dynamic shared memory by cp.async (70 KB
//    a block, 3 blocks per SM). S = qt kt^T and O += P vt are 3xTF32
//    m16n8k8 mma.sync; the online softmax lives in the S accumulators, its
//    row max reduced across each quad of lanes by shuffles; P feeds P*V as
//    an A fragment in place (tf32x3.cuh renames its columns, and the V
//    fragment reads its keys in the same order). Each tile's P*V starts
//    from zero and joins O by rounded fp32 adds. Ragged Tq and Tk need no
//    padding: rows past Tq are zero and store nothing, keys past Tk are
//    zero-filled and masked to -inf.
//  * The output transform (z @ Mo, inverse rotors) is a row launch after
//    the main kernel, in place on `out` when z is not kept.
// ptxas (CUDA 12.8, sm_90a), no spills anywhere: main kernel 157
// registers (3 blocks of 128 threads per SM); row launches 96 (matrix, on
// the tensor cores) and 114 (rotors only). The main loop reaches about half
// of mma.sync's rate (csrc/tf32x3.cuh): with 12 warps per SM it is bound by
// the latency of each fragment's load, split and dependent mma chain.
// Not yet: wgmma and TMA (wgmma's TF32 form takes only K-major operands,
// so P*V needs a transposed V tile); K/V split once per block.
//
// Training residuals: given non-null `z` and `lse`, the kernels also keep z
// (the attention output before the output transform, the Pallas kernel's
// `store_z`) and each row's natural-log log-sum-exp of the scaled scores,
// for csrc/gta_fused_bwd.cu. Serving passes null for both.
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array; absent tables are null and flagged off.
// qt/kt/vt: scratch [B, H, T, C] for each side that has a transform.
// Returns the cudaError_t of the launches (0 = success).

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
constexpr int BM = 16 * WARPS;  // query rows per block
constexpr int BN = 32;          // keys per shared-memory tile
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int C>
constexpr int main_smem_bytes() {
  // qt hi and lo parts of the block's rows, K and V tiles (two stages each)
  return (2 * BM * (C + 4) + 2 * 2 * BN * (C + 4)) * (int)sizeof(float);
}

// z[b, row, h] = softmax(qt kt^T * scale) vt for the block's 64 rows.
// grid (ceil(Tq/BM), H, B). qt/kt/vt are addressed through (batch, head,
// row) strides, so the kernel reads row-launch scratch [B, H, T, C] or raw
// token-major input [B, T, H*C] alike.
template <int C>
__global__ void __launch_bounds__(THREADS, 3)
gta_fwd_main_kernel(const float* __restrict__ qt, const float* __restrict__ kt,
                    const float* __restrict__ vt, float* __restrict__ z, float* __restrict__ lse,
                    int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout zl,
                    float scale) {
  static_assert(C % 8 == 0, "head width must be a multiple of 8");
  constexpr int LD = C + 4;
  constexpr int KS = C / 8;   // k-steps over channels
  constexpr int NT = BN / 8;  // 8-key tiles per K tile
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;              // [BM][LD] qt, TF32 big parts
  float* Ql = Qh + BM * LD;      // [BM][LD] qt, small parts
  float* Ks = Ql + BM * LD;      // [2][BN][LD]
  float* Vs = Ks + 2 * BN * LD;  // [2][BN][LD]

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
      *reinterpret_cast<float2*>(zr + 8 * n + 2 * ln.t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (lse && ln.t == 0) lse[((int64_t)b * H + h) * Tq + row[r]] = m[r] + logf(l[r]);
  }
}

}  // namespace

extern "C" int gta_fused_fwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, float* qt, float* kt, float* vt,
                             float* out, float* z, float* lse, int B, int H, int Tq, int Tk, int C,
                             int nq, int nk, int flags, float scale, void* stream_ptr) {
  constexpr int CC = HEAD_DIM;
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool v_side = kv_tf && (flags & V_TRANSFORM);
  const bool out_tf = (flags & V_TRANSFORM) && (flags & (HAS_MO | HAS_ROTQ));
  if (C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      B > 65535 || H > 65535 || (q_tf && !qt) || (kv_tf && !kt) || (v_side && !vt)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = gta_rows::tokens(Tq, H, CC), tok_k = gta_rows::tokens(Tk, H, CC);
  const Layout hf_q = gta_rows::heads_first(Tq, H, CC), hf_k = gta_rows::heads_first(Tk, H, CC);
  cudaError_t err;

  // qt, kt, vt: R(x @ M) into [B, H, T, C] scratch
  auto side = [&](const float* src, float* dst, const float* M, const float* c, const float* s,
                  int T, int n, Layout from, Layout to) {
    const RowJob j{src, dst, from, to, M, c, s, nullptr, nullptr, nullptr, T, n, 0, 0};
    return gta_rows::run_rows<CC>(j, B, H, stream);
  };
  const float* Mq = flags & HAS_MQ ? mq : nullptr;
  const float* Mk = flags & HAS_MK ? mk : nullptr;
  const bool rq = flags & HAS_ROTQ, rk = flags & HAS_ROTK;
  if (q_tf && (err = side(q, qt, Mq, rq ? cq : nullptr, rq ? sq : nullptr, Tq, nq, tok_q, hf_q)))
    return (int)err;
  if (kv_tf && (err = side(k, kt, Mk, rk ? ck : nullptr, rk ? sk : nullptr, Tk, nk, tok_k, hf_k)))
    return (int)err;
  if (v_side && (err = side(v, vt, Mk, rk ? ck : nullptr, rk ? sk : nullptr, Tk, nk, tok_k, hf_k)))
    return (int)err;

  constexpr int smem = main_smem_bytes<CC>();
  err = cudaFuncSetAttribute(gta_fwd_main_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  float* zp = z ? z : out;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  gta_fwd_main_kernel<CC><<<grid, THREADS, smem, stream>>>(
      q_tf ? qt : q, kv_tf ? kt : k, v_side ? vt : v, zp, lse, H, Tq, Tk, q_tf ? hf_q : tok_q,
      kv_tf ? hf_k : tok_k, v_side ? hf_k : tok_k, tok_q, scale);
  if ((err = cudaGetLastError())) return (int)err;

  if (out_tf) {  // out = R_q^-1(z @ Mo), in place when z is not kept
    const RowJob j{zp, out, tok_q, tok_q, flags & HAS_MO ? mo : nullptr, rq ? cq : nullptr,
                   rq ? sq : nullptr, nullptr, nullptr, nullptr, Tq, nq, 0, 1};
    return (int)gta_rows::run_rows<CC>(j, B, H, stream);
  }
  if (z) return (int)cudaMemcpyAsync(out, z, sizeof(float) * B * Tq * H * CC,
                                     cudaMemcpyDeviceToDevice, stream);
  return (int)cudaSuccess;
}

extern "C" const char* gta_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
