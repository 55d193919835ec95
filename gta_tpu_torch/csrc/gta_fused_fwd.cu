// Fully fused GTA attention forward for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` (the Pallas TPU
// kernel, with its helpers `_transform_sides`, `_per_view`, `_rot_fwd`,
// `_rot_inv`, `_pair_swap_neg`). Per (batch b, head h), with a row-vector
// convention and per-view [C, C] matrices:
//
//   qt = rot_q(q @ Mq[view])            kt = rot_k(k @ Mk[view])
//   vt = rot_k(v @ Mk[view])            (only with V_TRANSFORM)
//   z  = softmax(qt kt^T * scale) vt    (fp32, online over K tiles)
//   out = rot_q^-1(z @ Mo[view])        (only with V_TRANSFORM)
//
// where rot(x) = c*x + s*swap(x), swap(x0, x1) = (-x1, x0) on lane pairs,
// and rot^-1(x) = c*x - s*swap(x). A row's view is row / tokens_per_view;
// views need not align with any tile (CLEVR encoder views hold 300 tokens).
//
// What bounds it on the H100: at the flagship shapes (C = 64, Tk = 600,
// Tq = 600 to 16384) the core does 4*Tq*Tk*C flops per (b, h) against
// (4*Tq + 4*Tk)*C*4 bytes of q, k, v, out and rotor tables: 75 to 145
// flops per byte, far above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20.
// It is bound by arithmetic, and the fp32 precision policy keeps that
// arithmetic on the CUDA cores, not the tensor cores.
//
// What the design does about it:
//  * A prologue launch transforms K (and V) once per (b, h) into fp32
//    scratch laid out [B, H, Tk, C]. Transforming on every tile load
//    instead would repeat Tk*C^2 work for each query block, as much as the
//    q.k^T product itself at C = 64.
//  * The main launch gives each thread one query row: the transformed row
//    and its output accumulator live in registers, so the softmax needs no
//    cross-thread reduction. K/V tiles are staged in shared memory and read
//    as float4 broadcasts (every lane reads the same address): one 16-byte
//    shared load feeds four FMAs per lane.
//  * Query rows are transformed on load and the output transform is
//    applied before the store, so q and out cross device memory once.
// Not yet: tensor-core (wgmma) products, TMA loads, bf16/TF32 operands.
//
// Training residuals: given non-null `z` and `lse`, the main kernel also
// writes z (the attention output before the output transform, the Pallas
// kernel's `store_z`) and each row's log-sum-exp of the scaled scores, for
// csrc/gta_fused_bwd.cu. Serving passes null for both and the kernels do
// exactly the work they did without them.
//
// Interface: plain C, bound from Python with ctypes. Every pointer is a
// contiguous fp32 device array; absent tables are null and flagged off.
// Returns the cudaError_t of the launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HAS_MQ = 1;
constexpr int HAS_MK = 2;
constexpr int HAS_MO = 4;
constexpr int HAS_ROTQ = 8;
constexpr int HAS_ROTK = 16;
constexpr int V_TRANSFORM = 32;

constexpr int HEAD_DIM = 64;  // the only head width compiled in
constexpr int BQ = 128;       // query rows (threads) per main block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int BT = 128;       // rows (threads) per prologue block

template <int C>
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

template <int C>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&x)[C]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    d4[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// x <- x @ M for a row-major [C, C] matrix in device memory. The lanes of a
// warp mostly share a view, so the loads broadcast through L1.
template <int C>
__device__ __forceinline__ void matvec(float (&x)[C], const float* __restrict__ M) {
  float y[C];
#pragma unroll
  for (int j = 0; j < C; ++j) y[j] = 0.f;
  const float4* M4 = reinterpret_cast<const float4*>(M);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float xi = x[i];
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4 m = __ldg(M4 + i * (C / 4) + j);
      y[4 * j] = fmaf(xi, m.x, y[4 * j]);
      y[4 * j + 1] = fmaf(xi, m.y, y[4 * j + 1]);
      y[4 * j + 2] = fmaf(xi, m.z, y[4 * j + 2]);
      y[4 * j + 3] = fmaf(xi, m.w, y[4 * j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) x[j] = y[j];
}

// x <- c*x + s*swap(x) (INV: c*x - s*swap(x)) with per-lane tables c, s.
template <int C, bool INV>
__device__ __forceinline__ void rotate(float (&x)[C], const float* __restrict__ c,
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

// Prologue: kt/vt[b, h, t, :] = rot_k(x[b, t, h*C:(h+1)*C] @ Mk[b, view(t)]).
// grid (ceil(Tk/BT), H, B*nsides); side 0 transforms k, side 1 transforms v.
template <int C>
__global__ void __launch_bounds__(BT)
gta_fwd_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ mk, const float* __restrict__ ck,
                  const float* __restrict__ sk, float* __restrict__ kt,
                  float* __restrict__ vt, int H, int Tk, int nk, int nsides, int flags) {
  const int b = blockIdx.z / nsides;
  const int side = blockIdx.z % nsides;
  const int h = blockIdx.y;
  const int row = blockIdx.x * BT + threadIdx.x;
  if (row >= Tk) return;
  const int64_t D = (int64_t)H * C;
  const float* src = side ? v : k;
  float* dst = side ? vt : kt;

  float x[C];
  load_row<C>(src + ((int64_t)b * Tk + row) * D + (int64_t)h * C, x);
  if (flags & HAS_MK) {
    const int view = row / (Tk / nk);
    matvec<C>(x, mk + ((int64_t)b * nk + view) * C * C);
  }
  if (flags & HAS_ROTK) {
    const int64_t r = ((int64_t)b * Tk + row) * C;
    rotate<C, false>(x, ck + r, sk + r);
  }
  store_row<C>(dst + (((int64_t)b * H + h) * Tk + row) * C, x);
}

// Main: one thread per query row. grid (ceil(Tq/BQ), H, B).
// kt/vt are addressed by (batch, head, row) strides in floats, so the same
// kernel reads prologue scratch [B, H, Tk, C] or untransformed token-major
// input [B, Tk, H*C].
template <int C>
__global__ void __launch_bounds__(BQ)
gta_fwd_main_kernel(const float* __restrict__ q, const float* __restrict__ kt,
                    const float* __restrict__ vt, const float* __restrict__ mq,
                    const float* __restrict__ mo, const float* __restrict__ cq,
                    const float* __restrict__ sq, float* __restrict__ out,
                    float* __restrict__ z, float* __restrict__ lse, int H, int Tq,
                    int Tk, int nq, int64_t k_bs, int64_t k_hs, int64_t k_rs, int64_t v_bs,
                    int64_t v_hs, int64_t v_rs, int flags, float scale) {
  __shared__ __align__(16) float Ks[BK * C];
  __shared__ __align__(16) float Vs[BK * C];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < Tq;
  const int64_t D = (int64_t)H * C;
  const int view = active ? row / (Tq / nq) : 0;
  const int64_t qoff = ((int64_t)b * Tq + row) * D + (int64_t)h * C;
  const int64_t roff = ((int64_t)b * Tq + row) * C;

  float x[C];
  if (active) {
    load_row<C>(q + qoff, x);
    if (flags & HAS_MQ) matvec<C>(x, mq + ((int64_t)b * nq + view) * C * C);
    if (flags & HAS_ROTQ) rotate<C, false>(x, cq + roff, sq + roff);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = 0.f;
  }

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const float* kbase = kt + b * k_bs + h * k_hs;
  const float* vbase = vt + b * v_bs + h * v_hs;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * C / 4; idx += BQ) {
      const int r = idx / (C / 4);
      const int c4 = idx % (C / 4);
      const int key = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (key < Tk) {
        kk = __ldg(reinterpret_cast<const float4*>(kbase + key * k_rs) + c4);
        vv = __ldg(reinterpret_cast<const float4*>(vbase + key * v_rs) + c4);
      }
      reinterpret_cast<float4*>(Ks)[idx] = kk;
      reinterpret_cast<float4*>(Vs)[idx] = vv;
    }
    __syncthreads();

    const int nkeys = min(BK, Tk - k0);
    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * C);
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C / 4; ++c) {
        const float4 kv = kr[c];
        d = fmaf(x[4 * c], kv.x, d);
        d = fmaf(x[4 * c + 1], kv.y, d);
        d = fmaf(x[4 * c + 2], kv.z, d);
        d = fmaf(x[4 * c + 3], kv.w, d);
      }
      s[j] = j < nkeys ? d * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    // online softmax: rescale the running sum and accumulator to the new max
    const float mnew = fmaxf(m, tmax);
    const float alpha = expf(m - mnew);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mnew);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * C);
#pragma unroll
      for (int c = 0; c < C / 4; ++c) {
        const float4 vv = vr[c];
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = mnew;
  }

  if (!active) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] *= inv;
  if (lse) lse[((int64_t)b * H + h) * Tq + row] = m + logf(l);
  if (z) store_row<C>(z + qoff, acc);
  if (flags & V_TRANSFORM) {
    if (flags & HAS_MO) matvec<C>(acc, mo + ((int64_t)b * nq + view) * C * C);
    if (flags & HAS_ROTQ) rotate<C, true>(acc, cq + roff, sq + roff);
  }
  store_row<C>(out + qoff, acc);
}

}  // namespace

extern "C" int gta_fused_fwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, float* kt, float* vt, float* out,
                             float* z, float* lse, int B, int H, int Tq, int Tk, int C, int nq,
                             int nk, int flags, float scale, void* stream_ptr) {
  if (C != HEAD_DIM || B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 ||
      Tq % nq || Tk % nk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t D = (int64_t)H * C;
  const bool kv_transform = flags & (HAS_MK | HAS_ROTK);
  const bool v_side = kv_transform && (flags & V_TRANSFORM);

  if (kv_transform) {
    const int nsides = v_side ? 2 : 1;
    const dim3 grid((Tk + BT - 1) / BT, H, B * nsides);
    gta_fwd_kv_kernel<HEAD_DIM><<<grid, BT, 0, stream>>>(k, v, mk, ck, sk, kt, vt, H, Tk, nk,
                                                         nsides, flags);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // strides (in floats) of the K and V rows the main kernel reads
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

  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  gta_fwd_main_kernel<HEAD_DIM><<<grid, BQ, 0, stream>>>(q, kp, vp, mq, mo, cq, sq, out, z, lse,
                                                         H, Tq, Tk, nq, k_bs, k_hs, k_rs, v_bs,
                                                         v_hs, v_rs, flags, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* gta_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
