// Fully fused GTA attention forward for Hopper (sm_90a), in two precision
// policies: fp32 accuracy (the attention core as 3xTF32 mma.sync,
// csrc/tf32x3.cuh) and bf16 operands with fp32 accumulation (the attention
// core as wgmma fed by TMA, csrc/attn_sm90.cuh), the JAX package's two
// compute dtypes.
//
// Replaces gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` (the Pallas TPU
// kernel, with its helpers `_transform_sides`, `_per_view`, `_rot_fwd`,
// `_rot_inv`, `_pair_swap_neg`). Per (batch b, head h), with a row-vector
// convention and per-view [C, C] matrices:
//
//   qt = rot_q(q @ Mq[view])            kt = rot_k(k @ Mk[view])
//   vt = rot_k(v @ Mk[view])            (only with V_TRANSFORM)
//   z  = softmax(qt kt^T * scale) vt    (online over K tiles)
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
// 16384), 160 to 300 at msn_so3's (C = 96, Tk = 1280, Tq = 1280 to 16384):
// bound by operations, at 165 TFLOP/s for fp32-accurate products
// on the tensor cores (3xTF32, 495 / 3), 989 TFLOP/s for bf16.
//
// What the design does about it (each launch of a C entry point runs up to
// six kernels on the stream, eight in bf16):
//  * Row launches (csrc/gta_rows.cuh, on the tensor cores) transform Q, K
//    and V once into scratch laid out [B, H, T, C]; the core's loop holds no
//    C x C product. The Q scratch doubles as a training residual: the
//    backward reads it instead of recomputing qt.
//  * The attention core. fp32: csrc/attn_core.cuh `attn_fwd_kernel`
//    (shared with flash_core), a warp per 16 query rows, 32-key K/V tiles
//    by cp.async, the online softmax in the accumulator fragments, P.V
//    about the mean of the vt rows of (b, h) (`mean_rows_kernel` before the
//    core). bf16: csrc/attn_sm90.cuh `attn_sm90_fwd`, two warpgroups of 64
//    query rows, 64-key K/V tiles by TMA, every product a wgmma. The row
//    launches (bf16 products, the TPU kernel's rounding) write transformed
//    kt and vt in fp32, and `centre_bf16_kernel` writes them minus their
//    means in bf16 (the residuals the backward reads); qt is written in
//    bf16 directly, z and out in bf16; raw bf16 rows (a side without a
//    transform) go to the core as they are. (Transforming the rows twice,
//    once for their means and once centred, instead of storing them in
//    fp32 was slower, and so was summing the means inside the row launch:
//    the row launches are bound by their loads' latency and their
//    occupancy, not by their stores; PERF.md.)
//  * The output transform (z @ Mo, inverse rotors) is a row launch after
//    the core, in place on `out` when z is not kept. bf16 with rotors
//    alone (the DiT's tables): the core writes z in fp32 and the row launch
//    rotates it before the one rounding, as the TPU kernel does; with Mo,
//    the TPU kernel rounds z for the product too, and so does this one.
// Instances: one library per head width C = HEAD_DIM (32, 64: CLEVR-TR,
// 96: msn, 128; -DHEAD_DIM, ops/_cuda.py builds the four side by side);
// every multiple of 8 in [32, 128] runs in the smallest width at or above
// it, zero-padded by the wrapper (the tables with zero blocks; ops/
// gta_fused.py). The fp32 core runs 3 blocks of 128 threads per SM up to
// C = 64, 2 at C = 96, 1 at C = 128, the bf16 core one block of 288.
// Registers and spills of every kernel: PERF.md.
// Not yet, fp32: wgmma and TMA for the core (attn_core.cuh); K/V split once
// per block.
//
// Training residuals: given non-null `z` and `lse`, the kernels also keep z
// (the attention output before the output transform, the Pallas kernel's
// `store_z`) and each row's natural-log log-sum-exp of the scaled scores,
// for csrc/gta_fused_bwd.cu. Serving passes null for both.
//
// Interface: plain C, bound from Python with ctypes. `gta_fused_fwd`: every
// pointer a contiguous fp32 device array. `gta_fused_fwd_bf16`: q, k, v,
// qt, kt, vt, out and z bf16, the tables, kt32 (fp32 scratch [B, H, Tk, C]
// for the transformed rows before centring, with a K/V transform),
// centres and lse fp32, z32 (fp32 scratch [B, Tq, H*C] for z before its
// rounding, where rotors alone transform the output; null otherwise).
// Absent tables are null and flagged off. qt:
// scratch [B, H, Tq, C] when Q has a transform; kt/vt: [B, H, Tk, C] for
// each side that has a transform (bf16: the centred rows); centres:
// scratch [2, B, H, C] (the core's centre rows, csrc/attn_core.cuh).
// Returns the cudaError_t of the launches (0 = success).

#include <cuda_runtime.h>

#include "attn_core.cuh"
#include "attn_sm90.cuh"
#include "gta_rows.cuh"

#ifndef HEAD_DIM
#error "build with -DHEAD_DIM=<head width>: one library per width (gta_tpu_torch/ops/_cuda.py)"
#endif

namespace {

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

template <int CC>
int fused_fwd(const float* q, const float* k, const float* v, const float* mq, const float* mk,
              const float* mo, const float* cq, const float* sq, const float* ck, const float* sk,
              float* qt, float* kt, float* vt, float* centres, float* out, float* z, float* lse,
              int B, int H, int Tq, int Tk, int nq, int nk, int flags, float scale,
              void* stream_ptr) {
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool v_side = kv_tf && (flags & V_TRANSFORM);
  const bool out_tf = (flags & V_TRANSFORM) && (flags & (HAS_MO | HAS_ROTQ));
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      B > 65535 || H > 65535 || (q_tf && !qt) || (kv_tf && !kt) || (v_side && !vt) || !centres) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  const Layout hf_q = attn::heads_first(Tq, H, CC), hf_k = attn::heads_first(Tk, H, CC);
  cudaError_t err;

  // qt, kt, vt: R(x @ M) into [B, H, T, C] scratch
  auto side = [&](const float* src, float* dst, const float* M, const float* c, const float* s,
                  int T, int n, Layout from, Layout to) {
    const RowJob j{src, dst, from, to, M, c, s, nullptr, T, n, 0, 0};
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

  // c_v, the centre of P·V: the mean of the value rows (centres[1])
  const float* vp = v_side ? vt : v;
  const Layout vl = v_side ? hf_k : tok_k;
  if ((err = attn::run_mean<CC>(vp, vl, Tk, B, H, centres + (int64_t)B * H * CC, stream)))
    return (int)err;

  float* zp = z ? z : out;
  err = attn::run_fwd<CC>(q_tf ? qt : q, kv_tf ? kt : k, vp, centres, zp, lse, B, H, Tq, Tk,
                          q_tf ? hf_q : tok_q, kv_tf ? hf_k : tok_k, vl, tok_q, scale, stream);
  if (err != cudaSuccess) return (int)err;

  if (out_tf) {  // out = R_q^-1(z @ Mo), in place when z is not kept
    const RowJob j{zp, out, tok_q, tok_q, flags & HAS_MO ? mo : nullptr, rq ? cq : nullptr,
                   rq ? sq : nullptr, nullptr, Tq, nq, 0, 1};
    return (int)gta_rows::run_rows<CC>(j, B, H, stream);
  }
  if (z) return (int)cudaMemcpyAsync(out, z, sizeof(float) * B * Tq * H * CC,
                                     cudaMemcpyDeviceToDevice, stream);
  return (int)cudaSuccess;
}


template <int CC>
int fused_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mq, const float* mk,
                   const float* mo, const float* cq, const float* sq, const float* ck,
                   const float* sk, bf16* qt, float* kt32, bf16* kt, bf16* vt, float* centres,
                   float* z32, bf16* out, bf16* z, float* lse, int B, int H, int Tq, int Tk, int nq,
                   int nk, int flags, float scale, void* stream_ptr) {
  const bool q_tf = flags & (HAS_MQ | HAS_ROTQ);
  const bool kv_tf = flags & (HAS_MK | HAS_ROTK);
  const bool v_side = kv_tf && (flags & V_TRANSFORM);
  const bool out_tf = (flags & V_TRANSFORM) && (flags & (HAS_MO | HAS_ROTQ));
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || nq < 1 || nk < 1 || Tq % nq || Tk % nk ||
      B > 65535 || H > 65535 || (q_tf && !qt) || (kv_tf && (!kt32 || !kt)) || (v_side && !vt) ||
      !centres) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  const Layout hf_q = attn::heads_first(Tq, H, CC), hf_k = attn::heads_first(Tk, H, CC);
  const float* Mk = flags & HAS_MK ? mk : nullptr;
  const bool rq = flags & HAS_ROTQ, rk = flags & HAS_ROTK;
  cudaError_t err;

  // qt = R(q @ Mq) in bf16, fp32 inside
  if (q_tf) {
    const RowJobT<bf16, bf16> j{q, qt, tok_q, hf_q, flags & HAS_MQ ? mq : nullptr, rq ? cq : nullptr,
                                rq ? sq : nullptr, nullptr, Tq, nq, 0, 0};
    if ((err = gta_rows::run_rows<CC>(j, B, H, stream))) return (int)err;
  }
  // kt and vt about their means (centres[0], centres[1]), in bf16: the
  // transformed rows in fp32 first (kt32), the difference taken before the
  // rounding; raw rows go to the core as they are
  auto centred = [&](const bf16* src, bf16* dst, float* centre) {
    const RowJobT<bf16, float> j{src, kt32, tok_k, hf_k, Mk, rk ? ck : nullptr, rk ? sk : nullptr,
                                 nullptr, Tk, nk, 0, 0};
    cudaError_t e = gta_rows::run_rows<CC>(j, B, H, stream);
    if (e != cudaSuccess) return e;
    return attn::run_centre_bf16<CC>(kt32, hf_k, Tk, B, H, centre, dst, stream);
  };
  if (kv_tf && (err = centred(k, kt, centres))) return (int)err;
  float* cv = v_side ? centres + (int64_t)B * H * CC : nullptr;
  if (v_side && (err = centred(v, vt, cv))) return (int)err;

  // the core; c_v (centres[1]) is added back to z, 0 for raw value rows
  const bf16* qc = q_tf ? qt : q;
  const bf16* kc = kv_tf ? kt : k;
  const bf16* vc = v_side ? vt : v;
  const Layout qcl = q_tf ? hf_q : tok_q, kcl = kv_tf ? hf_k : tok_k, vcl = v_side ? hf_k : tok_k;
  if (out_tf && !(flags & HAS_MO)) {
    // rotors alone on the output: the TPU kernel rotates z in fp32 and
    // rounds once (`_fwd_kernel`: o = _rot_inv(o) before o.astype), so the
    // core keeps z in fp32 (z32) for the row launch; z itself is z32
    // rounded, as the kernel's store_z rounds it
    if (!z32) return (int)cudaErrorInvalidValue;
    err = sm90::run_fwd<sm90::Cfg<CC>>(qc, kc, vc, cv, z32, lse, B, H, Tq, Tk, qcl, kcl, vcl, tok_q, scale,
                                       stream);
    if (err != cudaSuccess) return (int)err;
    const RowJobT<float, bf16> j{z32, out, tok_q, tok_q, nullptr, cq, sq, nullptr, Tq, nq, 0, 1};
    if ((err = gta_rows::run_rows<CC>(j, B, H, stream))) return (int)err;
    if (!z) return (int)cudaSuccess;
    const RowJobT<float, bf16> copy{z32, z, tok_q, tok_q, nullptr, nullptr, nullptr, nullptr, Tq, nq, 0, 0};
    return (int)gta_rows::run_rows<CC>(copy, B, H, stream);
  }
  bf16* zp = z ? z : out;
  err = sm90::run_fwd<sm90::Cfg<CC>>(qc, kc, vc, cv, zp, lse, B, H, Tq, Tk, qcl, kcl, vcl, tok_q, scale, stream);
  if (err != cudaSuccess) return (int)err;

  if (out_tf) {  // out = R_q^-1(z @ Mo), in place when z is not kept
    const RowJobT<bf16, bf16> j{zp, out, tok_q, tok_q, flags & HAS_MO ? mo : nullptr,
                                rq ? cq : nullptr, rq ? sq : nullptr, nullptr, Tq, nq, 0, 1};
    return (int)gta_rows::run_rows<CC>(j, B, H, stream);
  }
  if (z) return (int)cudaMemcpyAsync(out, z, sizeof(bf16) * B * Tq * H * CC,
                                     cudaMemcpyDeviceToDevice, stream);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int gta_fused_fwd(const float* q, const float* k, const float* v, const float* mq,
                             const float* mk, const float* mo, const float* cq, const float* sq,
                             const float* ck, const float* sk, float* qt, float* kt, float* vt,
                             float* centres, float* out, float* z, float* lse, int B, int H, int Tq,
                             int Tk, int C, int nq, int nk, int flags, float scale,
                             void* stream_ptr) {
  if (C == HEAD_DIM) {
    return fused_fwd<HEAD_DIM>(q, k, v, mq, mk, mo, cq, sq, ck, sk, qt, kt, vt, centres, out, z, lse, B, H,
                               Tq, Tk, nq, nk, flags, scale, stream_ptr);
  }
  return (int)cudaErrorInvalidValue;  // the library of another head width
}

extern "C" int gta_fused_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, const float* mq,
                                  const float* mk, const float* mo, const float* cq,
                                  const float* sq, const float* ck, const float* sk, bf16* qt,
                                  float* kt32, bf16* kt, bf16* vt, float* centres, float* z32,
                                  bf16* out, bf16* z, float* lse, int B, int H, int Tq, int Tk, int C,
                                  int nq, int nk, int flags, float scale, void* stream_ptr) {
  if (C == HEAD_DIM) {
    return fused_fwd_bf16<HEAD_DIM>(q, k, v, mq, mk, mo, cq, sq, ck, sk, qt, kt32, kt, vt, centres, z32, out,
                                    z, lse, B, H, Tq, Tk, nq, nk, flags, scale, stream_ptr);
  }
  return (int)cudaErrorInvalidValue;  // the library of another head width
}

extern "C" const char* gta_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
