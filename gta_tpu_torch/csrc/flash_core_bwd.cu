// Plain softmax attention backward for Hopper (sm_90a) in two precision
// policies: fp32 accuracy (3xTF32 mma.sync, through the attention core that
// the fused GTA kernels' fp32 instances run, csrc/attn_core.cuh) and bf16
// operands with fp32 accumulation (wgmma fed by TMA, through the core of
// their bf16 instances, csrc/attn_sm90.cuh).
//
// Replaces gta_tpu/ops/flash_core.py:86 `_bwd_kernel` (the Pallas TPU
// recompute backward launched by `_bwd_call` :150, the VJP of
// `flash_core`). Per (batch b, head h), with the forward's output o and
// per-row log-sum-exp lse (csrc/flash_core_fwd.cu) and the cotangent g of o:
//
//   p     = exp(q k^T * scale - lse)       dp = g v^T
//   delta = rowsum(p * dp)                 (= rowsum(g * o), as o = p v)
//   ds    = p (dp - delta) * scale
//   dq    = ds k      dk = ds^T q      dv = p^T g
//
// over token-major operands: q/g/o/dq [B, Tq, H*C], k/v/dk/dv [B, Tk, H*C];
// lse and the scratch delta [B, H, Tq].
//
// What bounds it on the H100: 5 products of 2*Tq*Tk*C flops per (b, h)
// (s, dp, dq, dk, dv) against (4*Tq + 4*Tk)*C*4 bytes of q, k, v, g and the
// three gradients (half in bf16): bound by operations, at 165 TFLOP/s for
// fp32-accurate products on the tensor cores (3xTF32, 495 / 3), 989 TFLOP/s
// for bf16.
//
// What the design does about it: a core's two passes on the raw
// token-major operands, no copy of g and no row launch; the query pass
// writes dq and delta, the key pass dk and dv. Each row is owned by one
// warp (fp32) or warpgroup (bf16): no atomics, a fixed summation order,
// bit-identical reruns.
// fp32 (`flash_core_bwd`): the query pass (`attn_bwd_q_kernel<C>`)
// computes delta = rowsum(g * (o - c_v)) in its prologue; the key pass
// (`attn_bwd_kv_kernel<C, ...>`: one at C = 64, a dv and a dk pass at 96)
// writes dk and dv. Both take dP and dq about centres c_k, c_v (the means
// of the key and value rows of each (b, h), from two first launches): a
// layer's tokens share a large component, and without the centres the
// tensor cores' truncation of it (~1e-6) broke the cancellation in dq
// (attn_core.cuh). Every product is 3xTF32 m16n8k8 mma.sync over one
// shared-memory tile, joined across tiles by fp32 adds.
// bf16 (`flash_core_bwd_bf16`): attn_sm90.cuh's query pass and key pass
// on the raw bf16 q, k, v and g by TMA, every product a wgmma. The query
// pass takes delta = rowsum(P * dP) from its own products in a first
// sweep over the keys: the TPU kernel's formula, and the only one that
// keeps each dS row's sum at zero where the keys share a large component
// (from the bf16 o, dq's error against fp64 grew to 116x and dk's to 5.5x
// the TPU rounding's on keys and values that share a component of 8x their
// spread: scripts/probe_delta_from_o.py, PERF.md). Both passes store their
// gradients straight from their fp32 accumulators: bf16 (one rounding, the
// TPU kernel's `.astype(q.dtype)`), or fp32 with `grads_fp32` (GTA's sliced
// path, whose rows are fp32 on the TPU: gta_tpu/ops/flash_core.py:168-174);
// no scratch, no conversion launch.
// Its tiling, `G` below: 128-key K/V tiles in the query pass (the key pass
// streams 64 queries; PERF.md has the times of both).
// Not yet: wgmma and TMA for fp32; 5 products in place of 7 (fp32) or 9
// (bf16: the sweep and both passes' S).
//
// Interface: plain C, bound from Python with ctypes. `flash_core_bwd`:
// every pointer a contiguous fp32 device array (delta and centres
// scratch). `flash_core_bwd_bf16`: q,
// k, v, g bf16; dq, dk, dv bf16 (fp32 when `grads_fp32` is nonzero); lse
// and the scratch delta fp32. Returns the
// cudaError_t of the launches (0 = success): cudaErrorInvalidValue for a
// head width other than 64 and 96, an empty side, or B or H above the grid's
// 65535.

#include <cuda_runtime.h>

#include "attn_core.cuh"
#include "attn_sm90.cuh"

template <int CC>
static cudaError_t bwd_fp32(const float* q, const float* k, const float* v, const float* g, const float* o,
                            const float* lse, float* delta, float* centres, float* dq, float* dk, float* dv, int B,
                            int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  // c_k, c_v: the means of the key and value rows (the forward's c_v, bit
  // for bit: the same launch on the same rows)
  cudaError_t err = attn::run_mean<CC>(k, tok_k, Tk, B, H, centres, stream);
  if (err == cudaSuccess) err = attn::run_mean<CC>(v, tok_k, Tk, B, H, centres + (int64_t)B * H * CC, stream);
  if (err != cudaSuccess) return err;
  return attn::run_bwd<CC>(q, k, v, centres, g, o, lse, delta, dq, dk, dv, B, H, Tq, Tk, tok_q, tok_k, tok_k, tok_q,
                           tok_q, tok_k, scale, stream);
}

// G: the query pass's tiling, 128-key tiles at C = 64; 64 at C = 96 (as
// the forward's, csrc/flash_core_fwd.cu)
template <class G, class Out>
static cudaError_t bwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v, const attn::bf16* g,
                            const float* lse, float* delta, Out* dq, Out* dk, Out* dv, int B,
                            int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  const attn::Layout tok_q = attn::tokens(Tq, H, G::C), tok_k = attn::tokens(Tk, H, G::C);
  return sm90::run_bwd<G>(q, k, v, g, lse, delta, dq, dk, dv, B, H, Tq, Tk, tok_q, tok_k, tok_k, tok_q, tok_q, tok_k,
                          scale, stream);
}

static bool bad_call(int B, int H, int Tq, int Tk, int C) {
  return (C != 64 && C != 96) || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535;
}

// q, k, v: the forward's inputs; g: the cotangent of its output o; lse: its
// log-sum-exp residual. delta [B, H, Tq], centres [2, B, H, C]: scratch.
// dq, dk, dv: outputs.
extern "C" int flash_core_bwd(const float* q, const float* k, const float* v, const float* g,
                              const float* o, const float* lse, float* delta, float* centres, float* dq,
                              float* dk, float* dv, int B, int H, int Tq, int Tk, int C,
                              float scale, void* stream_ptr) {
  if (bad_call(B, H, Tq, Tk, C) || !centres) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(C == 64 ? bwd_fp32<64>(q, k, v, g, o, lse, delta, centres, dq, dk, dv, B, H, Tq, Tk, scale, stream)
                       : bwd_fp32<96>(q, k, v, g, o, lse, delta, centres, dq, dk, dv, B, H, Tq, Tk, scale, stream));
}

template <class Out>
static cudaError_t bwd_bf16_c(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v, const attn::bf16* g,
                              const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int Tq,
                              int Tk, int C, float scale, cudaStream_t stream) {
  Out *dq_ = static_cast<Out*>(dq), *dk_ = static_cast<Out*>(dk), *dv_ = static_cast<Out*>(dv);
  return C == 64 ? bwd_bf16<sm90::Cfg<64, 128>>(q, k, v, g, lse, delta, dq_, dk_, dv_, B, H, Tq, Tk, scale, stream)
                 : bwd_bf16<sm90::Cfg<96, 64>>(q, k, v, g, lse, delta, dq_, dk_, dv_, B, H, Tq, Tk, scale, stream);
}

// the same in bf16, without o (delta comes from the query pass's products)
extern "C" int flash_core_bwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v,
                                   const attn::bf16* g, const float* lse, float* delta, void* dq, void* dk, void* dv,
                                   int B, int H, int Tq, int Tk, int C, int grads_fp32, float scale,
                                   void* stream_ptr) {
  if (bad_call(B, H, Tq, Tk, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(grads_fp32 ? bwd_bf16_c<float>(q, k, v, g, lse, delta, dq, dk, dv, B, H, Tq, Tk, C, scale, stream)
                          : bwd_bf16_c<attn::bf16>(q, k, v, g, lse, delta, dq, dk, dv, B, H, Tq, Tk, C, scale, stream));
}

extern "C" const char* flash_core_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
