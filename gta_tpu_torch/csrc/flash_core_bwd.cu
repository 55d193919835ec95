// Plain softmax attention backward for Hopper (sm_90a), through the
// attention core that the fused GTA backward runs (csrc/attn_core.cuh), in
// two precision policies: fp32 accuracy (3xTF32 mma.sync) and bf16 operands
// with fp32 accumulation (bf16 mma.sync).
//
// Replaces gta_tpu/ops/flash_core.py:86 `_bwd_kernel` (the Pallas TPU
// recompute backward launched by `_bwd_call` :150, the VJP of
// `flash_core`). Per (batch b, head h), with the forward's output o and
// per-row log-sum-exp lse (csrc/flash_core_fwd.cu) and the cotangent g of o:
//
//   p     = exp(q k^T * scale - lse)       dp = g v^T
//   delta = rowsum(g * o)                  (= the Pallas rowsum(p * dp), as o = p v)
//   ds    = p (dp - delta) * scale
//   dq    = ds k      dk = ds^T q      dv = p^T g
//
// over token-major operands: q/g/o/dq [B, Tq, H*C], k/v/dk/dv [B, Tk, H*C];
// lse and the scratch delta [B, H, Tq].
//
// What bounds it on the H100: 5 products of 2*Tq*Tk*C flops per (b, h)
// (s, dp, dq, dk, dv) against (4*Tq + 4*Tk)*C*4 bytes of q, k, v, g and the
// three gradients: bound by operations, at 165 TFLOP/s for fp32-accurate
// products on the tensor cores (3xTF32, 495 / 3).
//
// What the design does about it: the shared core's two passes on the raw
// token-major operands, no copy of g and no row launch. The query pass
// (`attn_bwd_q_kernel<64>`) computes delta = rowsum(g * (o - c_v))
// in its prologue, writes it for the key pass, and writes dq; the key pass
// (`attn_bwd_kv_kernel<64, KV_BOTH>`) writes dk and dv. Both take dP and dq
// about centres c_k, c_v (the first key's rows of each (b, h)): a layer's
// tokens share a large component, and without the centres the tensor
// cores' truncation of it (~1e-6) broke the cancellation in dq (attn_core.cuh).
// Each row is owned by one warp: no atomics, a fixed summation order,
// bit-identical reruns. Every product is 3xTF32 m16n8k8 mma.sync over one
// shared-memory tile, joined across tiles by fp32 adds.
// bf16 (`flash_core_bwd_bf16`): the core's bf16 passes on the raw bf16 q,
// k, v and g; the query pass takes delta = rowsum(P * dP) from its own
// products in a first sweep over the keys (o is not read: a bf16 o would
// carry its rounding into delta); the passes write fp32 gradients into
// scratch, converted to bf16 at the end.
// Not yet: wgmma and TMA; 5 products in place of 7 (both passes recompute
// S and dP).
//
// Interface: plain C, bound from Python with ctypes. `flash_core_bwd`:
// every pointer a contiguous fp32 device array. `flash_core_bwd_bf16`: q,
// k, v, g, dq, dk, dv bf16; lse, delta and the scratch dq32 [B, Tq, H*C],
// dk32, dv32 [B, Tk, H*C] fp32. Returns the cudaError_t of the launches (0 = success):
// cudaErrorInvalidValue for a head width other than 64, an empty side, or
// B or H above the grid's 65535.

#include <cuda_runtime.h>

#include "attn_core.cuh"

// q, k, v: the forward's inputs; g: the cotangent of its output o; lse: its
// log-sum-exp residual. delta [B, H, Tq]: scratch. dq, dk, dv: outputs.
extern "C" int flash_core_bwd(const float* q, const float* k, const float* v, const float* g,
                              const float* o, const float* lse, float* delta, float* dq,
                              float* dk, float* dv, int B, int H, int Tq, int Tk, int C,
                              float scale, void* stream_ptr) {
  constexpr int CC = 64;  // the only head width instantiated
  if (C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  return (int)attn::run_bwd<attn::Fp32, CC>(q, k, v, nullptr, g, o, lse, delta, dq, dk, dv, B, H, Tq, Tk, tok_q,
                                      tok_k, tok_k, tok_q, tok_q, tok_k, scale,
                                      static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int flash_core_bwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v,
                                   const attn::bf16* g, const float* lse, float* delta, float* dq32,
                                   float* dk32, float* dv32, attn::bf16* dq, attn::bf16* dk,
                                   attn::bf16* dv, int B, int H, int Tq, int Tk, int C, float scale,
                                   void* stream_ptr) {
  constexpr int CC = 64;  // the only head width instantiated
  if (C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  cudaError_t err = attn::run_bwd<attn::Bf16, CC>(q, k, v, nullptr, g, nullptr, lse, delta, dq32, dk32,
                                                  dv32, B, H, Tq, Tk, tok_q, tok_k, tok_k, tok_q, tok_q,
                                                  tok_k, scale, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t nq = (int64_t)B * Tq * H * CC, nk = (int64_t)B * Tk * H * CC;
  if ((err = attn::run_to_bf16(dq32, dq, nq, stream))) return (int)err;
  if ((err = attn::run_to_bf16(dk32, dk, nk, stream))) return (int)err;
  return (int)attn::run_to_bf16(dv32, dv, nk, stream);
}

extern "C" const char* flash_core_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
