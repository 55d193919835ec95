// Plain softmax attention forward for Hopper (sm_90a), through the attention
// core that the fused GTA kernels run (csrc/attn_core.cuh), in two precision
// policies: fp32 accuracy (3xTF32 mma.sync) and bf16 operands with fp32
// accumulation (bf16 mma.sync).
//
// Replaces gta_tpu/ops/flash_core.py:73 `_fwd_kernel` (the Pallas TPU
// kernel launched by `_fwd_call` :129). Per (batch b, head h):
//
//   out = softmax(q k^T * scale) v        (keys past Tk take no weight)
//   lse = log(sum_k exp(q k^T * scale))   (only when asked, for training)
//
// over token-major operands: q/out [B, Tq, H*C], k/v [B, Tk, H*C], head h in
// channels [h*C, (h+1)*C) of each row; lse [B, H, Tq].
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) against
// (2*Tq + 2*Tk)*C*4 bytes of q, k, v and out, 100 to 300 flops per byte at
// the SRT shapes (C = 64, Tk = 600, Tq = 600 to 16384): bound by operations,
// at 165 TFLOP/s for fp32-accurate products on the tensor cores (3xTF32,
// 495 / 3), 989 TFLOP/s for bf16.
//
// What the design does about it: one launch of the shared core
// (`attn_fwd_kernel`) on the raw token-major q, k, v and out, no scratch and
// no row launch. A warp owns 16 query rows, K/V stream through shared
// memory in double-buffered 32-key tiles (cp.async), both products are
// 3xTF32 m16n8k8 mma.sync, and the online softmax lives in the score
// accumulators; the Pallas kernel's whole-head K/V in VMEM becomes K tiles,
// so every key length takes the same kernel. P*V is taken about the first
// key's v row c_v (out = c_v + P (v - c_v)): a layer's v rows share a large
// component, whose truncation on the tensor cores would otherwise reach the
// backward's delta (attn_core.cuh). lse is the natural-log log-sum-exp
// with the running max in the scores' units, as the GTA kernels keep it.
// bf16 (`flash_core_fwd_bf16`): the same launch of the core's bf16
// instance on the raw bf16 q, k, v, uncentred (they are bf16 already: a
// centre would add a rounding, attn_core.cuh); out in bf16, lse in fp32.
// Not yet: wgmma and TMA (attn_core.cuh).
//
// Interface: plain C, bound from Python with ctypes. `flash_core_fwd`:
// every pointer a contiguous fp32 device array; `flash_core_fwd_bf16`: q,
// k, v and out bf16, lse fp32. lse may be null. Returns the cudaError_t of the launches
// (0 = success): cudaErrorInvalidValue for a head width other than 64, an
// empty side, or B or H above the grid's 65535.

#include <cuda_runtime.h>

#include "attn_core.cuh"

extern "C" int flash_core_fwd(const float* q, const float* k, const float* v, float* out,
                              float* lse, int B, int H, int Tq, int Tk, int C, float scale,
                              void* stream_ptr) {
  constexpr int CC = 64;  // the only head width instantiated
  if (C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  return (int)attn::run_fwd<attn::Fp32, CC>(q, k, v, nullptr, out, lse, B, H, Tq, Tk, tok_q, tok_k, tok_k, tok_q,
                                      scale, static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int flash_core_fwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v,
                                   attn::bf16* out, float* lse, int B, int H, int Tq, int Tk, int C,
                                   float scale, void* stream_ptr) {
  constexpr int CC = 64;  // the only head width instantiated
  if (C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  return (int)attn::run_fwd<attn::Bf16, CC>(q, k, v, nullptr, out, lse, B, H, Tq, Tk, tok_q, tok_k,
                                            tok_k, tok_q, scale, static_cast<cudaStream_t>(stream_ptr));
}

extern "C" const char* flash_core_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
