// Plain softmax attention forward for Hopper (sm_90a) in two precision
// policies: fp32 accuracy (3xTF32 mma.sync, through the attention core that
// the fused GTA kernels' fp32 instances run, csrc/attn_core.cuh) and bf16
// operands with fp32 accumulation (wgmma fed by TMA, through the core of
// their bf16 instances, csrc/attn_sm90.cuh).
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
// (2*Tq + 2*Tk)*C*4 bytes of q, k, v and out (fp32; half in bf16), 100 to
// 600 flops per byte at the SRT shapes (C = 64, Tk = 600 to 1280, Tq = 600
// to 16384; C = 96 at msn gta_t2's, Tk = 1280): bound by operations, at
// 165 TFLOP/s for fp32-accurate products on the tensor cores (3xTF32,
// 495 / 3), 989 TFLOP/s for bf16.
//
// What the design does about it: one launch of a core on the raw
// token-major q, k, v and out, no scratch and no row launch; the Pallas
// kernel's whole-head K/V in VMEM becomes K tiles, so every key length
// takes the same kernel. fp32 (`flash_core_fwd`, `attn_fwd_kernel`): a
// warp owns 16 query rows, K/V stream through shared memory in
// double-buffered 32-key tiles (cp.async), both products are 3xTF32
// m16n8k8 mma.sync, and the online softmax lives in the score
// accumulators. P*V is taken about the mean c_v of the value rows
// (out = c_v + P (v - c_v); a first launch takes the means): a layer's v
// rows share a large component, whose truncation on the tensor cores would
// otherwise reach the backward's delta (attn_core.cuh), and about the mean
// the products' operands are smallest (about the first key's row, dq at
// head width 96 and 1280 keys sat at 1.2e-5 from fp64, above the 1e-5 the
// instances are held to). lse is the natural-log log-sum-exp
// with the running max in the scores' units, as the GTA kernels keep it.
// bf16 (`flash_core_fwd_bf16`, `attn_sm90_fwd`): two consumer warpgroups
// of 64 query rows and a producer warpgroup a block, K/V tiles by TMA
// straight from the token-major rows (4-D tensor maps; rows past Tk
// zero-filled per head), every product a wgmma, uncentred (the rows are
// bf16 already: a centre would add a rounding); out in bf16 or, with
// `out_fp32`, in fp32 (GTA's sliced path: the TPU kernel there takes the
// transforms' fp32 rows, rounds only its product operands and writes its
// output in their fp32, gta_tpu/ops/gta_pallas.py:72), lse in fp32.
// Its tiling, `G` below: 128-key K/V tiles at C = 32 and 64 (an
// m64n128k16 score product, half the softmax rescales of 64; PERF.md has
// the times of both), 64-key tiles at C = 96 and 128 (the fused GTA
// kernels' tiling).
// Not yet: wgmma and TMA for fp32 (attn_core.cuh).
//
// One library per head width C = HEAD_DIM (32, 64, 96 or 128: -DHEAD_DIM,
// ops/_cuda.py builds all four side by side); every multiple of 8 in
// [32, 128] runs in the smallest width at or above it, its columns past C
// zero-padded by the wrapper (ops/flash_core.py).
//
// Interface: plain C, bound from Python with ctypes. `flash_core_fwd`:
// every pointer a contiguous fp32 device array, centres a [2, B, H, C]
// scratch; `flash_core_fwd_bf16`: q, k, v bf16, out bf16 (fp32 when
// `out_fp32` is nonzero), lse fp32. lse may be null. Returns the cudaError_t of the launches
// (0 = success): cudaErrorInvalidValue for a head width other than HEAD_DIM,
// an empty side, or B or H above the grid's 65535.

#include <cuda_runtime.h>

#include "attn_core.cuh"
#include "attn_sm90.cuh"

#ifndef HEAD_DIM
#error "build with -DHEAD_DIM=<head width>: one library per width (gta_tpu_torch/ops/_cuda.py)"
#endif
constexpr int CC = HEAD_DIM;

static cudaError_t fwd_fp32(const float* q, const float* k, const float* v, float* out, float* lse, float* centres,
                            int B, int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  // c_v, the centre of P*V: the mean of the value rows (centres[1])
  cudaError_t err = attn::run_mean<CC>(v, tok_k, Tk, B, H, centres + (int64_t)B * H * CC, stream);
  if (err != cudaSuccess) return err;
  return attn::run_fwd<CC>(q, k, v, centres, out, lse, B, H, Tq, Tk, tok_q, tok_k, tok_k, tok_q, scale, stream);
}

// the bf16 instance's tiling: 128-key tiles up to C = 64; 64 at C = 96 and
// 128, where a ring of four 128-row K/V tiles would not fit a block's
// shared memory (Cfg's static_assert)
using Tiling = sm90::Cfg<CC, (CC <= 64 ? 128 : 64)>;

static cudaError_t fwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v, void* out, bool out_fp32,
                            float* lse, int B, int H, int Tq, int Tk, float scale, cudaStream_t stream) {
  const attn::Layout tok_q = attn::tokens(Tq, H, CC), tok_k = attn::tokens(Tk, H, CC);
  if (out_fp32) {
    return sm90::run_fwd<Tiling>(q, k, v, nullptr, static_cast<float*>(out), lse, B, H, Tq, Tk, tok_q, tok_k, tok_k,
                            tok_q, scale, stream);
  }
  return sm90::run_fwd<Tiling>(q, k, v, nullptr, static_cast<attn::bf16*>(out), lse, B, H, Tq, Tk, tok_q, tok_k, tok_k,
                          tok_q, scale, stream);
}

static bool bad_call(int B, int H, int Tq, int Tk, int C) {
  return C != CC || B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535;
}

extern "C" int flash_core_fwd(const float* q, const float* k, const float* v, float* out,
                              float* lse, float* centres, int B, int H, int Tq, int Tk, int C, float scale,
                              void* stream_ptr) {
  if (bad_call(B, H, Tq, Tk, C) || !centres) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)fwd_fp32(q, k, v, out, lse, centres, B, H, Tq, Tk, scale, stream);
}

extern "C" int flash_core_fwd_bf16(const attn::bf16* q, const attn::bf16* k, const attn::bf16* v, void* out,
                                   float* lse, int B, int H, int Tq, int Tk, int C, int out_fp32, float scale,
                                   void* stream_ptr) {
  if (bad_call(B, H, Tq, Tk, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)fwd_bf16(q, k, v, out, out_fp32, lse, B, H, Tq, Tk, scale, stream);
}

extern "C" const char* flash_core_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
