// bf16 matrix products on Hopper's tensor cores with fp32 accumulation:
// warp-level mma.sync m16n8k16, for the row transforms and dM reductions of
// the fused GTA kernels' bf16 instances (csrc/gta_rows.cuh,
// csrc/gta_fused_bwd.cu), and `pack`, which rounds two floats into one
// bf16x2 register (also csrc/attn_sm90.cuh's P and dS fragments). The
// counterpart of csrc/tf32x3.cuh, which holds the fp32-accurate 3xTF32
// products.
//
// This is what the TPU kernels compute with bf16 operands: each product
// a*b of two bf16 values is exact in fp32 and the sums accumulate in fp32
// (gta_tpu/ops/gta_fused.py `_dot`, gta_tpu/ops/flash_core.py `_dot` with
// mxu_dtype bf16). One mma does 16 * 8 * 16 multiply-adds where a 3xTF32
// step does 16 * 8 * 8 in three mma: 6x fewer instructions per product,
// against the 989 TFLOP/s dense bf16 rate of an H100 SXM (2x TF32's).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4*g + t; each
// register holds two bf16, the lower column (or k) in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                     a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// The accumulator layout is m16n8k8's (csrc/tf32x3.cuh).
//
// Fragments come from shared memory by ldmatrix (four 8x8 b16 matrices per
// instruction, one 16-byte row address per lane): A and the B of X Y^T
// products (rows of Y hold the k index) plain, the B of P V-like products
// (rows of V hold the k index) with .trans. Tiles are [rows][C + 8] bf16:
// a row stride of 16 bytes mod 128 puts the 8 rows of each matrix on 8
// distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

using bf16 = __nv_bfloat16;

// two floats as one bf16x2 register, round to nearest even; `lo` in the
// low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A[m][k] = X[m * ld + k], m < 16 from X, k in [k0, k0 + 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X, int ld, int k0) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  ldsm_x4(a, X + ((m & 1) * 8 + r) * ld + k0 + (m >> 1) * 8);
}

// the same with A[m][k] = T[k * ld + m] (T holds one row per k, e.g. rows
// for X^T Y), m in [m0, m0 + 16)
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* T, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  ldsm_x4_t(a, T + (k0 + (m >> 1) * 8 + r) * ld + m0 + (m & 1) * 8);
}

// B of the two n8 tiles n0 and n0 + 8, k in [k0, k0 + 16), with
// B[k][n] = T[n * ld + k] (T holds one row per n, e.g. keys for q k^T):
// b[0], b[1] for tile n0, b[2], b[3] for tile n0 + 8
__device__ __forceinline__ void load_b_nk2(uint32_t (&b)[4], const bf16* T, int ld, int n0, int k0) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  ldsm_x4(b, T + (n0 + (m >> 1) * 8 + r) * ld + k0 + (m & 1) * 8);
}

// the same with B[k][n] = T[k * ld + n] (T holds one row per k, e.g. keys
// for P v), k in [k0, k0 + 16), n in [n0, n0 + 16)
__device__ __forceinline__ void load_b_kn2(uint32_t (&b)[4], const bf16* T, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31, m = l >> 3, r = l & 7;
  ldsm_x4_t(b, T + (k0 + (m & 1) * 8 + r) * ld + n0 + (m >> 1) * 8);
}

}  // namespace bf16mma
