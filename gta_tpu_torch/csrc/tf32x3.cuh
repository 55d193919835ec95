// fp32-accurate matrix products on Hopper's tensor cores: 3xTF32 through
// warp-level mma.sync m16n8k8, for the attention kernels of this directory.
//
// Each fp32 operand x is split into a TF32 "big" part hi = rna(x) and a TF32
// "small" part lo = rna(x - hi); a product a*b is then summed in fp32 as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the small*small term, ~2^-22 of a*b, is
// dropped). That keeps ~22 of fp32's 24 mantissa bits per product, which is
// what PyTorch's fp32 memory-efficient attention runs (CUTLASS's
// OpMultiplyAddFastF32). A single TF32 pass (10 bits) is not fp32 accuracy.
//
// What bounds a kernel built from these: three TF32 products per fp32
// product, so the fp32-accurate ceiling is 495 / 3 = 165 TFLOP/s on an H100
// SXM (dense TF32 rate; against 67 TFLOP/s of fp32 FMA on the CUDA cores).
// mma.sync reaches only part of the TF32 rate (wgmma is the only way to all
// of it), and each operand element costs five ALU instructions to split.
// The kernels split each fragment element as it is loaded from shared
// memory (or once per block, `split_rows`, for operands every warp reads at
// every step), and reuse an A fragment across all n-tiles of a k-step.
//
// The tensor cores' fp32 accumulation truncates: on an H100 each mma moves
// a running sum of positive products toward zero by ~4e-8 of its value
// (gta_tpu_torch/scripts/probe_tf32x3.py: -1.0e-6 after 24 chained mma,
// -1.2e-5 after 225, -5.4e-5 after 963). The kernels therefore chain mma
// over one shared-memory tile at most, starting from zero, and add tiles
// with round-to-nearest fp32 adds (chains of 24 stay at -1.0e-6 at any
// length).
//
// mma.sync itself reaches 278 (8 warps per SM) to 308 (16 warps) of the
// 495 TFLOP/s dense TF32 rate (same script), so the fp32-accurate ceiling
// of these kernels is ~100 TFLOP/s.
// Left for wgmma/TMA: wgmma's TF32 form takes only K-major operands, so
// P*V would need a transposed V tile.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), lane = 4*g + t:
//   A (16 x 8, row): a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k=t, n=g)             b1 (k=t+4, n=g)
//   C (16 x 8):      c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// An accumulator tile feeds the next product as its A operand without any
// shuffle by renaming its columns: A column t <-> C column 2t, A column t+4
// <-> C column 2t+1 (`a_from_acc`); the B operand of that product then reads
// its k rows in the same order (`load_b_kn`).
//
// Shared-memory tiles are [rows][C + 4] floats: with a row stride of 4 mod
// 32 words `load_a`, `load_b_nk` and `load_b_kn` hit 32 distinct banks
// (`load_a_t` and `load_b_kn_std` need a stride of 8 mod 32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// this lane's fragment coordinates
struct Lane {
  int g, t;
};

__device__ __forceinline__ Lane lane_coords() {
  const int l = threadIdx.x & 31;
  return {l >> 2, l & 3};
}

// rna(x): x rounded to TF32 (10 mantissa bits), to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds finite values. That instruction compiles
// to a sequence of compares and selects on sm_90 (it also handles NaN and
// Inf); adding half a TF32 ulp to the bit pattern and clearing the 13 low
// bits is the same rounding in two integer instructions. The operands here
// are finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// hi = rna(x), lo = rna(x - hi), element-wise
template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = to_tf32(x[i]);
    f.lo[i] = to_tf32(x[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

// d += a * b, one TF32 pass
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at fp32 accuracy: the two small terms first, then the big one
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// The same sum with the operands' roles swapped: mma3_t(d, k, q) adds the
// products of mma3(d, q, k) in the same order (k_hi*q_lo, k_lo*q_hi,
// k_hi*q_hi), so an element of S^T = K Q^T equals the same element of
// S = Q K^T bit for bit.
__device__ __forceinline__ void mma3_t(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.hi);
}

// A[m][k] = X[m * ld + k], m < 16 from X, k in [k0, k0 + 8)
__device__ __forceinline__ void load_a(float (&a)[4], const float* X, int ld, int k0, Lane l) {
  a[0] = X[l.g * ld + k0 + l.t];
  a[1] = X[(l.g + 8) * ld + k0 + l.t];
  a[2] = X[l.g * ld + k0 + l.t + 4];
  a[3] = X[(l.g + 8) * ld + k0 + l.t + 4];
}

// B[k][n] = T[n * ld + k]: T holds one row per n (e.g. keys, for q k^T)
__device__ __forceinline__ void load_b_nk(float (&b)[2], const float* T, int ld, int n0, int k0,
                                          Lane l) {
  b[0] = T[(n0 + l.g) * ld + k0 + l.t];
  b[1] = T[(n0 + l.g) * ld + k0 + l.t + 4];
}

// A[m][k] = T[k * ld + m]: the transpose of a row tile (X^T Y products)
__device__ __forceinline__ void load_a_t(float (&a)[4], const float* T, int ld, int m0, int k0,
                                         Lane l) {
  a[0] = T[(k0 + l.t) * ld + m0 + l.g];
  a[1] = T[(k0 + l.t) * ld + m0 + l.g + 8];
  a[2] = T[(k0 + l.t + 4) * ld + m0 + l.g];
  a[3] = T[(k0 + l.t + 4) * ld + m0 + l.g + 8];
}

// B[k][n] = T[k * ld + n]
__device__ __forceinline__ void load_b_kn_std(float (&b)[2], const float* T, int ld, int k0,
                                              int n0, Lane l) {
  b[0] = T[(k0 + l.t) * ld + n0 + l.g];
  b[1] = T[(k0 + l.t + 4) * ld + n0 + l.g];
}

// B[k][n] = T[k * ld + n] with k in `a_from_acc`'s order: B row t is T row
// k0 + 2t, B row t + 4 is T row k0 + 2t + 1
__device__ __forceinline__ void load_b_kn(float (&b)[2], const float* T, int ld, int k0, int n0,
                                          Lane l) {
  b[0] = T[(k0 + 2 * l.t) * ld + n0 + l.g];
  b[1] = T[(k0 + 2 * l.t + 1) * ld + n0 + l.g];
}

// A fragment of rows already split in shared memory (`split_rows`)
__device__ __forceinline__ void load_a_split(FragA& a, const float* hi, const float* lo, int ld,
                                             int k0, Lane l) {
  float f[4];
  load_a(f, hi, ld, k0, l);
#pragma unroll
  for (int e = 0; e < 4; ++e) a.hi[e] = __float_as_uint(f[e]);
  load_a(f, lo, ld, k0, l);
#pragma unroll
  for (int e = 0; e < 4; ++e) a.lo[e] = __float_as_uint(f[e]);
}

// the A fragment of a 16 x 8 accumulator tile, columns renamed (see above)
__device__ __forceinline__ void a_from_acc(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// ---------------------------------------------------------------------------
// cp.async staging of row tiles into shared memory
// ---------------------------------------------------------------------------

// 16 bytes, or 16 zero bytes when !valid (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, ROWS) of an operand whose row r starts at base + r * rs
// (floats, 16-byte aligned) into a [ROWS][LD] tile; rows at or past n are
// zero-filled. Every thread of a THREADS-thread block calls it.
template <int C, int ROWS, int THREADS, int LD = C + 4>
__device__ __forceinline__ void stage_rows(float* tile, const float* base, int64_t rs, int n) {
  constexpr int CHUNKS = C / 4;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c4 = idx % CHUNKS;
    const bool ok = r < n;
    cp_async16(tile + r * LD + 4 * c4, base + (ok ? r : 0) * rs + 4 * c4, ok);
  }
}

// Split a [ROWS][C + 4] tile in shared memory in place: `hi` keeps each
// element's TF32 big part, `lo` (same layout) receives its small part. For
// operands that every warp reads at every step: each element is split once
// per block instead of once per fragment load. Every thread of a
// THREADS-thread block calls it, after the tile has landed.
template <int C, int ROWS, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo) {
  for (int idx = threadIdx.x; idx < ROWS * C / 4; idx += THREADS) {
    const int off = (idx / (C / 4)) * (C + 4) + 4 * (idx % (C / 4));
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    const float v[4] = {x.x, x.y, x.z, x.w};
    const Frag<4> f = split(v);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(f.hi[0], f.hi[1], f.hi[2], f.hi[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
  }
}

// Stage v[0, ROWS) into shared memory, zero at or past n
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) cp_async4(dst + i, src + (i < n ? i : 0), i < n);
}

}  // namespace tf32x3
