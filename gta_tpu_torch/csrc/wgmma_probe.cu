// Probes of the wgmma and TMA path of csrc/attn_sm90.cuh on the card; on no
// model path (gta_tpu_torch/scripts/probe_wgmma.py drives them).
//
//  * wgmma_probe_layout: one warpgroup loads three [64][C] bf16 tiles a, b,
//    v by TMA (64-byte swizzle, 32-column boxes) and computes S = a b^T
//    (both operands K-major in shared memory) and O = bf16(S) v (S packed
//    to register fragments, v MN-major), the two product forms of the
//    attention core, with its own descriptor helpers. `swap` swaps the
//    MN-major descriptor's two byte offsets, the one choice those helpers
//    make that the PTX ISA's tables leave to reading.
//  * wgmma_probe_chain: each block (one warpgroup) sums `reps` products
//    a b^T of its [64][64] tiles (4 k16 steps each) in one tensor-core
//    chain (`join` = 0) or in chains of `join` products added with fp32
//    round-to-nearest adds: how far wgmma's fp32 accumulation drifts from
//    the exact sum with the chain's length. Many blocks and long chains
//    time its throughput.
//
// Interface: plain C, bound from Python with ctypes; returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_sm90.cuh"

namespace {

using namespace sm90;

template <int C>
__global__ void __launch_bounds__(128) layout_kernel(const __grid_constant__ CUtensorMap ma,
                                                     const __grid_constant__ CUtensorMap mb,
                                                     const __grid_constant__ CUtensorMap mv, int hf, float* S,
                                                     float* O, int swap) {
  constexpr int TILE = 64 * C * 2;
  extern __shared__ __align__(16) uint8_t probe_smem[];
  const uint32_t a0 = smem_u32(probe_smem);
  uint8_t* sm = probe_smem + (((a0 + 1023) & ~1023u) - a0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 3 * TILE);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 3 * TILE);
    load_tile(sm, &ma, hf & 1, C, 0, 0, 0, bar);
    load_tile(sm + TILE, &mb, hf & 2, C, 0, 0, 0, bar);
    load_tile(sm + 2 * TILE, &mv, hf & 4, C, 0, 0, 0, bar);
  }
  mbar_wait(bar, 0);
  const Place p = place();
  const uint32_t as = smem_u32(sm), bs = as + TILE, vs = as + 2 * TILE;
  float s[BN / 2];
  zero(s);
  wg_fence();
  s_product<C>(s, as, bs);
  wg_commit();
  wg_wait();
  fence_regs(s);
  const int row = 16 * p.warp + p.g;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) S[(row + 8 * ((e >> 1) & 1)) * BN + 8 * (e >> 2) + 2 * p.t + (e & 1)] = s[e];
  uint32_t pa[BN / 16][4];
  to_frags(pa, s);
  float o[C / 2];
  zero(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t d = swap ? make_desc(vs + kk * 1024, 512, BOX_BYTES) : desc_mn(vs, kk);
    Mma<C>::rs(o, pa[kk], d, 1);
  }
  wg_commit();
  wg_wait();
  fence_regs(o);
#pragma unroll
  for (int e = 0; e < C / 2; ++e) O[(row + 8 * ((e >> 1) & 1)) * C + 8 * (e >> 2) + 2 * p.t + (e & 1)] = o[e];
}

// block z sums `reps` products of its tiles a[z] b[z]^T ([64][64] each)
__global__ void __launch_bounds__(128) chain_kernel(const __grid_constant__ CUtensorMap ma,
                                                    const __grid_constant__ CUtensorMap mb, int hf, float* D,
                                                    int reps, int join) {
  constexpr int TILE = 64 * 64 * 2;
  extern __shared__ __align__(16) uint8_t probe_smem[];
  const uint32_t a0 = smem_u32(probe_smem);
  uint8_t* sm = probe_smem + (((a0 + 1023) & ~1023u) - a0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 2 * TILE);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * TILE);
    load_tile(sm, &ma, hf & 1, 64, 0, blockIdx.x, 0, bar);
    load_tile(sm + TILE, &mb, hf & 2, 64, 0, blockIdx.x, 0, bar);
  }
  mbar_wait(bar, 0);
  const Place p = place();
  const uint32_t as = smem_u32(sm), bs = as + TILE;
  float acc[32], t[32];
  zero(acc);
  zero(t);
  for (int r = 0; r < reps; ++r) {
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Mma<64>::ss(t, desc_k(as, ks), desc_k(bs, ks), 1);
    wg_commit();
    wg_wait();
    fence_regs(t);
    if (join > 0 && (r + 1) % join == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        acc[e] += t[e];
        t[e] = 0.f;
      }
    }
  }
  const int row = 16 * p.warp + p.g;
  float* d = D + (int64_t)blockIdx.x * 64 * 64;
#pragma unroll
  for (int e = 0; e < 32; ++e) d[(row + 8 * ((e >> 1) & 1)) * 64 + 8 * (e >> 2) + 2 * p.t + (e & 1)] = acc[e] + t[e];
}

// a map of n [64][C] tiles, tile z at rows [0, 64) of "batch" z
cudaError_t tiles_map(CUtensorMap* map, const bf16* x, int C, int n, int* hf) {
  bool h = false;
  const cudaError_t err = make_map(map, x, attn::heads_first(64, 1, C), 64, 1, n, C, &h);
  *hf = h ? 1 : 0;
  return err;
}

}  // namespace

extern "C" int wgmma_probe_layout(const bf16* a, const bf16* b, const bf16* v, float* S, float* O, int C, int swap,
                                  void* stream) {
  CUtensorMap ma, mb, mv;
  int ha, hb, hv;
  cudaError_t err;
  if ((err = tiles_map(&ma, a, C, 1, &ha)) || (err = tiles_map(&mb, b, C, 1, &hb)) ||
      (err = tiles_map(&mv, v, C, 1, &hv)))
    return (int)err;
  const int hf = ha | hb << 1 | hv << 2;
  const int smem = 3 * 64 * C * 2 + 8 + 1024;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64) {
    if ((err = allow_smem(layout_kernel<64>, smem))) return (int)err;
    layout_kernel<64><<<1, 128, smem, s>>>(ma, mb, mv, hf, S, O, swap);
  } else if (C == 96) {
    if ((err = allow_smem(layout_kernel<96>, smem))) return (int)err;
    layout_kernel<96><<<1, 128, smem, s>>>(ma, mb, mv, hf, S, O, swap);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int wgmma_probe_chain(const bf16* a, const bf16* b, float* D, int blocks, int reps, int join,
                                 void* stream) {
  CUtensorMap ma, mb;
  int ha, hb;
  cudaError_t err;
  if ((err = tiles_map(&ma, a, 64, blocks, &ha)) || (err = tiles_map(&mb, b, 64, blocks, &hb))) return (int)err;
  const int smem = 2 * 64 * 64 * 2 + 8 + 1024;
  if ((err = allow_smem(chain_kernel, smem))) return (int)err;
  chain_kernel<<<blocks, 128, smem, static_cast<cudaStream_t>(stream)>>>(ma, mb, ha | hb << 1, D, reps, join);
  return (int)cudaGetLastError();
}
