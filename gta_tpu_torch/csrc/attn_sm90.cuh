// The bf16 softmax attention core of the fused GTA kernels on Hopper's
// warpgroup tensor-core products (wgmma) fed by the Tensor Memory
// Accelerator (TMA): forward, query pass and key pass. Called by the bf16
// entries of csrc/gta_fused_fwd.cu and csrc/gta_fused_bwd.cu over the rows
// their row launches transformed (qt, and kt, vt centred on their means in
// fp32 before the rounding to bf16) or the raw token-major rows of a side
// without a transform. It is the attention core of the TPU kernels
// gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` and :235 `_bwd_kernel` with
// mxu = bfloat16. Per (batch b, head h), head width C = 64 or 96:
//
//   forward   z   = c_v + softmax(q k^T * scale) v      (online over K tiles)
//             lse = log(sum_k exp(q k^T * scale))       (natural log; optional)
//   backward  p   = exp(q k^T * scale - lse)     dp = do v^T
//             ds  = p (dp - delta) * scale       delta = rowsum(p * dp)
//             dq  = ds k     dk = ds^T q     dv = p^T do
//
// (v is centred, so c_v, the mean of the value rows, is added back to z;
// 0 for raw rows.) Rounding, that of the TPU kernel: q, k, v, do, P and dS
// are bf16 product operands; the softmax, lse, delta and every accumulator
// are fp32; gradients are written in fp32.
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) forward, 10*Tq*Tk*C
// backward (the function's 5 products), against a few bytes per row: 160
// to 300 flops per byte at msn_so3's shapes, so it is bound by operations,
// at 989 TFLOP/s of dense bf16.
//
// What the design does about it:
//  * Every product is a wgmma (m64nNk16, bf16 operands, fp32 accumulators):
//    S-like products (q k^T, do v^T, k q^T, v do^T) with both operands in
//    shared memory, K-major; P.V-like products (P v, dS k, P^T do, dS^T q)
//    with P or dS in registers (the S accumulators packed to bf16 pairs in
//    place, no round trip through shared memory) and the other side's tile
//    MN-major, so no tile is transposed.
//  * A block is two consumer warpgroups of 64 own rows each and a producer
//    warpgroup, which gives most of its registers to the consumers
//    (setmaxnreg: 24 and 240 a thread, where the launch gives 168 to all
//    384). The producer's one active thread loads the block's own rows
//    once and streams the other side's rows in tiles of 64 through a
//    four-stage ring in shared memory by TMA, with a `full` mbarrier per
//    stage (TMA's transaction count) and an `empty` one (an arrive per
//    consumer warp when its products have read the stage). The two
//    warpgroups share every tile, so a tile is read from L2 once per 128
//    own rows.
//  * Each consumer warpgroup runs a software pipeline (`pipeline`): tile
//    i + 1's S-like products are issued before tile i's register-operand
//    ones, so tile i + 1's softmax (or P and dS) runs on the CUDA cores
//    while tile i's P.V-like products run on the tensor cores; the other
//    warpgroup's products fill the remaining gaps.
//  * Tiles sit in shared memory as 32-column TMA boxes, [rows][32] bf16
//    with the 64-byte swizzle (a 192-byte row at C = 96 is wider than the
//    128-byte swizzle span; C = 64 and 96 are both whole boxes). The wgmma
//    descriptors name that swizzle: K-major, a k16 step is 32 bytes into a
//    box's rows; MN-major, the boxes are the 32-wide atoms along N.
//  * Every operand is one 4-D tensor map (C, H, T, B) through its own
//    strides, heads-first scratch [B, H, T, C] and token-major rows
//    [B, T, H*C] alike: rows past T are zero-filled by TMA per (b, h), never
//    read from the next head. Keys past Tk score -inf, queries past Tq get
//    P = 0, rows past the end store nothing.
//  * Forward: the online softmax stays in the S accumulators, in the
//    scores' units (where one key dominates, lse = max exactly); O is
//    scaled by the running correction and accumulates P.V in the tensor
//    cores across every key tile (bf16 operands: the accumulation's own
//    truncation, ~1e-7 of the sum, is far below their rounding, 2^-9; see
//    scripts/probe_wgmma.py).
//  * Backward, split by who owns each output row (Hopper's blocks run in
//    parallel): a query pass writes dq and delta, a key pass writes dk and
//    dv. No row is written by two blocks: no atomics, every sum in a fixed
//    order, bit-identical reruns. delta = rowsum(P * dP), the TPU kernel's
//    formula, from the query pass's own S and dP in a first sweep over the
//    key tiles when they are more than one (2 products a tile), then the
//    second sweep's S, dP and dq += dS k. The key pass is one pass for dk
//    and dv at C = 64 and 96: its 64 key rows a warpgroup hold C fp32
//    accumulators a thread for dk and dv, 64 for S^T and dP^T and 32
//    registers of P^T and dS^T fragments for each of two tiles in flight,
//    within the 240 registers setmaxnreg gives a consumer thread (at the
//    launch's 168 the joint pass spilled at C = 96; pipelined, it spilled
//    at 232), so there is no dv/dk split (which recomputed S^T twice).
//    9 products where the function has 5 (the sweep's 2 and both passes'
//    S).
// ptxas registers and spills of every instance: chip_smoke.py's build
// report (PERF.md's kernel table).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_core.cuh"  // Layout, offset, store2, bf16mma::pack

namespace sm90 {

using attn::bf16;
using attn::Layout;

constexpr int NC = 2;                      // consumer warpgroups a block
constexpr int THREADS = 128 * (NC + 1);    // and one producer warpgroup
constexpr int PRODUCER_REGS = 24;          // registers a thread after the split (setmaxnreg):
constexpr int CONSUMER_REGS = 240;         // 128 * 24 + 256 * 240 = 384 * 168, the launch's
constexpr int ROWS = 64;                   // own rows of a warpgroup (wgmma's M)
constexpr int BN = 64;                     // rows of a streamed tile
constexpr int STAGES = 4;                  // the ring of streamed tiles
constexpr int BOX = 32;                    // columns of a TMA box: 64 bytes, the 64-byte swizzle
constexpr int BOX_BYTES = 64 * BOX * 2;    // a box of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of a block: own tiles [2 operands][NC], the ring
// [STAGES][2 operands], each tile 64 rows x C as C / 32 boxes; then the
// mbarriers full[STAGES], empty[STAGES], own
template <int C>
struct Smem {
  static constexpr int TILE = 64 * C * 2;
  static constexpr int OWN = 0;
  static constexpr int RING = OWN + 2 * NC * TILE;
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + slack to align the base to 1024
};

// ---------------------------------------------------------------------------
// Barriers, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup's products are
// still running
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register A operands, which a running product still reads:
// kept alive (unmoved, unreused) until the wait that precedes this fence
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
  }
}

// a shared-memory matrix descriptor with the 64-byte swizzle; byte offsets
// `lbo` (leading) and `sbo` (stride)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// K-major operand, k16 step `ks` of a 64-row tile at `tile` (C / 32 boxes
// of [64][32]): 8-row groups 512 bytes apart, a k16 step 32 bytes into a
// box's rows
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return make_desc(tile + (ks >> 1) * BOX_BYTES + (ks & 1) * 32, 16, 512);
}

// MN-major B operand (its rows are the k index), k16 step `kk` of a 64-row
// tile: the 32-column boxes are the atoms along N (BOX_BYTES apart), 8-row
// groups along k 512 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 1024, BOX_BYTES, 512);
}

// wgmma m64nNk16, bf16 operands, fp32 accumulators d (N/2 a thread: warp w
// of the warpgroup holds rows 16w..16w+15; d[4j + e] is row g + 8 (e >> 1),
// column 8j + 2t + (e & 1), lane = 4g + t). scale_d = 0 starts the sum.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  // d (+)= A B, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
        "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
          "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // d (+)= A B, A in registers (bf16 pairs), B MN-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
        "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
          "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<96> {  // the P.V-like products at C = 96
  static __device__ __forceinline__ void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
        "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
          "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// d += A T for a 64-row tile T, MN-major, and A the k16 fragments `a` of
// the 64 columns of an S-like accumulator
template <int C>
__device__ __forceinline__ void pv_product(float (&d)[C / 2], const uint32_t (&a)[BN / 16][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) Mma<C>::rs(d, a[kk], desc_mn(tile, kk), 1);
}

// s = A B^T over C channels for two 64-row K-major tiles (A the own rows)
template <int C>
__device__ __forceinline__ void s_product(float (&s)[BN / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) Mma<BN>::ss(s, desc_k(a, ks), desc_k(b, ks), ks > 0);
}

// the k16 A fragments of the 64 columns of an S-like accumulator, rounded
// to bf16 (columns 16kk..16kk+15 are n8 blocks 2kk, 2kk + 1)
__device__ __forceinline__ void to_frags(uint32_t (&a)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = bf16mma::pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------------------
// The block's skeleton: barriers, the producer, the consumers' coordinates
// ---------------------------------------------------------------------------

// tensor-map coordinates of rows [row, row + 64) of (b, h): maps are
// (C, H, T, B), or (C, T, H, B) for heads-first rows (`hf`)
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, bool hf, int C, int row, int b,
                                          int h, uint64_t* bar) {
  for (int bx = 0; bx < C / BOX; ++bx) {
    tma_load(dst + bx * BOX_BYTES, map, bx * BOX, hf ? row : h, hf ? h : row, b, bar);
  }
}

// The producer's thread: the own tiles of both consumer warpgroups (map
// m0, and m1 when `two_own`) from row `own0`, then `steps` streamed tiles
// of maps m2 and m3 (tile i % ntiles) through the ring. hf: bit i set when
// map mi is heads-first.
template <int C>
__device__ __forceinline__ void produce(uint8_t* sm, uint64_t* bars, const CUtensorMap* m0, const CUtensorMap* m1,
                                        const CUtensorMap* m2, const CUtensorMap* m3, int hf, bool two_own,
                                        int own0, int b, int h, int ntiles, int steps) {
  using S = Smem<C>;
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* own = bars + 2 * STAGES;
  mbar_expect_tx(own, (two_own ? 2 : 1) * NC * S::TILE);
  for (int w = 0; w < NC; ++w) {
    load_tile(sm + S::OWN + w * S::TILE, m0, hf & 1, C, own0 + ROWS * w, b, h, own);
    if (two_own) load_tile(sm + S::OWN + (NC + w) * S::TILE, m1, hf & 2, C, own0 + ROWS * w, b, h, own);
  }
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    mbar_expect_tx(&full[s], 2 * S::TILE);
    const int row = (i % ntiles) * BN;
    load_tile(sm + S::RING + 2 * s * S::TILE, m2, hf & 4, C, row, b, h, &full[s]);
    load_tile(sm + S::RING + (2 * s + 1) * S::TILE, m3, hf & 8, C, row, b, h, &full[s]);
  }
}

// this consumer thread's place: warpgroup, warp in it, fragment coordinates
struct Place {
  int wg, warp, lane, g, t;
};

__device__ __forceinline__ Place place() {
  const int tid = threadIdx.x;
  return {tid / 128, (tid % 128) / 32, tid % 32, (tid % 32) / 4, tid % 4};
}

// align the dynamic shared memory to 1024 bytes (the swizzle's repeat) and
// initialise the barriers; every thread of the block calls it
template <int C>
__device__ __forceinline__ uint8_t* block_setup(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  uint8_t* sm = raw + (((a + 1023) & ~1023u) - a);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Smem<C>::BARS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[STAGES + s], 4 * NC);
    }
    mbar_init(&bars[2 * STAGES], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// quad (4 lanes of a row) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows (g, g + 8) of a warp's accumulator into an fp32 operand through
// (batch, head, row) strides; rows at or past T are not stored
template <int C>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Layout& L, int b, int h, int row0, int T,
                                           const float (&acc)[C / 2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    float* d = dst + attn::offset(L, b, h, row);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      *reinterpret_cast<float2*>(d + 8 * j + 2 * t) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// The block's role split (setmaxnreg): the producer warpgroup gives
// registers back, the consumer warpgroups take them. The producer's branch
// returns, so the two paths never reconverge.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// One tile's online softmax, exponentials in base 2, in the scores' units
// (where one key dominates, lse = max exactly): keys at or past `kvalid`
// score -inf; m, l: this lane's running max and sum of rows (g, g + 8);
// alpha: the correction of the rows' earlier sums; pa: P as bf16 fragments
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               uint32_t (&pa)[BN / 16][4], int kvalid, float scale, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int key = 8 * (e >> 2) + 2 * t + (e & 1);
    const float x = key < kvalid ? sc[e] * scale : -INFINITY;
    sc[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(m[r], quad_max(mx[r]));  // finite: every tile has a valid key
    alpha[r] = exp2f((m[r] - mnew) * LOG2E);
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const float pe = exp2f((sc[e] - m[(e >> 1) & 1]) * LOG2E);
    sc[e] = pe;
    l[(e >> 1) & 1] += pe;
  }
  to_frags(pa, sc);
}

// The consumers' loop over a block's streamed tiles, as a software pipeline
// (PIPE): tile i's register-operand products (`rs`, into the accumulators)
// run while tile i + 1's S-like products have finished and its elementwise
// work (`elementwise`, making the next fragments) runs on the CUDA cores.
//   prologue: S_0; elementwise_0
//   step i:   before(i); issue S_{i+1}; issue RS_i; wait for S_{i+1};
//             elementwise_{i+1}; wait for RS_i; release tile i
//   last:     before(n-1); RS_{n-1}; release
// Without PIPE a step runs RS_i, then S_{i+1} and elementwise_{i+1}, one
// after the other (fewer registers: one set of fragments). Tiles are steps
// first..first+n-1 of the ring. SAcc holds a tile's S-like accumulators,
// fresh in every step (no live range across steps); `ss(acc, stage)`
// issues a tile's S-like products into it, `elementwise(acc, i, frags)`
// turns tile i's results into fragments, `rs(stage, frags)` issues its
// register-operand products, `before(i)` runs before them (the forward's
// rescale of O).
template <int NF, class SAcc, bool PIPE, class SS, class RS, class EW, class BEFORE>
__device__ __forceinline__ void pipeline(uint64_t* bars, int first, int n, SS ss, RS rs, EW elementwise,
                                         BEFORE before, int lane) {
  using Frags = uint32_t[NF][BN / 16][4];
  Frags f0, f1;  // two sets, alternating (a copy between them would let ptxas merge them)
  auto stage = [&](int i) { return (first + i) % STAGES; };
  auto ready = [&](int i) { mbar_wait(&bars[stage(i)], ((first + i) / STAGES) & 1); };
  auto release = [&](int i, Frags& fr) {
    fence_frags(fr[0]);
    if constexpr (NF > 1) fence_frags(fr[1]);
    if (lane == 0) mbar_arrive(&bars[STAGES + stage(i)]);
  };
  auto s_step = [&](int i, Frags& out) {  // S-like products and elementwise of tile i
    SAcc acc;
    ready(i);
    wg_fence();
    ss(acc, stage(i));
    wg_commit();
    wg_wait();
    elementwise(acc, i, out);
  };
  auto rs_step = [&](int i, Frags& fr) {
    before(i);
    wg_fence();
    rs(stage(i), fr);
    wg_commit();
    wg_wait();
    release(i, fr);
  };
  // RS_i from fr while S_{i+1} is done and elementwise_{i+1} fills nx
  auto pipe_step = [&](int i, Frags& fr, Frags& nx) {
    before(i);
    SAcc acc;
    ready(i + 1);
    wg_fence();
    ss(acc, stage(i + 1));
    wg_commit();
    wg_fence();
    rs(stage(i), fr);
    wg_commit();
    wg_wait<1>();
    elementwise(acc, i + 1, nx);
    wg_wait();
    release(i, fr);
  };
  s_step(0, f0);
  if constexpr (PIPE) {
    for (int i = 0;; i += 2) {
      if (i + 1 >= n) {
        rs_step(i, f0);
        break;
      }
      pipe_step(i, f0, f1);
      if (i + 2 >= n) {
        rs_step(i + 1, f1);
        break;
      }
      pipe_step(i + 1, f1, f0);
    }
  } else {
    for (int i = 0; i + 1 < n; ++i) {
      rs_step(i, f0);
      s_step(i + 1, f0);
    }
    rs_step(n - 1, f0);
  }
}

// a tile's S-like accumulators: S (forward), S and dP (query pass), S^T
// and dP^T (key pass)
struct SOne {
  float s[BN / 2];
};
struct STwo {
  float s[BN / 2], d[BN / 2];
};

// ---------------------------------------------------------------------------
// Forward. grid (ceil(Tq / 128), H, B). m0: q; m2, m3: k, v. z (bf16)
// through `zl`, lse [B, H, Tq] when non-null; cv: c_v [B, H, C] or null (0).
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, int hf, const float* __restrict__ cv,
              bf16* __restrict__ z, float* __restrict__ lse, int H, int Tq, int Tk, Layout zl, float scale) {
  using S = Smem<C>;
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<C>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tk + BN - 1) / BN;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) produce<C>(sm, bars, &mq, &mq, &mk, &mv, hf, false, q0, b, h, ntiles, ntiles);
    return;
  }
  consumer_regs();
  const Place p = place();
  const uint32_t qs = smem_u32(sm + S::OWN + p.wg * S::TILE);
  const uint32_t ring = smem_u32(sm + S::RING);
  mbar_wait(&bars[2 * STAGES], 0);

  float o[C / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores
  float l[2] = {0.f, 0.f};              // this lane's part of the running sum
  float alpha[2] = {1.f, 1.f};
  // O = alpha * O + P (vt - c_v), accumulated in the tensor cores
  pipeline<1, SOne, true>(
      bars, 0, ntiles,
      [&](SOne& a, int st) { s_product<C>(a.s, qs, ring + 2 * st * S::TILE); },
      [&](int st, uint32_t (&fr)[1][BN / 16][4]) { pv_product<C>(o, fr[0], ring + (2 * st + 1) * S::TILE); },
      [&](SOne& a, int i, uint32_t (&fr)[1][BN / 16][4]) {
        fence_regs(a.s);
        online_softmax(a.s, m, l, alpha, fr[0], Tk - i * BN, scale, p.t);
      },
      [&](int) {
        fence_regs(o);  // after the wait for the last products into O
#pragma unroll
        for (int n = 0; n < C / 2; ++n) o[n] *= alpha[(n >> 1) & 1];
        fence_regs(o);  // and done before the next products are issued
      },
      p.lane);
  fence_regs(o);

  const int row0 = q0 + ROWS * p.wg + 16 * p.warp + p.g;
  const float* cvr = cv ? cv + ((int64_t)b * H + h) * C : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / lr;
    bf16* zr = z + attn::offset(zl, b, h, row);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * p.t;
      const float2 c = cvr ? *reinterpret_cast<const float2*>(cvr + col) : make_float2(0.f, 0.f);
      attn::store2(zr + col, o[4 * j + 2 * r] * inv + c.x, o[4 * j + 2 * r + 1] * inv + c.y);
    }
    if (lse && p.t == 0) lse[((int64_t)b * H + h) * Tq + row] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// Query pass. grid (ceil(Tq / 128), H, B). m0, m1: q, do (own rows); m2, m3:
// k, v. Writes dq (fp32) through `dql` and delta [B, H, Tq].
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_bwd_q(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv, int hf,
                const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq, int H, int Tq,
                int Tk, Layout dql, float scale) {
  using S = Smem<C>;
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<C>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tk + BN - 1) / BN;
  // each key tile once, or (more than one tile) twice: first for delta, then for dq
  const int sweep = ntiles > 1 ? ntiles : 0;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) {
      produce<C>(sm, bars, &mq, &mdo, &mk, &mv, hf, true, q0, b, h, ntiles, sweep + ntiles);
    }
    return;
  }
  consumer_regs();
  const Place p = place();
  const uint32_t qs = smem_u32(sm + S::OWN + p.wg * S::TILE);
  const uint32_t dos = smem_u32(sm + S::OWN + (NC + p.wg) * S::TILE);
  const uint32_t ring = smem_u32(sm + S::RING);
  const int row0 = q0 + ROWS * p.wg + 16 * p.warp + p.g;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const float ls[2] = {lse[hrow + min(row0, Tq - 1)], lse[hrow + min(row0 + 8, Tq - 1)]};
  mbar_wait(&bars[2 * STAGES], 0);

  // S = qt kt^T and dP = do vt^T of the tile in stage `st`, then
  // P = exp(S * scale - lse) in S (keys past Tk get 0)
  auto products = [&](STwo& a, int st) {
    s_product<C>(a.s, qs, ring + 2 * st * S::TILE);
    s_product<C>(a.d, dos, ring + (2 * st + 1) * S::TILE);
  };
  auto probabilities = [&](STwo& a, int tile) {
    fence_regs(a.s);
    fence_regs(a.d);
    const int kvalid = Tk - tile * BN;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int key = 8 * (e >> 2) + 2 * p.t + (e & 1);
      a.s[e] = key < kvalid ? exp2f((a.s[e] * scale - ls[(e >> 1) & 1]) * LOG2E) : 0.f;
    }
  };
  float dsum[2] = {0.f, 0.f};  // this lane's part of rowsum(P * dP)
  auto accumulate_delta = [&](const STwo& a) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) dsum[(e >> 1) & 1] = fmaf(a.s[e], a.d[e], dsum[(e >> 1) & 1]);
  };
  float dl[2] = {0.f, 0.f};  // delta of rows (g, g + 8), for dS here and for the key pass
  auto finish_delta = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] = quad_sum(dsum[r]);
      if (p.t == 0 && row0 + 8 * r < Tq) delta[hrow + row0 + 8 * r] = dl[r];
    }
  };

  // the first sweep: delta = rowsum(P * dP) over every key tile (tile by
  // tile: overlapping it as `pipeline` does made ptxas serialize every
  // product of the pass)
  for (int i = 0; i < sweep; ++i) {
    const int st = i % STAGES;
    STwo a;
    mbar_wait(&bars[st], (i / STAGES) & 1);
    wg_fence();
    products(a, st);
    wg_commit();
    wg_wait();
    probabilities(a, i);
    accumulate_delta(a);
    if (p.lane == 0) mbar_arrive(&bars[STAGES + st]);
  }
  if (sweep) finish_delta();

  // the second sweep (the only one for a single tile): dS = P (dP - delta)
  // * scale; dq += dS (kt - c_k)
  float dqa[C / 2];
  zero(dqa);
  pipeline<1, STwo, true>(
      bars, sweep, ntiles, products,
      [&](int st, uint32_t (&fr)[1][BN / 16][4]) { pv_product<C>(dqa, fr[0], ring + 2 * st * S::TILE); },
      [&](STwo& a, int i, uint32_t (&fr)[1][BN / 16][4]) {
        probabilities(a, i);
        if (!sweep) {
          accumulate_delta(a);
          finish_delta();
        }
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) a.s[e] = a.s[e] * (a.d[e] - dl[(e >> 1) & 1]) * scale;
        to_frags(fr[0], a.s);
      },
      [](int) {}, p.lane);
  fence_regs(dqa);
  store_rows<C>(dq, dql, b, h, row0, Tq, dqa, p.t);
}

// ---------------------------------------------------------------------------
// Key pass. grid (ceil(Tk / 128), H, B). m0, m1: k, v (own rows); m2, m3: q,
// do. Reads lse and delta [B, H, Tq]; writes dk and dv (fp32) through `dkl`.
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_bwd_kv(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo, int hf,
                 const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int Tq, int Tk, Layout dkl, float scale) {
  using S = Smem<C>;
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<C>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + S::BARS);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tq + BN - 1) / BN;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) produce<C>(sm, bars, &mk, &mv, &mq, &mdo, hf, true, k0, b, h, ntiles, ntiles);
    return;
  }
  consumer_regs();
  const Place p = place();
  const uint32_t ks = smem_u32(sm + S::OWN + p.wg * S::TILE);
  const uint32_t vs = smem_u32(sm + S::OWN + (NC + p.wg) * S::TILE);
  const uint32_t ring = smem_u32(sm + S::RING);
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  mbar_wait(&bars[2 * STAGES], 0);

  float dka[C / 2], dva[C / 2];
  zero(dka);
  zero(dva);
  pipeline<2, STwo, true>(
      bars, 0, ntiles,
      [&](STwo& a, int stg) {  // S^T = kt qt^T and dP^T = vt do^T
        s_product<C>(a.s, ks, ring + 2 * stg * S::TILE);
        s_product<C>(a.d, vs, ring + (2 * stg + 1) * S::TILE);
      },
      [&](int stg, uint32_t (&fr)[2][BN / 16][4]) {  // dv += P^T do, dk += dS^T qt
        pv_product<C>(dva, fr[0], ring + (2 * stg + 1) * S::TILE);
        pv_product<C>(dka, fr[1], ring + 2 * stg * S::TILE);
      },
      [&](STwo& a, int i, uint32_t (&fr)[2][BN / 16][4]) {
        // P^T = exp(S^T * scale - lse[q]), dS^T = P^T (dP^T - delta[q]) *
        // scale; queries past Tq get 0
        float(&st)[BN / 2] = a.s;
        float(&dpt)[BN / 2] = a.d;
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = i * BN + 8 * j + 2 * p.t + c;
            const bool ok = q < Tq;
            const float L = ok ? __ldg(lse + hrow + q) : 0.f;
            const float D = ok ? __ldg(delta + hrow + q) : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 4 * j + 2 * r + c;
              const float pe = ok ? exp2f((st[e] * scale - L) * LOG2E) : 0.f;
              st[e] = pe;
              dpt[e] = pe * (dpt[e] - D) * scale;
            }
          }
        }
        to_frags(fr[0], st);
        to_frags(fr[1], dpt);
      },
      [](int) {}, p.lane);
  fence_regs(dva);
  fence_regs(dka);
  const int row0 = k0 + ROWS * p.wg + 16 * p.warp + p.g;
  store_rows<C>(dk, dkl, b, h, row0, Tk, dka, p.t);
  store_rows<C>(dv, dkl, b, h, row0, Tk, dva, p.t);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launchers. Each launcher returns the launch's
// cudaError_t.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), fetched through the runtime: no link flag
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map of the bf16 rows of every (b, h) of an operand with strides `l`
// (elements), boxes of [64 rows][32 columns] with the 64-byte swizzle. Its
// dimensions ascend by stride: (C, H, T, B) for token-major rows, (C, T, H,
// B) for heads-first ones (*hf set). Rows past T read as zeros.
inline cudaError_t make_map(CUtensorMap* map, const bf16* base, Layout l, int T, int H, int B, int C, bool* hf) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  *hf = l.hs > l.rs;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)(*hf ? T : H), (cuuint64_t)(*hf ? H : T), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(*hf ? l.rs : l.hs) * 2, (cuuint64_t)(*hf ? l.hs : l.rs) * 2,
                                 (cuuint64_t)l.bs * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, *hf ? (cuuint32_t)BN : 1u, *hf ? 1u : (cuuint32_t)BN, 1u};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// maps of four operands, and the heads-first bits of the producer's `hf`
struct Maps {
  CUtensorMap m[4];
  int hf = 0;
};

inline cudaError_t make_maps(Maps& maps, const bf16* const (&ptr)[4], const Layout (&l)[4], const int (&T)[4], int H,
                             int B, int C) {
  for (int i = 0; i < 4; ++i) {
    bool hf = false;
    const cudaError_t err = make_map(&maps.m[i], ptr[i], l[i], T[i], H, B, C, &hf);
    if (err != cudaSuccess) return err;
    maps.hf |= hf ? 1 << i : 0;
  }
  return cudaSuccess;
}

template <class Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the forward over bf16 (q, k, v) into z (and lse when non-null); cv: the
// value rows' centre c_v [B, H, C] added back to z, or null
template <int C>
cudaError_t run_fwd(const bf16* q, const bf16* k, const bf16* v, const float* cv, bf16* z, float* lse, int B, int H,
                    int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout zl, float scale, cudaStream_t stream) {
  Maps maps;
  cudaError_t err = make_maps(maps, {q, q, k, v}, {ql, ql, kl, vl}, {Tq, Tq, Tk, Tk}, H, B, C);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_sm90_fwd<C>, Smem<C>::BYTES))) return err;
  attn_sm90_fwd<C><<<dim3((Tq + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, Smem<C>::BYTES, stream>>>(
      maps.m[0], maps.m[2], maps.m[3], maps.hf, cv, z, lse, H, Tq, Tk, zl, scale);
  return cudaGetLastError();
}

// the query pass (dq through dql, delta), then the key pass (dk, dv through
// dkl), over bf16 (q, k, v) and the cotangent do of z
template <int C>
cudaError_t run_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, float* delta,
                    float* dq, float* dk, float* dv, int B, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl,
                    Layout dol, Layout dql, Layout dkl, float scale, cudaStream_t stream) {
  Maps qm, km;
  cudaError_t err = make_maps(qm, {q, dout, k, v}, {ql, dol, kl, vl}, {Tq, Tq, Tk, Tk}, H, B, C);
  if (err == cudaSuccess) err = make_maps(km, {k, v, q, dout}, {kl, vl, ql, dol}, {Tk, Tk, Tq, Tq}, H, B, C);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_sm90_bwd_q<C>, Smem<C>::BYTES))) return err;
  if ((err = allow_smem(attn_sm90_bwd_kv<C>, Smem<C>::BYTES))) return err;
  attn_sm90_bwd_q<C><<<dim3((Tq + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, Smem<C>::BYTES, stream>>>(
      qm.m[0], qm.m[1], qm.m[2], qm.m[3], qm.hf, lse, delta, dq, H, Tq, Tk, dql, scale);
  if ((err = cudaGetLastError())) return err;
  attn_sm90_bwd_kv<C><<<dim3((Tk + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, Smem<C>::BYTES, stream>>>(
      km.m[0], km.m[1], km.m[2], km.m[3], km.hf, lse, delta, dk, dv, H, Tq, Tk, dkl, scale);
  return cudaGetLastError();
}

}  // namespace sm90
