// The bf16 softmax attention core on Hopper's warpgroup tensor-core
// products (wgmma) fed by the Tensor Memory Accelerator (TMA): forward,
// query pass and key pass. Called by the bf16 entries of
// csrc/gta_fused_fwd.cu and csrc/gta_fused_bwd.cu over the rows their row
// launches transformed (qt, and kt, vt centred on their means in fp32
// before the rounding to bf16) or the raw token-major rows of a side
// without a transform, and by the bf16 entries of csrc/flash_core_fwd.cu
// and csrc/flash_core_bwd.cu over flash_core's raw token-major q, k, v
// (c_v = 0). It is the attention core of the TPU kernels
// gta_tpu/ops/gta_fused.py:209 `_fwd_kernel` and :235 `_bwd_kernel`, and
// the whole of gta_tpu/ops/flash_core.py:73 `_fwd_kernel` and :86
// `_bwd_kernel`, with mxu = bfloat16. Per (batch b, head h), head width
// C = 64 or 96:
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
// are fp32; z and the gradients are written from the fp32 accumulators
// once, in the caller's type (`Out`: fp32 for the fused GTA kernels, whose
// chains and dM reductions go on in fp32, and for flash_core behind GTA's
// sliced transforms, whose rows are fp32 on the TPU and only their product
// operands bf16; bf16 for flash_core on bf16 rows, the TPU kernel's
// `.astype(q.dtype)`).
//
// What bounds it on the H100: 4*Tq*Tk*C flops per (b, h) forward, 10*Tq*Tk*C
// backward (the function's 5 products), against a few bytes per row: 160
// to 300 flops per byte at msn's shapes, so it is bound by operations,
// at 989 TFLOP/s of dense bf16. At C = 64 the softmax's exponentials (one
// per score, 16 a clock on an SM) cost as much time as the score's share
// of the two forward products, so the CUDA cores' work has to hide behind
// the tensor cores'.
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
//    once and streams the other side's rows in tiles of KT rows through a
//    ring of STAGES (4) stages in shared memory by TMA, with a `full`
//    mbarrier per stage (TMA's transaction count) and an `empty` one (an
//    arrive per consumer warp when its products have read the stage). The
//    two warpgroups share every tile, so a tile is read from L2 once per
//    128 own rows.
//  * Each consumer warpgroup runs a software pipeline (`pipeline`): tile
//    i + 1's S-like products are issued before tile i's register-operand
//    ones, so tile i + 1's softmax (or P and dS) runs on the CUDA cores
//    while tile i's P.V-like products run on the tensor cores. The two
//    warpgroups also take turns to issue (ping-pong, named barriers), so
//    that one's products run while the other's softmax does.
//  * An instance's tiling is a `Cfg`: the head width and KT (64 or 128
//    rows of a streamed tile in the forward and the query pass; the key
//    pass streams 64). The fused GTA kernels take 64, flash_core's entries
//    128 (PERF.md has each choice's time).
//  * Tiles sit in shared memory as 32-column TMA boxes, [rows][32] bf16
//    with the 64-byte swizzle (a 192-byte row at C = 96 is wider than the
//    128-byte swizzle span; C = 64 and 96 are both whole boxes); a 128-row
//    tile is two 64-row boxes a column, one after the other (the swizzle
//    follows the address). The wgmma descriptors name that swizzle:
//    K-major, a k16 step is 32 bytes into a box's rows; MN-major, the
//    boxes are the 32-wide atoms along N.
//  * Every operand is one 4-D tensor map (C, H, T, B) through its own
//    strides, heads-first scratch [B, H, T, C] and token-major rows
//    [B, T, H*C] alike (a row of H*C bf16 is a multiple of TMA's 16 bytes):
//    rows past T are zero-filled by TMA per (b, h), never read from the
//    next head. Keys past Tk score -inf, queries past Tq get P = 0, rows
//    past the end store nothing.
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
//    second sweep's S, dP and dq += dS k. (From the forward's bf16 output,
//    rowsum(do * o) would carry o's rounding into every dS row's sum, which
//    dq = dS k multiplies by the keys' common component: 116x the TPU
//    rounding's error in dq where keys share one of 8x their spread,
//    scripts/probe_delta_from_o.py.)
//    The key pass is one pass for dk and dv at C = 64 and 96: its 64 key
//    rows a warpgroup hold C fp32 accumulators a thread for dk and dv, 64
//    for S^T and dP^T and 32 registers of P^T and dS^T fragments for each
//    of two tiles in flight, within the 240 registers setmaxnreg gives a
//    consumer thread (at the launch's 168 the joint pass spilled at C = 96;
//    pipelined, it spilled at 232), so there is no dv/dk split (which
//    recomputed S^T twice). 9 products where the function has 5 (the
//    sweep's 2 and both passes' S).
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
constexpr int BN = 64;                     // rows of a streamed tile of the key pass (and the default)
constexpr int STAGES = 4;                  // streamed tiles in the ring
constexpr int BOX = 32;                    // columns of a TMA box: 64 bytes, the 64-byte swizzle
constexpr int BOX_BYTES = 64 * BOX * 2;    // a box of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

// An instance's tiling: head width C; KT rows of a streamed tile in the
// forward and the query pass (64 or 128; the key pass streams BN). Shared
// memory of a block: own tiles [2 operands][NC] of 64 rows, the ring
// [STAGES][2 operands] of KT rows, each tile C / 32 column boxes of
// [rows][32]; then the mbarriers full[STAGES], empty[STAGES], own.
template <int C_, int KT_ = BN>
struct Cfg {
  static constexpr int C = C_, KT = KT_;
  static_assert(KT % 64 == 0 && KT <= 128, "tiles of 64 or 128 rows");
  static constexpr int OWN_TILE = ROWS * C * 2;
  static constexpr int TILE = KT * C * 2;
  static constexpr int OWN = 0;
  static constexpr int RING = OWN + 2 * NC * OWN_TILE;
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + slack to align the base to 1024
  static_assert(BYTES <= 232448, "a block's shared memory");
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

// named barrier `id` (1 and 2; 0 is __syncthreads) over the 256 consumer
// threads: wait for the other warpgroup's arrival, or arrive for it
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

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

// K-major operand, k16 step `ks` of a tile of `rows` rows at `tile` (C / 32
// column boxes of [rows][32]): 8-row groups 512 bytes apart, a k16 step 32
// bytes into a box's rows
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks, int rows = ROWS) {
  return make_desc(tile + (ks >> 1) * rows * BOX * 2 + (ks & 1) * 32, 16, 512);
}

// MN-major B operand (its rows are the k index), k16 step `kk` of a tile of
// `rows` rows: the 32-column boxes are the atoms along N (rows * 64 bytes
// apart), 8-row groups along k 512 bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int rows = ROWS) {
  return make_desc(tile + kk * 1024, rows * BOX * 2, 512);
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

template <>
struct Mma<128> {  // the S-like products over 128-row tiles
  // d (+)= A B, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
        "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, "
        "%63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// d += A T for a KT-row tile T, MN-major, and A the k16 fragments `a` of
// the KT columns of an S-like accumulator
template <int C, int KT>
__device__ __forceinline__ void pv_product(float (&d)[C / 2], const uint32_t (&a)[KT / 16][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) Mma<C>::rs(d, a[kk], desc_mn(tile, kk, KT), 1);
}

// s = A B^T over C channels for a 64-row K-major tile A (the own rows) and
// a KT-row one B
template <int C, int KT = BN>
__device__ __forceinline__ void s_product(float (&s)[KT / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) Mma<KT>::ss(s, desc_k(a, ks), desc_k(b, ks, KT), ks > 0);
}

// the K k16 A fragments of the 16K columns of an S-like accumulator, rounded
// to bf16 (columns 16kk..16kk+15 are n8 blocks 2kk, 2kk + 1)
template <int K, int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[K][4], const float (&s)[N]) {
  static_assert(N == 8 * K, "16 columns a fragment");
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
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

// tensor-map coordinates of rows [row, row + rows) of (b, h), in boxes of
// 64 rows: maps are (C, H, T, B), or (C, T, H, B) for heads-first rows
// (`hf`); a column box of a 128-row tile is two 64-row boxes in a row
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, bool hf, int C, int row, int b,
                                          int h, uint64_t* bar, int rows = ROWS) {
  for (int bx = 0; bx < C / BOX; ++bx) {
    for (int r = 0; r < rows; r += 64) {
      tma_load(dst + bx * rows * BOX * 2 + r * BOX * 2, map, bx * BOX, hf ? row + r : h, hf ? h : row + r, b, bar);
    }
  }
}

// The producer's thread: the own tiles of both consumer warpgroups (map
// m0, and m1 when `two_own`) from row `own0`, then `steps` streamed tiles
// of maps m2 and m3 (tile i % ntiles) through the ring. hf: bit i set when
// map mi is heads-first.
template <class G>
__device__ __forceinline__ void produce(uint8_t* sm, uint64_t* bars, const CUtensorMap* m0, const CUtensorMap* m1,
                                        const CUtensorMap* m2, const CUtensorMap* m3, int hf, bool two_own,
                                        int own0, int b, int h, int ntiles, int steps) {
  constexpr int C = G::C;
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* own = bars + 2 * STAGES;
  mbar_expect_tx(own, (two_own ? 2 : 1) * NC * G::OWN_TILE);
  for (int w = 0; w < NC; ++w) {
    load_tile(sm + G::OWN + w * G::OWN_TILE, m0, hf & 1, C, own0 + ROWS * w, b, h, own);
    if (two_own) load_tile(sm + G::OWN + (NC + w) * G::OWN_TILE, m1, hf & 2, C, own0 + ROWS * w, b, h, own);
  }
  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    mbar_expect_tx(&full[s], 2 * G::TILE);
    const int row = (i % ntiles) * G::KT;
    load_tile(sm + G::RING + 2 * s * G::TILE, m2, hf & 4, C, row, b, h, &full[s], G::KT);
    load_tile(sm + G::RING + (2 * s + 1) * G::TILE, m3, hf & 8, C, row, b, h, &full[s], G::KT);
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
template <class G>
__device__ __forceinline__ uint8_t* block_setup(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  uint8_t* sm = raw + (((a + 1023) & ~1023u) - a);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BARS);
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

// rows (g, g + 8) of a warp's fp32 accumulator into an operand of type Out
// (fp32 or bf16, rounded once) through (batch, head, row) strides; rows at
// or past T are not stored
template <int C, class Out>
__device__ __forceinline__ void store_rows(Out* __restrict__ dst, const Layout& L, int b, int h, int row0, int T,
                                           const float (&acc)[C / 2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    Out* d = dst + attn::offset(L, b, h, row);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) attn::store2(d + 8 * j + 2 * t, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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

// Ping-pong: the two consumer warpgroups take turns to issue their
// products, through named barrier 1 + wg of each, so that one's products
// run on the tensor cores while the other's softmax runs on the CUDA cores.
// Warpgroup 1 lets warpgroup 0 go first (`start`); each issue is between
// `take` (wait for the other's turn to end) and `give`; warpgroup 0 takes
// the last turn back (`finish`), so every barrier ends complete.
struct Turns {
  int wg;
  __device__ __forceinline__ void start() const {
    if (wg == 1) bar_arrive(1);
  }
  __device__ __forceinline__ void take() const { bar_sync(1 + wg); }
  __device__ __forceinline__ void give() const { bar_arrive(2 - wg); }
  __device__ __forceinline__ void finish() const {
    if (wg == 0) bar_sync(1);
  }
};

// Masking: only a side's last tile has rows past its end, so the other
// tiles take the loops without the test (MASK false; the same values).

// a tile's scores scaled into sc, their row maxima into mx; keys at or
// past `kvalid` score -inf (the product rounded on its own in either
// branch, never fused into the exponent's subtraction)
template <bool MASK, int N>
__device__ __forceinline__ void scaled_scores(float (&sc)[N], float (&mx)[2], int kvalid, float scale, int t) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float x = !MASK || 8 * (e >> 2) + 2 * t + (e & 1) < kvalid ? __fmul_rn(sc[e], scale) : -INFINITY;
    sc[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
}

// P = exp(S * scale - lse) of a tile's scores in place, lse of rows
// (g, g + 8); keys at or past `kvalid` get 0
template <bool MASK, int N>
__device__ __forceinline__ void probabilities(float (&s)[N], const float (&ls)[2], int kvalid, float scale, int t) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const bool ok = !MASK || 8 * (e >> 2) + 2 * t + (e & 1) < kvalid;
    s[e] = ok ? exp2f((s[e] * scale - ls[(e >> 1) & 1]) * LOG2E) : 0.f;
  }
}

// The key pass's P^T = exp(S^T * scale - lse[q]) in st and dS^T = P^T
// (dP^T - delta[q]) * scale in dpt, for the queries q0 + 8j + 2t (+1) of
// a tile (lse, delta: the rows of (b, h)); queries past Tq get 0
template <bool MASK, int N>
__device__ __forceinline__ void transposed_grads(float (&st)[N], float (&dpt)[N], const float* __restrict__ lse,
                                                 const float* __restrict__ delta, int q0, int Tq, float scale,
                                                 int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int q = q0 + 8 * j + 2 * t + c;
      const bool ok = !MASK || q < Tq;
      const float L = ok ? __ldg(lse + q) : 0.f;
      const float D = ok ? __ldg(delta + q) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 4 * j + 2 * r + c;
        const float pe = ok ? exp2f((st[e] * scale - L) * LOG2E) : 0.f;
        st[e] = pe;
        dpt[e] = pe * (dpt[e] - D) * scale;
      }
    }
  }
}

// One tile's online softmax, exponentials in base 2, in the scores' units
// (where one key dominates, lse = max exactly): keys at or past `kvalid`
// score -inf; m, l: this lane's running max and sum of rows (g, g + 8);
// alpha: the correction of the rows' earlier sums; pa: P as bf16 fragments
template <int KT>
__device__ __forceinline__ void online_softmax(float (&sc)[KT / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               uint32_t (&pa)[KT / 16][4], int kvalid, float scale, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (kvalid < KT) {
    scaled_scores<true>(sc, mx, kvalid, scale, t);
  } else {
    scaled_scores<false>(sc, mx, kvalid, scale, t);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(m[r], quad_max(mx[r]));  // finite: every tile has a valid key
    alpha[r] = exp2f((m[r] - mnew) * LOG2E);
    m[r] = mnew;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) {
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
// first..first+n-1 of the ring, of G::KT rows. SAcc holds a tile's S-like
// accumulators, fresh in every step (no live range across steps);
// `ss(acc, stage)` issues a tile's S-like products into it,
// `elementwise(acc, i, frags)` turns tile i's results into fragments,
// `rs(stage, frags)` issues its register-operand products, `before(i)` runs
// before them (the forward's rescale of O). Every issue is one of `turns`.
template <class G, int NF, class SAcc, bool PIPE, class SS, class RS, class EW, class BEFORE>
__device__ __forceinline__ void pipeline(uint64_t* bars, int first, int n, SS ss, RS rs, EW elementwise,
                                         BEFORE before, int lane, const Turns& turns) {
  using Frags = uint32_t[NF][G::KT / 16][4];
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
    turns.take();
    wg_fence();
    ss(acc, stage(i));
    wg_commit();
    turns.give();
    wg_wait();
    elementwise(acc, i, out);
  };
  auto rs_step = [&](int i, Frags& fr) {
    before(i);
    turns.take();
    wg_fence();
    rs(stage(i), fr);
    wg_commit();
    turns.give();
    wg_wait();
    release(i, fr);
  };
  // RS_i from fr while S_{i+1} is done and elementwise_{i+1} fills nx
  auto pipe_step = [&](int i, Frags& fr, Frags& nx) {
    before(i);
    SAcc acc;
    ready(i + 1);
    turns.take();
    wg_fence();
    ss(acc, stage(i + 1));
    wg_commit();
    wg_fence();
    rs(stage(i), fr);
    wg_commit();
    turns.give();
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
// and dP^T (key pass), over KT keys (or queries)
template <int KT>
struct SOne {
  float s[KT / 2];
};
template <int KT>
struct STwo {
  float s[KT / 2], d[KT / 2];
};

// ---------------------------------------------------------------------------
// Forward. grid (ceil(Tq / 128), H, B). m0: q; m2, m3: k, v. z (Out: bf16,
// or fp32 where the caller keeps the output unrounded) through `zl`, lse
// [B, H, Tq] when non-null; cv: c_v [B, H, C] or null (0).
// ---------------------------------------------------------------------------
template <class G, class Out>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, int hf, const float* __restrict__ cv,
              Out* __restrict__ z, float* __restrict__ lse, int H, int Tq, int Tk, Layout zl, float scale) {
  constexpr int C = G::C, KT = G::KT;
  using Frags = uint32_t[1][KT / 16][4];
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<G>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BARS);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tk + KT - 1) / KT;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) produce<G>(sm, bars, &mq, &mq, &mk, &mv, hf, false, q0, b, h, ntiles, ntiles);
    return;
  }
  consumer_regs();
  const Place p = place();
  const Turns turns{p.wg};
  const uint32_t qs = smem_u32(sm + G::OWN + p.wg * G::OWN_TILE);
  const uint32_t ring = smem_u32(sm + G::RING);
  mbar_wait(&bars[2 * STAGES], 0);

  float o[C / 2];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores
  float l[2] = {0.f, 0.f};              // this lane's part of the running sum
  float alpha[2] = {1.f, 1.f};
  // O = alpha * O + P (vt - c_v), accumulated in the tensor cores
  turns.start();
  pipeline<G, 1, SOne<KT>, true>(
      bars, 0, ntiles,
      [&](SOne<KT>& a, int st) { s_product<C, KT>(a.s, qs, ring + 2 * st * G::TILE); },
      [&](int st, Frags& fr) { pv_product<C, KT>(o, fr[0], ring + (2 * st + 1) * G::TILE); },
      [&](SOne<KT>& a, int i, Frags& fr) {
        fence_regs(a.s);
        online_softmax<KT>(a.s, m, l, alpha, fr[0], Tk - i * KT, scale, p.t);
      },
      [&](int) {
        fence_regs(o);  // after the wait for the last products into O
#pragma unroll
        for (int n = 0; n < C / 2; ++n) o[n] *= alpha[(n >> 1) & 1];
        fence_regs(o);  // and done before the next products are issued
      },
      p.lane, turns);
  turns.finish();
  fence_regs(o);

  const int row0 = q0 + ROWS * p.wg + 16 * p.warp + p.g;
  const float* cvr = cv ? cv + ((int64_t)b * H + h) * C : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = row0 + 8 * r;
    if (row >= Tq) continue;
    const float inv = 1.f / lr;
    Out* zr = z + attn::offset(zl, b, h, row);
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
// k, v. Writes dq (Out) through `dql` and delta [B, H, Tq].
// ---------------------------------------------------------------------------
template <class G, class Out>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_bwd_q(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv, int hf,
                const float* __restrict__ lse, float* __restrict__ delta, Out* __restrict__ dq, int H, int Tq,
                int Tk, Layout dql, float scale) {
  constexpr int C = G::C, KT = G::KT;
  using Frags = uint32_t[1][KT / 16][4];
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<G>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BARS);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tk + KT - 1) / KT;
  // each key tile once, or (more than one tile) twice: first for delta, then for dq
  const int sweep = ntiles > 1 ? ntiles : 0;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) {
      produce<G>(sm, bars, &mq, &mdo, &mk, &mv, hf, true, q0, b, h, ntiles, sweep + ntiles);
    }
    return;
  }
  consumer_regs();
  const Place p = place();
  const Turns turns{p.wg};
  const uint32_t qs = smem_u32(sm + G::OWN + p.wg * G::OWN_TILE);
  const uint32_t dos = smem_u32(sm + G::OWN + (NC + p.wg) * G::OWN_TILE);
  const uint32_t ring = smem_u32(sm + G::RING);
  const int row0 = q0 + ROWS * p.wg + 16 * p.warp + p.g;
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  const float ls[2] = {lse[hrow + min(row0, Tq - 1)], lse[hrow + min(row0 + 8, Tq - 1)]};
  mbar_wait(&bars[2 * STAGES], 0);

  // S = qt kt^T and dP = do vt^T of the tile in stage `st`, then
  // P = exp(S * scale - lse) in S (keys past Tk get 0)
  auto products = [&](STwo<KT>& a, int st) {
    s_product<C, KT>(a.s, qs, ring + 2 * st * G::TILE);
    s_product<C, KT>(a.d, dos, ring + (2 * st + 1) * G::TILE);
  };
  auto probabilities_of = [&](STwo<KT>& a, int tile) {
    fence_regs(a.s);
    fence_regs(a.d);
    const int kvalid = Tk - tile * KT;
    if (kvalid < KT) {
      probabilities<true>(a.s, ls, kvalid, scale, p.t);
    } else {
      probabilities<false>(a.s, ls, kvalid, scale, p.t);
    }
  };
  float dsum[2] = {0.f, 0.f};  // this lane's part of rowsum(P * dP)
  auto accumulate_delta = [&](const STwo<KT>& a) {
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) dsum[(e >> 1) & 1] = fmaf(a.s[e], a.d[e], dsum[(e >> 1) & 1]);
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
  turns.start();
  for (int i = 0; i < sweep; ++i) {
    const int st = i % STAGES;
    STwo<KT> a;
    mbar_wait(&bars[st], (i / STAGES) & 1);
    turns.take();
    wg_fence();
    products(a, st);
    wg_commit();
    turns.give();
    wg_wait();
    probabilities_of(a, i);
    accumulate_delta(a);
    if (p.lane == 0) mbar_arrive(&bars[STAGES + st]);
  }
  if (sweep) finish_delta();

  // the second sweep (the only one for a single tile): dS = P (dP - delta)
  // * scale; dq += dS (kt - c_k)
  float dqa[C / 2];
  zero(dqa);
  pipeline<G, 1, STwo<KT>, true>(
      bars, sweep, ntiles, products,
      [&](int st, Frags& fr) { pv_product<C, KT>(dqa, fr[0], ring + 2 * st * G::TILE); },
      [&](STwo<KT>& a, int i, Frags& fr) {
        probabilities_of(a, i);
        if (!sweep) {
          accumulate_delta(a);
          finish_delta();
        }
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) a.s[e] = a.s[e] * (a.d[e] - dl[(e >> 1) & 1]) * scale;
        to_frags(fr[0], a.s);
      },
      [](int) {}, p.lane, turns);
  turns.finish();
  fence_regs(dqa);
  store_rows<C>(dq, dql, b, h, row0, Tq, dqa, p.t);
}

// ---------------------------------------------------------------------------
// Key pass. grid (ceil(Tk / 128), H, B). m0, m1: k, v (own rows); m2, m3: q,
// do, in tiles of G::KT = BN queries. Reads lse and delta [B, H, Tq];
// writes dk and dv (Out) through `dkl`.
// ---------------------------------------------------------------------------
template <class G, class Out>
__global__ void __launch_bounds__(THREADS, 1)
attn_sm90_bwd_kv(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo, int hf,
                 const float* __restrict__ lse, const float* __restrict__ delta, Out* __restrict__ dk,
                 Out* __restrict__ dv, int H, int Tq, int Tk, Layout dkl, float scale) {
  constexpr int C = G::C;
  static_assert(G::KT == BN, "the key pass streams 64-query tiles");
  using Frags = uint32_t[2][BN / 16][4];
  extern __shared__ __align__(16) uint8_t sm90_smem[];
  uint8_t* sm = block_setup<G>(sm90_smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::BARS);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * NC * ROWS;
  const int ntiles = (Tq + BN - 1) / BN;
  if (threadIdx.x >= 128 * NC) {
    producer_regs();
    if (threadIdx.x == 128 * NC) produce<G>(sm, bars, &mk, &mv, &mq, &mdo, hf, true, k0, b, h, ntiles, ntiles);
    return;
  }
  consumer_regs();
  const Place p = place();
  const Turns turns{p.wg};
  const uint32_t ks = smem_u32(sm + G::OWN + p.wg * G::OWN_TILE);
  const uint32_t vs = smem_u32(sm + G::OWN + (NC + p.wg) * G::OWN_TILE);
  const uint32_t ring = smem_u32(sm + G::RING);
  const int64_t hrow = ((int64_t)b * H + h) * Tq;
  mbar_wait(&bars[2 * STAGES], 0);

  float dka[C / 2], dva[C / 2];
  zero(dka);
  zero(dva);
  turns.start();
  pipeline<G, 2, STwo<BN>, true>(
      bars, 0, ntiles,
      [&](STwo<BN>& a, int stg) {  // S^T = kt qt^T and dP^T = vt do^T
        s_product<C>(a.s, ks, ring + 2 * stg * G::TILE);
        s_product<C>(a.d, vs, ring + (2 * stg + 1) * G::TILE);
      },
      [&](int stg, Frags& fr) {  // dv += P^T do, dk += dS^T qt
        pv_product<C, BN>(dva, fr[0], ring + (2 * stg + 1) * G::TILE);
        pv_product<C, BN>(dka, fr[1], ring + 2 * stg * G::TILE);
      },
      [&](STwo<BN>& a, int i, Frags& fr) {
        fence_regs(a.s);
        fence_regs(a.d);
        if ((i + 1) * BN > Tq) {
          transposed_grads<true>(a.s, a.d, lse + hrow, delta + hrow, i * BN, Tq, scale, p.t);
        } else {
          transposed_grads<false>(a.s, a.d, lse + hrow, delta + hrow, i * BN, Tq, scale, p.t);
        }
        to_frags(fr[0], a.s);
        to_frags(fr[1], a.d);
      },
      [](int) {}, p.lane, turns);
  turns.finish();
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
  const cuuint32_t box[4] = {(cuuint32_t)BOX, *hf ? (cuuint32_t)ROWS : 1u, *hf ? 1u : (cuuint32_t)ROWS, 1u};
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

// the forward over bf16 (q, k, v) into z (Out: bf16 or fp32; and lse when
// non-null); cv: the value rows' centre c_v [B, H, C] added back to z, or
// null
template <class G, class Out>
cudaError_t run_fwd(const bf16* q, const bf16* k, const bf16* v, const float* cv, Out* z, float* lse, int B, int H,
                    int Tq, int Tk, Layout ql, Layout kl, Layout vl, Layout zl, float scale, cudaStream_t stream) {
  Maps maps;
  cudaError_t err = make_maps(maps, {q, q, k, v}, {ql, ql, kl, vl}, {Tq, Tq, Tk, Tk}, H, B, G::C);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_sm90_fwd<G, Out>, G::BYTES))) return err;
  attn_sm90_fwd<G, Out><<<dim3((Tq + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, G::BYTES, stream>>>(
      maps.m[0], maps.m[2], maps.m[3], maps.hf, cv, z, lse, H, Tq, Tk, zl, scale);
  return cudaGetLastError();
}

// the query pass (dq through dql, delta), then the key pass (dk, dv through
// dkl, in 64-query tiles), over bf16 (q, k, v) and the cotangent do of z;
// the gradients in Out (fp32 or bf16)
template <class G, class Out>
cudaError_t run_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse, float* delta,
                    Out* dq, Out* dk, Out* dv, int B, int H, int Tq, int Tk, Layout ql, Layout kl, Layout vl,
                    Layout dol, Layout dql, Layout dkl, float scale, cudaStream_t stream) {
  using GK = Cfg<G::C, BN>;
  Maps qm, km;
  cudaError_t err = make_maps(qm, {q, dout, k, v}, {ql, dol, kl, vl}, {Tq, Tq, Tk, Tk}, H, B, G::C);
  if (err == cudaSuccess) err = make_maps(km, {k, v, q, dout}, {kl, vl, ql, dol}, {Tk, Tk, Tq, Tq}, H, B, G::C);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(attn_sm90_bwd_q<G, Out>, G::BYTES))) return err;
  if ((err = allow_smem(attn_sm90_bwd_kv<GK, Out>, GK::BYTES))) return err;
  attn_sm90_bwd_q<G, Out><<<dim3((Tq + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, G::BYTES, stream>>>(
      qm.m[0], qm.m[1], qm.m[2], qm.m[3], qm.hf, lse, delta, dq, H, Tq, Tk, dql, scale);
  if ((err = cudaGetLastError())) return err;
  attn_sm90_bwd_kv<GK, Out><<<dim3((Tk + NC * ROWS - 1) / (NC * ROWS), H, B), THREADS, GK::BYTES, stream>>>(
      km.m[0], km.m[1], km.m[2], km.m[3], km.hf, lse, delta, dk, dv, H, Tq, Tk, dkl, scale);
  return cudaGetLastError();
}

}  // namespace sm90
