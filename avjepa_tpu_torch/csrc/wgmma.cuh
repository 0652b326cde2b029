// wgmma (sm_90a) wrappers for the attention kernels: shared-memory matrix
// descriptors and the tile layout they read (TileLayout), the fence /
// commit / wait instructions, the mbarrier, TMA, named-barrier and
// setmaxnreg instructions of the warp-specialised forward kernel, and the
// two products, for bf16 and f16 with f32 accumulators:
//   WgmmaSS<T>::n64:  d[32] (+)= A (64 x 16, shared) . B (64 x 16, shared,
//                     K-major)^T                     S = Q . K^T
//   WgmmaSS<T>::n32:  the same with 32 rows of B, d[16]
//   WgmmaRS<T, N>::run: d[N/2] += A (64 x 16, registers) . B (16 x N, shared,
//                     MN-major: the transpose flag)  O += P . V
//   WgmmaRK<T>::n64:  d[32] (+)= A (64 x 16, registers) . B (64 x 16, shared,
//                     K-major)^T                     S = Q . K^T, q held
//   TileLayout<DP>::rs: WgmmaRS over a whole tile row of DP columns (at
//                     DP = 80 an n64 and an n16 product into one d[40])
// Accumulator layout of m64nNk16 (thread = 32 * warp + 4 * g + t): d[4j],
// d[4j+1] are row 16 * warp + g, columns 8j + 2t and 8j + 2t + 1; d[4j+2],
// d[4j+3] are row 16 * warp + g + 8, same columns: each warp's 16 rows are
// laid out as mma.sync m16n8 tiles. The register A operand is mma.sync
// m16n8k16's A fragment of the warp's 16 rows.
// The operand lists below are written out in full, as PTX needs them.
#pragma once

#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// swizzle mode of a descriptor (bits 62-63): 128-, 64- or 32-byte rows
constexpr int SWIZZLE_128B = 1;
constexpr int SWIZZLE_64B = 2;
constexpr int SWIZZLE_32B = 3;

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the same for a register A operand, which an issued wgmma reads until its
// wait: its registers must not be reused before then
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
  }
}

// shared memory written by cp.async (the generic proxy) is made visible to
// wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- mbarriers, TMA, named barriers and setmaxnreg (the warp-specialised
// forward kernel). Barrier and shared addresses are shared-window addresses
// (smem_addr); a tensor map is a __grid_constant__ kernel parameter.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// makes the mbarrier.init of this thread visible to the block (and to TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// one arrival that also expects `bytes` of TMA traffic before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed (a new barrier is in
// phase 0, so parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at `dst`; its bytes count against mbarrier `bar`'s
// expected traffic (elements outside the tensor arrive as zeros)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads') over `count` threads: wait
// for it, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// the executing warpgroup's register cap (all four warps together)
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <typename T> struct WgmmaSS;
template <typename T, int N> struct WgmmaRS;
template <typename T> struct WgmmaRK;

// Shared-memory layout of a [rows][DP] tile, as wgmma reads it: column
// blocks of ROWB bytes a row (64 elements, or 32 when DP = 32), each block
// [rows][ROWB] with its 16-byte chunks swizzled (128-byte rows: chunk c of
// row r sits at c ^ (r % 8); 64-byte rows: at c ^ ((r / 2) % 4)). A tile
// starts on a 1024-byte boundary. DP = 80 has a layout of its own (below).
template <int DP>
struct TileLayout {
  static constexpr int ROWB = DP == 32 ? 64 : 128;
  static constexpr int EPR = ROWB / 2;  // elements a row of a column block
  static constexpr int CPB = ROWB / 16;  // 16-byte chunks a row of a column block
  static constexpr int SWIZZLE = ROWB == 128 ? SWIZZLE_128B : SWIZZLE_64B;
  // byte offset of 16-byte chunk c (elements 8c..8c+7) of row r
  static __device__ __forceinline__ int offset(int r, int c, int rows) {
    const int sw = ROWB == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / CPB) * rows * ROWB + r * ROWB + (((c % CPB) ^ sw) << 4);
  }
  // descriptor of a K-major operand (Q, K): rows of [rows][DP] from
  // `first_row`, elements 16kk..16kk+15 along DP (8-row groups 8 * ROWB apart)
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int rows, int first_row,
                                                     int kk) {
    const int e = 16 * kk;
    return make_desc(base + (e / EPR) * rows * ROWB + first_row * ROWB + (e % EPR) * 2, 16,
                     8 * ROWB, SWIZZLE);
  }
  // d += a . B, B = rows 16kt..16kt+15 of a 64-row tile at `base` (V, dO,
  // qs or ks) as the MN-major operand (8-row groups 8 * ROWB apart, column
  // blocks 64 * ROWB)
  template <typename T>
  static __device__ __forceinline__ void rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                                            uint32_t base, int kt) {
    WgmmaRS<T, DP>::run(d, a, make_desc(base + 16 * kt * ROWB, 64 * ROWB, 8 * ROWB, SWIZZLE));
  }
};

// DP = 80 (d = 80 unpadded): a 160-byte row is no swizzle period, so a tile
// is a [rows][64] block of 128-byte rows (128-byte swizzle) followed by a
// [rows][16] block of 32-byte rows (32-byte swizzle: chunk c of row r sits
// at c ^ ((r / 4) % 2)). A product over DP runs as 4 k16 steps in the first
// block and 1 in the second; rs, over a 64-row tile's 80 columns, as an
// n64 and an n16 product whose accumulators, side by side, are the n80
// layout. (Five 16-column blocks under the 32-byte swizzle, with one n80
// product, ran K1 at ViT-H's target shape ~4% slower on an H100.)
template <>
struct TileLayout<80> {
  static __device__ __forceinline__ int offset(int r, int c, int rows) {
    return c < 8 ? r * 128 + ((c ^ (r & 7)) << 4)
                 : rows * 128 + r * 32 + (((c - 8) ^ ((r >> 2) & 1)) << 4);
  }
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int rows, int first_row,
                                                     int kk) {
    return kk < 4 ? make_desc(base + first_row * 128 + 32 * kk, 16, 8 * 128, SWIZZLE_128B)
                  : make_desc(base + rows * 128 + first_row * 32, 16, 8 * 32, SWIZZLE_32B);
  }
  template <typename T>
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4],
                                            uint32_t base, int kt) {
    WgmmaRS<T, 64>::run(*reinterpret_cast<float(*)[32]>(&d[0]), a,
                        make_desc(base + 16 * kt * 128, 64 * 128, 8 * 128, SWIZZLE_128B));
    WgmmaRS<T, 16>::run(*reinterpret_cast<float(*)[8]>(&d[32]), a,
                        make_desc(base + 64 * 128 + 16 * kt * 32, 64 * 32, 8 * 32, SWIZZLE_32B));
  }
};

template <> struct WgmmaSS<__nv_bfloat16> {
  // d (+)= A . B^T, m64n32k16 (B: 32 rows)
  static __device__ __forceinline__ void n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d (+)= A . B^T, m64n64k16; accumulate == 0 overwrites d
  static __device__ __forceinline__ void n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <> struct WgmmaRK<__nv_bfloat16> {
  // d (+)= A . B^T, m64n64k16, A from registers, B K-major (no transpose);
  // accumulate == 0 overwrites d
  static __device__ __forceinline__ void n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <> struct WgmmaRS<__nv_bfloat16, 16> {
  // d += A . B, m64n16k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__nv_bfloat16, 32> {
  // d += A . B, m64n32k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__nv_bfloat16, 64> {
  // d += A . B, m64n64k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__nv_bfloat16, 128> {
  // d += A . B, m64n128k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaSS<__half> {
  // d (+)= A . B^T, m64n32k16 (B: 32 rows)
  static __device__ __forceinline__ void n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d (+)= A . B^T, m64n64k16; accumulate == 0 overwrites d
  static __device__ __forceinline__ void n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <> struct WgmmaRK<__half> {
  // d (+)= A . B^T, m64n64k16, A from registers, B K-major (no transpose);
  // accumulate == 0 overwrites d
  static __device__ __forceinline__ void n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <> struct WgmmaRS<__half, 16> {
  // d += A . B, m64n16k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__half, 32> {
  // d += A . B, m64n32k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__half, 64> {
  // d += A . B, m64n64k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct WgmmaRS<__half, 128> {
  // d += A . B, m64n128k16, B MN-major (transposed)
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

}  // namespace
