// Device helpers shared by the attention kernels (attention_fwd.cu,
// attention_bwd.cu): constants of the TPU kernels' contract, the key bias,
// quad reductions, ex2, cp.async, ldmatrix and the mma.sync m16n8k16
// wrappers.
//
// Fragment layouts of mma.m16n8k16 (lane = 4*g + t): the f32 accumulator
// c[0..1] is row g, columns 2t and 2t+1; c[2..3] is row g + 8, same
// columns. The A operand a[0..3] is (row g, k 2t..2t+1), (row g+8, k 2t..),
// (row g, k 2t+8..), (row g+8, k 2t+8..); so the accumulators of two 8-wide
// column tiles, rounded and packed, are exactly the A operand of 16 k.
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_D = 128;
constexpr float NEG_BIAS = -1e30f;
constexpr float SOFTMAX_CLAMP = 80.0f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// bias of one key; keys past N are excluded like masked keys
__device__ __forceinline__ float key_bias(const float* bias_g, int key, int N) {
  if (key >= N) return NEG_BIAS;
  return bias_g ? bias_g[key] : 0.0f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x in one MUFU.EX2 (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with valid == false the 16 bytes are zero-filled and
// nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4-byte async copy (through L1: the 16-byte form is the only one that may
// bypass it); zero-filled when valid == false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  // d += a (16x16, row) . b (16x8, col)
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// x (two 16-bit values) -> bf16/f16(f32(x) * scale), elementwise: the TPU
// kernels' "scale in f32, round back to the input type"
template <typename T>
__device__ __forceinline__ void scale_frag(uint32_t (&r)[4], float scale) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = Mma<T>::unpack(r[j]);
    r[j] = Mma<T>::pack(x.x * scale, x.y * scale);
  }
}

inline bool aligned16(const void* ptr, long long sb, long long sh, long long sn) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 && sn % 8 == 0;
}

inline size_t elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

// dynamic shared memory above 48 KB needs the attribute; returns the launch's
// own error (a refused launch never runs, and a synchronize would not say so)
template <typename Kernel, typename P>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem, const P& p,
                          cudaStream_t stream, int threads = NTHREADS) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
