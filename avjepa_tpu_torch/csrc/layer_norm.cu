// LayerNorm kernels for Hopper (sm_90a), behind a plain C interface that
// avjepa_tpu_torch/ops/layer_norm.py binds with ctypes.
//
// Replaces the two Pallas TPU kernels of avjepa_tpu/ops/layer_norm.py:
//   avj_ln_fwd <- _fwd_kernel (K5). Per row of x [R, C]: mean = sum(x) / C
//     and xc = x - mean in f32, var = sum(xc^2) / C (two passes over the row,
//     not E[x^2] - mean^2), xhat = xc * rsqrt(var + eps), y = xhat * gamma +
//     beta in f32, rounded once to x's type.
//   avj_ln_bwd <- _bwd_kernel (K6). mean and rstd are recomputed from x (the
//     forward saves no statistics); g = dy * gamma, dx = rstd * (g - mean(g)
//     - xhat * mean(g * xhat)), rounded once to x's type; dgamma = sum over
//     rows of dy * xhat and dbeta = sum over rows of dy, in f32.
//
// What bounds it on the H100: a few flops per element against two (K5: x
// read, y written) or three (K6: x, dy read, dx written) element transfers,
// far below the ~295 flop/byte ridge, so bytes bound both kernels: at
// R = 39,936 and C = 1024 in bf16, 163.6 MB (0.049 ms) and 245.4 MB
// (0.073 ms) at 3.35 TB/s.
//
// Design. One warp per row. Each lane holds its share of the row in
// registers, loaded 16 bytes at a time (8 bf16/f16 or 4 f32 values; a chunk
// spans 32 lanes), so every input is read from device memory once and every
// row reduction is a warp shuffle. The TPU kernel adds dgamma/dbeta across
// its sequential row blocks in VMEM; Hopper blocks run in no order, so each
// block of 64 rows writes f32 partial sums [num_blocks, C] (its 8 warps'
// sums added in a fixed order through shared memory) and a second kernel
// adds the partials over the blocks in a fixed order: deterministic, no
// atomics, as the attention backward kernels chose. A ragged C (not a
// multiple of the vector width, or rows not 16-byte aligned) takes scalar
// loads with masked tails; a ragged R masks the last block's rows. Rows
// wider than the register path's 1536 columns take a streaming variant that
// reads the row again (from L1/L2) for each pass. Not yet used: TMA,
// persistent blocks, several rows per warp in flight.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LN_WARPS = 8;
constexpr int LN_THREADS = LN_WARPS * 32;
constexpr int BWD_ROWS_PER_WARP = 8;
constexpr int BWD_ROWS = LN_WARPS * BWD_ROWS_PER_WARP;  // rows per backward block
constexpr int REG_MAX_C = 1536;  // widest row the register path holds

template <typename T> struct Elt;

template <> struct Elt<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <> struct Elt<__half> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half from_f(float x) { return __float2half_rn(x); }
};

template <> struct Elt<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// v[k * VEC + j] <- row[(k * 32 + lane) * VEC + j], 0 past C. With `vec`
// (C % VEC == 0 and 16-byte aligned rows) a chunk is one 16-byte load.
template <typename T, int NCHUNK>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int C, int lane, bool vec,
                                         float* v) {
  constexpr int VEC = Elt<T>::VEC;
#pragma unroll
  for (int k = 0; k < NCHUNK; ++k) {
    const int c0 = (k * 32 + lane) * VEC;
    if (vec) {
      if (c0 < C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c0);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[k * VEC + j] = Elt<T>::to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[k * VEC + j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k * VEC + j] = c0 + j < C ? Elt<T>::to_f(row[c0 + j]) : 0.0f;
      }
    }
  }
}

template <typename T, int NCHUNK>
__device__ __forceinline__ void store_row(T* __restrict__ row, int C, int lane, bool vec,
                                          const float* v) {
  constexpr int VEC = Elt<T>::VEC;
#pragma unroll
  for (int k = 0; k < NCHUNK; ++k) {
    const int c0 = (k * 32 + lane) * VEC;
    if (vec) {
      if (c0 < C) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) e[j] = Elt<T>::from_f(v[k * VEC + j]);
        *reinterpret_cast<uint4*>(row + c0) = raw;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (c0 + j < C) row[c0 + j] = Elt<T>::from_f(v[k * VEC + j]);
      }
    }
  }
}

// VEC f32 values of gamma or beta at column c0 (0 past C)
template <int VEC>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int c0, int C, bool vec,
                                           float* out) {
  if (vec && c0 < C) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + c0 + j);
      out[j] = f.x;
      out[j + 1] = f.y;
      out[j + 2] = f.z;
      out[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = c0 + j < C ? p[c0 + j] : 0.0f;
  }
}

// in place: v <- xc = v - mean (0 past C); returns rstd = rsqrt(var + eps)
template <int EPT, int VEC>
__device__ __forceinline__ float center(float* v, int C, int lane, float eps) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) s += v[i];
  const float mean = warp_sum(s) / C;
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int c = ((i / VEC) * 32 + lane) * VEC + i % VEC;
    v[i] = c < C ? v[i] - mean : 0.0f;
    ss += v[i] * v[i];
  }
  return rsqrtf(warp_sum(ss) / C + eps);
}

// K5, register path: one warp per row, 8 rows per block
template <typename T, int NCHUNK>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, long long R, int C, float eps,
              bool vec) {
  constexpr int VEC = Elt<T>::VEC;
  constexpr int EPT = NCHUNK * VEC;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  float v[EPT];
  load_row<T, NCHUNK>(x + row * C, C, lane, vec, v);
  const float rstd = center<EPT, VEC>(v, C, lane, eps);
#pragma unroll
  for (int k = 0; k < NCHUNK; ++k) {
    const int c0 = (k * 32 + lane) * VEC;
    float g[VEC], b[VEC];
    load_param<VEC>(gamma, c0, C, vec, g);
    load_param<VEC>(beta, c0, C, vec, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xhat = v[k * VEC + j] * rstd;
      v[k * VEC + j] = xhat * g[j] + b[j];
    }
  }
  store_row<T, NCHUNK>(y + row * C, C, lane, vec, v);
}

// K5, streaming path (C > REG_MAX_C): one warp per row, three passes
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, long long R, int C,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * LN_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += Elt<T>::to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float ss = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = Elt<T>::to_f(xr[c]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + eps);
  T* yr = y + row * C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (Elt<T>::to_f(xr[c]) - mean) * rstd;
    yr[c] = Elt<T>::from_f(xhat * gamma[c] + beta[c]);
  }
}

// K6, register path: a block takes 64 rows (8 a warp); writes dx and the
// block's dgamma/dbeta partial row part[0 or 1][blockIdx.x][:]
template <typename T, int NCHUNK>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
              long long R, int C, float eps, bool vec) {
  constexpr int VEC = Elt<T>::VEC;
  constexpr int EPT = NCHUNK * VEC;
  __shared__ float red[2][LN_WARPS][32 * VEC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc_g[EPT], acc_b[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc_g[i] = acc_b[i] = 0.0f;

  const long long row0 = static_cast<long long>(blockIdx.x) * BWD_ROWS + warp * BWD_ROWS_PER_WARP;
  for (int r = 0; r < BWD_ROWS_PER_WARP; ++r) {
    const long long row = row0 + r;
    if (row >= R) break;
    float xv[EPT], g[EPT];
    load_row<T, NCHUNK>(x + row * C, C, lane, vec, xv);
    load_row<T, NCHUNK>(dy + row * C, C, lane, vec, g);
    const float rstd = center<EPT, VEC>(xv, C, lane, eps);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < NCHUNK; ++k) {
      float gam[VEC];
      load_param<VEC>(gamma, (k * 32 + lane) * VEC, C, vec, gam);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int i = k * VEC + j;
        const float xhat = xv[i] * rstd;
        const float d = g[i];
        acc_g[i] += d * xhat;
        acc_b[i] += d;
        const float gg = d * gam[j];
        sg += gg;
        sgx += gg * xhat;
        xv[i] = xhat;
        g[i] = gg;
      }
    }
    const float a = warp_sum(sg) / C;
    const float bt = warp_sum(sgx) / C;
#pragma unroll
    for (int i = 0; i < EPT; ++i) g[i] = rstd * (g[i] - a - xv[i] * bt);
    store_row<T, NCHUNK>(dx + row * C, C, lane, vec, g);
  }

  // the block's partial sums, chunk by chunk: warp w's share lands in
  // red[.][w], then one thread per column adds the 8 warps in order
  float* part_g = part + static_cast<size_t>(blockIdx.x) * C;
  float* part_b = part + static_cast<size_t>(gridDim.x + blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < NCHUNK; ++k) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][warp][lane * VEC + j] = acc_g[k * VEC + j];
      red[1][warp][lane * VEC + j] = acc_b[k * VEC + j];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * VEC; t += LN_THREADS) {
      const int c = k * 32 * VEC + t;
      if (c < C) {
        float sgam = 0.0f, sbet = 0.0f;
#pragma unroll
        for (int w = 0; w < LN_WARPS; ++w) {
          sgam += red[0][w][t];
          sbet += red[1][w][t];
        }
        part_g[c] = sgam;
        part_b[c] = sbet;
      }
    }
    __syncthreads();
  }
}

// K6, streaming path (C > REG_MAX_C): each warp takes the statistics of its
// 8 rows in passes over memory; then each thread walks columns and adds the
// block's 64 rows in order
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                     long long R, int C, float eps) {
  __shared__ float stats[BWD_ROWS][4];  // mean, rstd, mean(g), mean(g * xhat)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * BWD_ROWS;
  for (int r = 0; r < BWD_ROWS_PER_WARP; ++r) {
    const int local = warp * BWD_ROWS_PER_WARP + r;
    const long long row = base + local;
    if (row >= R) break;
    const T* xr = x + row * C;
    const T* dr = dy + row * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += Elt<T>::to_f(xr[c]);
    const float mean = warp_sum(s) / C;
    float ss = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = Elt<T>::to_f(xr[c]) - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / C + eps);
    float sg = 0.0f, sgx = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (Elt<T>::to_f(xr[c]) - mean) * rstd;
      const float gg = Elt<T>::to_f(dr[c]) * gamma[c];
      sg += gg;
      sgx += gg * xhat;
    }
    const float a = warp_sum(sg) / C;
    const float bt = warp_sum(sgx) / C;
    if (lane == 0) {
      stats[local][0] = mean;
      stats[local][1] = rstd;
      stats[local][2] = a;
      stats[local][3] = bt;
    }
  }
  __syncthreads();
  const int rows = static_cast<int>(R - base < BWD_ROWS ? R - base : BWD_ROWS);
  float* part_g = part + static_cast<size_t>(blockIdx.x) * C;
  float* part_b = part + static_cast<size_t>(gridDim.x + blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += LN_THREADS) {
    const float gam = gamma[c];
    float sgam = 0.0f, sbet = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const long long off = (base + r) * C + c;
      const float xhat = (Elt<T>::to_f(x[off]) - stats[r][0]) * stats[r][1];
      const float d = Elt<T>::to_f(dy[off]);
      sgam += d * xhat;
      sbet += d;
      dx[off] = Elt<T>::from_f(stats[r][1] * (d * gam - stats[r][2] - xhat * stats[r][3]));
    }
    part_g[c] = sgam;
    part_b[c] = sbet;
  }
}

// out[w][c] = sum over blocks b (in order of b mod 8, then of the 8 groups)
// of part[w][b][c], for w = 0 (dgamma) and 1 (dbeta); block (32, 8), grid
// (ceil(C / 32), 2)
__global__ void __launch_bounds__(256)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nb, int C) {
  __shared__ float red[8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + static_cast<size_t>(blockIdx.y) * nb * C;
  float s = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int b = threadIdx.y; b < nb; b += 8) s += p[static_cast<size_t>(b) * C + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][threadIdx.x];
    out[static_cast<size_t>(blockIdx.y) * C + c] = t;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long bwd_blocks(long long R) { return (R + BWD_ROWS - 1) / BWD_ROWS; }

// chunks of 32 * VEC columns a lane set needs, rounded up to an instantiated count
template <int VEC>
int chunks_for(int C) {
  const int need = (C + 32 * VEC - 1) / (32 * VEC);
  if (need <= 6) return need;
  if (need <= 8) return 8;
  if (need <= 10) return 10;
  return 12;
}

template <typename T, int NCHUNK>
cudaError_t fwd_launch(const void* x, const float* gamma, const float* beta, void* y,
                       long long R, int C, float eps, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((R + LN_WARPS - 1) / LN_WARPS));
  ln_fwd_kernel<T, NCHUNK><<<grid, LN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), R, C, eps, vec);
  return cudaGetLastError();
}

template <typename T, int NCHUNK>
cudaError_t bwd_launch(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                       long long R, int C, float eps, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(bwd_blocks(R)));
  ln_bwd_kernel<T, NCHUNK><<<grid, LN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part, R,
      C, eps, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_fwd(const void* x, const float* gamma, const float* beta, void* y, long long R,
                   int C, float eps, cudaStream_t stream) {
  constexpr int VEC = Elt<T>::VEC;
  if (C > REG_MAX_C) {
    const dim3 grid(static_cast<unsigned>((R + LN_WARPS - 1) / LN_WARPS));
    ln_fwd_stream_kernel<T><<<grid, LN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), R, C, eps);
    return cudaGetLastError();
  }
  const bool vec = C % VEC == 0 && aligned16(x) && aligned16(y) && aligned16(gamma) &&
                   aligned16(beta);
  switch (chunks_for<VEC>(C)) {
    case 1: return fwd_launch<T, 1>(x, gamma, beta, y, R, C, eps, vec, stream);
    case 2: return fwd_launch<T, 2>(x, gamma, beta, y, R, C, eps, vec, stream);
    case 3: return fwd_launch<T, 3>(x, gamma, beta, y, R, C, eps, vec, stream);
    case 4: return fwd_launch<T, 4>(x, gamma, beta, y, R, C, eps, vec, stream);
    case 5: return fwd_launch<T, 5>(x, gamma, beta, y, R, C, eps, vec, stream);
    case 6: return fwd_launch<T, 6>(x, gamma, beta, y, R, C, eps, vec, stream);
    default: break;
  }
  if constexpr (VEC == 4) {  // f32 rows of 769-1536 columns
    switch (chunks_for<VEC>(C)) {
      case 8: return fwd_launch<T, 8>(x, gamma, beta, y, R, C, eps, vec, stream);
      case 10: return fwd_launch<T, 10>(x, gamma, beta, y, R, C, eps, vec, stream);
      case 12: return fwd_launch<T, 12>(x, gamma, beta, y, R, C, eps, vec, stream);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t ln_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                   float* out, long long R, int C, float eps, cudaStream_t stream) {
  constexpr int VEC = Elt<T>::VEC;
  cudaError_t err = cudaErrorInvalidValue;
  if (C > REG_MAX_C) {
    const dim3 grid(static_cast<unsigned>(bwd_blocks(R)));
    ln_bwd_stream_kernel<T><<<grid, LN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
        R, C, eps);
    err = cudaGetLastError();
  } else {
    const bool vec = C % VEC == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                     aligned16(gamma);
    switch (chunks_for<VEC>(C)) {
      case 1: err = bwd_launch<T, 1>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      case 2: err = bwd_launch<T, 2>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      case 3: err = bwd_launch<T, 3>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      case 4: err = bwd_launch<T, 4>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      case 5: err = bwd_launch<T, 5>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      case 6: err = bwd_launch<T, 6>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
      default:
        if constexpr (VEC == 4) {
          switch (chunks_for<VEC>(C)) {
            case 8: err = bwd_launch<T, 8>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
            case 10: err = bwd_launch<T, 10>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
            case 12: err = bwd_launch<T, 12>(x, gamma, dy, dx, part, R, C, eps, vec, stream); break;
            default: break;
          }
        }
        break;
    }
  }
  if (err != cudaSuccess) return err;
  const int nb = static_cast<int>(bwd_blocks(R));
  ln_bwd_reduce_kernel<<<dim3((C + 31) / 32, 2), dim3(32, 8), 0, stream>>>(part, out, nb, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = f16, 2 = bf16. x, y, dy, dx are [R, C] contiguous;
// gamma and beta are [C] f32 contiguous. Returns a cudaError_t (0 on
// success); the launches are asynchronous on `stream`.

// K5: y = LayerNorm(x) * gamma + beta
int avj_ln_fwd(int dtype, const void* x, const float* gamma, const float* beta, void* y,
               long long R, int C, float eps, void* stream) {
  if (C <= 0 || R < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return ln_fwd<float>(x, gamma, beta, y, R, C, eps, s);
    case 1: return ln_fwd<__half>(x, gamma, beta, y, R, C, eps, s);
    case 2: return ln_fwd<__nv_bfloat16>(x, gamma, beta, y, R, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// rows of the f32 partial-sum workspace avj_ln_bwd needs for each of
// dgamma and dbeta: it takes 2 * avj_ln_bwd_blocks(R) * C floats
long long avj_ln_bwd_blocks(long long R) { return bwd_blocks(R); }

// K6: dx, and dgamma | dbeta as out [2, C] f32; part is the workspace above
int avj_ln_bwd(int dtype, const void* x, const float* gamma, const void* dy, void* dx,
               float* part, float* out, long long R, int C, float eps, void* stream) {
  if (C <= 0 || R < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return cudaMemsetAsync(out, 0, 2 * static_cast<size_t>(C) * sizeof(float), s);
  switch (dtype) {
    case 0: return ln_bwd<float>(x, gamma, dy, dx, part, out, R, C, eps, s);
    case 1: return ln_bwd<__half>(x, gamma, dy, dx, part, out, R, C, eps, s);
    case 2: return ln_bwd<__nv_bfloat16>(x, gamma, dy, dx, part, out, R, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
