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
// K5's design. One warp per row, 8 rows a block. Each lane holds its share of
// the row in registers, loaded 16 bytes at a time (8 bf16/f16 or 4 f32
// values; a chunk spans 32 lanes), so every input is read from device memory
// once and every row reduction is a warp shuffle. A ragged C (not a multiple
// of the vector width, or rows not 16-byte aligned) takes scalar loads with
// masked tails. Rows wider than 1536 columns take a streaming variant that
// reads the row again (from L1/L2) for each pass.
//
// K6's design (the register path, C <= 1536):
// - Persistent blocks. One block of 8 warps an SM (the grid is the SM count,
//   cut to the row tiles), registers unbounded (up to 255 a thread). A tile
//   is 8 x (rows a warp) rows; block b takes tiles b, b + grid, b + 2 grid,
//   ... in that order, and each lane keeps its columns' dgamma/dbeta sums in
//   registers across all of them.
// - A ring of row tiles. Each warp stages its rows of x and dy in shared
//   memory with 16-byte cp.async, 2-4 stages deep (deeper for narrow rows),
//   so the next rows load while the current ones reduce. Each lane copies
//   exactly the chunks it reads, so a lane waits on its own copy groups and
//   no barrier runs in the loop. Each pass over the row (mean, variance, the
//   two sums, dx) reads its chunks from the ring again, so registers hold
//   the sums and one chunk, not the row. gamma sits in shared memory as f32.
//   dx leaves by 16-byte stores.
// - Width classes. A row is spread over L = 32, 16 or 8 lanes (1, 2 or 4
//   rows a warp at once), whichever pads the row least in chunks of L x 16
//   bytes: C = 1024 and 1280 take 32 lanes, 384 takes 16 (3 chunks, not
//   1.5), 192 takes 8 (bf16). Row sums run over each chunk, then over a
//   lane's chunks in order, then as a butterfly over the L lanes.
// - One fixed-order sum. At its end a block adds its lane groups' sums in
//   row-slot order through shared memory (the ring reused) and writes one
//   partial row pair part[0 or 1][block][:] (1 MB at 132 x 1024); a second
//   kernel adds the grid's partials in a fixed order (thread row r takes
//   blocks r, r + 32, ... in order, then the 32 row sums in order). The
//   order depends only on R, C and the grid, so two runs give the same
//   bits; no atomics.
// A ragged C takes scalar loads into the same ring, with masked tails; a
// ragged R zero-fills the rows past R (they add exact zeros) and stores no
// dx for them. Rows wider than 1536 columns take a streaming variant with 64
// rows a block and the same final sum.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LN_WARPS = 8;
constexpr int LN_THREADS = LN_WARPS * 32;
constexpr int BWD_ROWS_PER_WARP = 8;
constexpr int BWD_ROWS = LN_WARPS * BWD_ROWS_PER_WARP;  // rows a streaming backward block
constexpr int REG_MAX_C = 1536;  // widest row the register path holds
constexpr int BWD_WARPS = 8;     // warps of a persistent backward block, one block an SM
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int RED_COLS = 16;  // the final sum's block: 16 columns x 32 rows of blocks
constexpr int RED_ROWS = 32;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy to shared memory; with valid == false the 16 bytes are
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a 16-byte shared-memory load that is issued where it stands (volatile): a
// row read again for each pass costs no registers between the passes
__device__ __forceinline__ uint4 lds128(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(smem_addr(p)));
  return v;
}

__device__ __forceinline__ float4 lds128f(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem_addr(p)));
  return v;
}

// sum over the L lanes of a lane group (a butterfly: every lane ends with it)
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ float elt(const uint4& u, int j) {
  return Elt<T>::to_f(reinterpret_cast<const T*>(&u)[j]);
}

// ring stages of a warp: deeper for narrow rows (rings twice as deep measured
// no faster on the H100)
constexpr int bwd_stages(int nchunk) { return nchunk <= 3 ? 4 : nchunk == 4 ? 3 : 2; }

// The register path's geometry for rows of L lanes and NCHUNK chunks a lane.
template <typename T, int L, int NCHUNK>
struct BwdShape {
  static constexpr int VEC = Elt<T>::VEC;
  static constexpr int RPW = 32 / L;                   // rows a warp takes at once
  static constexpr int TILE_ROWS = BWD_WARPS * RPW;    // rows a tile
  static constexpr int WIDTH = NCHUNK * L * VEC;       // the row padded to whole chunks
  static constexpr int S = bwd_stages(NCHUNK);
  static constexpr int STAGE = 2 * NCHUNK * 32;        // uint4 of a warp's stage: x, then dy
  static constexpr int RING = BWD_WARPS * S * STAGE;   // uint4
  static constexpr int SMEM = WIDTH * 4 + RING * 16;   // gamma (f32), then the ring
  // the block's final sum reuses the ring: [dgamma, dbeta][TILE_ROWS][WIDTH] f32
  static_assert(2 * TILE_ROWS * WIDTH * 4 <= RING * 16, "block sum does not fit the ring");
};

// K6, register path: persistent blocks over row tiles; writes dx and the
// block's dgamma/dbeta partial row part[0 or 1][blockIdx.x][:]
template <typename T, int L, int NCHUNK>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ln_bwd_kernel(const void* x_, const float* __restrict__ gamma, const void* dy_, void* dx_,
              float* __restrict__ part, long long R, int C, float eps, bool vec) {
  using Sh = BwdShape<T, L, NCHUNK>;
  constexpr int VEC = Sh::VEC;
  constexpr int Q = VEC / 4;  // float4 of gamma a chunk
  constexpr int S = Sh::S;
  const T* __restrict__ x = static_cast<const T*>(x_);
  const T* __restrict__ dy = static_cast<const T*>(dy_);
  T* __restrict__ dx = static_cast<T*>(dx_);
  extern __shared__ __align__(16) uint4 smem[];
  float4* gam_s = reinterpret_cast<float4*>(smem);  // [NCHUNK][Q][L]: a lane's chunk, 4 at a time
  uint4* ring = smem + Sh::WIDTH / 4;                // [warp][stage][x, dy][NCHUNK][lane]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % L;  // lane within its row's group
  const int slot = warp * Sh::RPW + lane / L;  // the group's row within a tile

  for (int i = threadIdx.x; i < Sh::WIDTH / 4; i += BWD_THREADS) {
    const int l = i % L, q = (i / L) % Q, k = i / (L * Q);
    const int c = (k * L + l) * VEC + 4 * q;
    gam_s[i] = make_float4(c < C ? gamma[c] : 0.0f, c + 1 < C ? gamma[c + 1] : 0.0f,
                           c + 2 < C ? gamma[c + 2] : 0.0f, c + 3 < C ? gamma[c + 3] : 0.0f);
  }

  const long long ntiles = (R + Sh::TILE_ROWS - 1) / Sh::TILE_ROWS;
  const int mine =
      blockIdx.x < ntiles ? static_cast<int>((ntiles - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  uint4* wring = ring + warp * S * Sh::STAGE + lane;
  auto row_of = [&](int i) {
    return (blockIdx.x + static_cast<long long>(i) * gridDim.x) * Sh::TILE_ROWS + slot;
  };
  // stage i % S <- this lane's chunks of x and dy in its row of tile i (zero
  // past R and past C); one copy group a call, empty past the last tile
  auto issue = [&](int i) {
    if (i < mine) {
      const long long row = row_of(i);
      uint4* st = wring + (i % S) * Sh::STAGE;
#pragma unroll
      for (int k = 0; k < NCHUNK; ++k) {
        const int c0 = (k * L + li) * VEC;
        if (vec) {
          const bool in = row < R && c0 < C;
          const long long off = in ? row * C + c0 : 0;
          cp_async16(st + k * 32, x + off, in);
          cp_async16(st + (NCHUNK + k) * 32, dy + off, in);
        } else {
          uint4 ux, ud;
          T* ex = reinterpret_cast<T*>(&ux);
          T* ed = reinterpret_cast<T*>(&ud);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const bool in = row < R && c0 + j < C;
            ex[j] = in ? x[row * C + c0 + j] : Elt<T>::from_f(0.0f);
            ed[j] = in ? dy[row * C + c0 + j] : Elt<T>::from_f(0.0f);
          }
          st[k * 32] = ux;
          st[(NCHUNK + k) * 32] = ud;
        }
      }
    }
    cp_async_commit();
  };

  float acc_g[NCHUNK * VEC], acc_b[NCHUNK * VEC];
#pragma unroll
  for (int i = 0; i < NCHUNK * VEC; ++i) acc_g[i] = acc_b[i] = 0.0f;
  __syncthreads();  // gamma in shared memory

#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int i = 0; i < mine; ++i) {
    issue(i + S - 1);        // into the stage this lane read in iteration i - 1
    cp_async_wait<S - 1>();  // this lane's copies of tile i have landed
    const uint4* sx = wring + (i % S) * Sh::STAGE;
    const uint4* sd = sx + NCHUNK * 32;
    // each pass reads its chunks of x and dy from the ring again: registers
    // hold the sums and the chunk in use, never the whole row
    auto xk = [&](int k) { return lds128(sx + k * 32); };
    auto dk = [&](int k) { return lds128(sd + k * 32); };
    auto gam = [&](int k, float* g) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 f = lds128f(gam_s + (k * Q + q) * L + li);
        g[4 * q] = f.x;
        g[4 * q + 1] = f.y;
        g[4 * q + 2] = f.z;
        g[4 * q + 3] = f.w;
      }
    };

    // mean and rstd by two passes over the row. A lane's sums run over each
    // chunk's VEC values, then over its chunks in order: NCHUNK short chains
    // in flight, not one long one. Zeros past C add nothing to the mean; the
    // square sum masks them (per value only in a chunk that straddles C).
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NCHUNK; ++k) {
      const uint4 u = xk(k);
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) p += elt<T>(u, j);
      s += p;
    }
    const float mean = group_sum<L>(s) / C;
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NCHUNK; ++k) {
      const int c0 = (k * L + li) * VEC;
      const uint4 u = xk(k);
      float p = 0.0f;
      if (c0 + VEC <= C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = elt<T>(u, j) - mean;
          p += d * d;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = c0 + j < C ? elt<T>(u, j) - mean : 0.0f;
          p += d * d;
        }
      }
      ss += p;
    }
    const float rstd = rsqrtf(group_sum<L>(ss) / C + eps);

    // the sums over the row, chunk by chunk as above, and the row's share of
    // dgamma/dbeta (a row past R is zeros: xhat = 0 and dy = 0 add exact zeros)
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < NCHUNK; ++k) {
      const uint4 u = xk(k), v = dk(k);
      float g[VEC];
      gam(k, g);
      float pg = 0.0f, pgx = 0.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xhat = (elt<T>(u, j) - mean) * rstd;
        const float d = elt<T>(v, j);
        acc_g[k * VEC + j] += d * xhat;
        acc_b[k * VEC + j] += d;
        const float gg = d * g[j];
        pg += gg;
        pgx += gg * xhat;
      }
      sg += pg;
      sgx += pgx;
    }
    const float a = group_sum<L>(sg) / C;
    const float bt = group_sum<L>(sgx) / C;

    const long long row = row_of(i);
    if (row < R) {
#pragma unroll
      for (int k = 0; k < NCHUNK; ++k) {
        const int c0 = (k * L + li) * VEC;
        if (c0 < C) {
          const uint4 u = xk(k), v = dk(k);
          float g[VEC];
          gam(k, g);
          uint4 raw;
          T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xhat = (elt<T>(u, j) - mean) * rstd;
            e[j] = Elt<T>::from_f(rstd * (elt<T>(v, j) * g[j] - a - xhat * bt));
          }
          T* out = dx + row * C + c0;
          if (vec) {
            *reinterpret_cast<uint4*>(out) = raw;
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (c0 + j < C) out[j] = e[j];
            }
          }
        }
      }
    }
  }

  // the block's partial row pair: each lane group's sums land in the ring
  // (every warp is done with it), then one thread a column adds the groups
  // in slot order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int k = 0; k < NCHUNK; ++k) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = (k * L + li) * VEC + 4 * q;
      const int i = k * VEC + 4 * q;
      *reinterpret_cast<float4*>(red + slot * Sh::WIDTH + c) =
          make_float4(acc_g[i], acc_g[i + 1], acc_g[i + 2], acc_g[i + 3]);
      *reinterpret_cast<float4*>(red + (Sh::TILE_ROWS + slot) * Sh::WIDTH + c) =
          make_float4(acc_b[i], acc_b[i + 1], acc_b[i + 2], acc_b[i + 3]);
    }
  }
  __syncthreads();
  float* part_g = part + static_cast<size_t>(blockIdx.x) * C;
  float* part_b = part + static_cast<size_t>(gridDim.x + blockIdx.x) * C;
  for (int c = threadIdx.x; c < C; c += BWD_THREADS) {
    float sgam = 0.0f, sbet = 0.0f;
#pragma unroll 8
    for (int r = 0; r < Sh::TILE_ROWS; ++r) {
      sgam += red[r * Sh::WIDTH + c];
      sbet += red[(Sh::TILE_ROWS + r) * Sh::WIDTH + c];
    }
    part_g[c] = sgam;
    part_b[c] = sbet;
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

// out[w][c] = sum over blocks b of part[w][b][c], for w = 0 (dgamma) and 1
// (dbeta): thread row r adds blocks r, r + 32, r + 64, ... in order, then row
// 0 adds the 32 row sums in order; block (16, 32), grid (ceil(C / 16), 2)
__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int nb, int C) {
  __shared__ float red[RED_ROWS][RED_COLS + 1];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  const float* p = part + static_cast<size_t>(blockIdx.y) * nb * C;
  float s = 0.0f;
  if (c < C) {
#pragma unroll 8
    for (int b = threadIdx.y; b < nb; b += RED_ROWS) s += p[static_cast<size_t>(b) * C + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < RED_ROWS; ++r) t += red[r][threadIdx.x];
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

using BwdKernel = void (*)(const void*, const float*, const void*, void*, float*, long long, int,
                           float, bool);

// a register-path variant: its kernel, shared memory and rows a tile
struct BwdPlan {
  BwdKernel kernel;
  int smem;
  int tile_rows;
};

// (the dynamic shared memory above 48 KB is allowed on the current device)
template <typename T, int L, int NCHUNK>
cudaError_t bwd_plan(BwdPlan* plan) {
  using Sh = BwdShape<T, L, NCHUNK>;
  const BwdKernel kernel = ln_bwd_kernel<T, L, NCHUNK>;
  *plan = {kernel, Sh::SMEM, Sh::TILE_ROWS};
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
}

// the width class of a C-column row: L lanes a row and NCHUNK chunks of
// L * VEC columns a lane; 16 or 8 lanes (at most 3 chunks) where they pad the
// row less than 32 lanes do
template <int VEC>
void width_class(int C, int* L, int* nchunk) {
  *L = 32;
  *nchunk = chunks_for<VEC>(C);
  int pad = *nchunk * 32 * VEC - C;
  for (int l = 16; l >= 8; l /= 2) {
    const int n = (C + l * VEC - 1) / (l * VEC);
    if (n <= 3 && n * l * VEC - C < pad) {
      *L = l;
      *nchunk = n;
      pad = n * l * VEC - C;
    }
  }
}

template <typename T>
cudaError_t bwd_pick(int C, BwdPlan* plan) {
  int L = 0, n = 0;
  width_class<Elt<T>::VEC>(C, &L, &n);
  switch (L * 100 + n) {
    case 3201: return bwd_plan<T, 32, 1>(plan);
    case 3202: return bwd_plan<T, 32, 2>(plan);
    case 3203: return bwd_plan<T, 32, 3>(plan);
    case 3204: return bwd_plan<T, 32, 4>(plan);
    case 3205: return bwd_plan<T, 32, 5>(plan);
    case 3206: return bwd_plan<T, 32, 6>(plan);
    case 1601: return bwd_plan<T, 16, 1>(plan);
    case 1602: return bwd_plan<T, 16, 2>(plan);
    case 1603: return bwd_plan<T, 16, 3>(plan);
    case 801: return bwd_plan<T, 8, 1>(plan);
    case 802: return bwd_plan<T, 8, 2>(plan);
    case 803: return bwd_plan<T, 8, 3>(plan);
    default: break;
  }
  if constexpr (Elt<T>::VEC == 4) {  // f32 rows of 769-1536 columns
    switch (L * 100 + n) {
      case 3208: return bwd_plan<T, 32, 8>(plan);
      case 3210: return bwd_plan<T, 32, 10>(plan);
      case 3212: return bwd_plan<T, 32, 12>(plan);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// the register path's variant and grid: one block an SM, cut to the row tiles
template <typename T>
cudaError_t bwd_grid(long long R, int C, BwdPlan* plan, int* grid) {
  cudaError_t err = bwd_pick<T>(C, plan);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (R + plan->tile_rows - 1) / plan->tile_rows;
  *grid = static_cast<int>(sms < tiles ? sms : tiles);
  return cudaSuccess;
}

// partial rows (of each of dgamma and dbeta) a backward at (R >= 1, C) writes
template <typename T>
cudaError_t bwd_partials(long long R, int C, int* nb) {
  if (C > REG_MAX_C) {
    *nb = static_cast<int>(bwd_blocks(R));
    return cudaSuccess;
  }
  BwdPlan plan;
  return bwd_grid<T>(R, C, &plan, nb);
}

template <typename T>
cudaError_t ln_bwd(const void* x, const float* gamma, const void* dy, void* dx, float* part,
                   long long part_floats, float* out, long long R, int C, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = Elt<T>::VEC;
  int nb = 0;
  cudaError_t err = cudaSuccess;
  if (C > REG_MAX_C) {
    nb = static_cast<int>(bwd_blocks(R));
    if (part_floats < 2LL * nb * C) return cudaErrorInvalidValue;
    ln_bwd_stream_kernel<T><<<dim3(nb), LN_THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, static_cast<const T*>(dy), static_cast<T*>(dx), part,
        R, C, eps);
    err = cudaGetLastError();
  } else {
    BwdPlan plan;
    err = bwd_grid<T>(R, C, &plan, &nb);
    if (err != cudaSuccess) return err;
    if (part_floats < 2LL * nb * C) return cudaErrorInvalidValue;
    bool vec = C % VEC == 0 && aligned16(x) && aligned16(dy) && aligned16(dx);
    void* args[] = {&x, &gamma, &dy, &dx, &part, &R, &C, &eps, &vec};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(plan.kernel), dim3(nb),
                           dim3(BWD_THREADS), args, plan.smem, stream);
  }
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<dim3((C + RED_COLS - 1) / RED_COLS, 2), dim3(RED_COLS, RED_ROWS), 0,
                         stream>>>(part, out, nb, C);
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

// f32 workspace avj_ln_bwd needs at (dtype, R, C) on the current device:
// 2 x (partial rows) x C floats, one partial row pair a block; a negative
// value is minus a cudaError_t
long long avj_ln_bwd_workspace(int dtype, long long R, int C) {
  if (C <= 0 || R < 0) return -static_cast<long long>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  int nb = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype) {
    case 0: err = bwd_partials<float>(R, C, &nb); break;
    case 1: err = bwd_partials<__half>(R, C, &nb); break;
    case 2: err = bwd_partials<__nv_bfloat16>(R, C, &nb); break;
    default: break;
  }
  return err == cudaSuccess ? 2LL * nb * C : -static_cast<long long>(err);
}

// K6: dx, and dgamma | dbeta as out [2, C] f32; part is the workspace above,
// part_floats its size
int avj_ln_bwd(int dtype, const void* x, const float* gamma, const void* dy, void* dx,
               float* part, long long part_floats, float* out, long long R, int C, float eps,
               void* stream) {
  if (C <= 0 || R < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0) return cudaMemsetAsync(out, 0, 2 * static_cast<size_t>(C) * sizeof(float), s);
  switch (dtype) {
    case 0: return ln_bwd<float>(x, gamma, dy, dx, part, part_floats, out, R, C, eps, s);
    case 1: return ln_bwd<__half>(x, gamma, dy, dx, part, part_floats, out, R, C, eps, s);
    case 2:
      return ln_bwd<__nv_bfloat16>(x, gamma, dy, dx, part, part_floats, out, R, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
