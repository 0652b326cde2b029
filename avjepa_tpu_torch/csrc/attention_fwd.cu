// Forward attention kernels for Hopper (sm_90a), behind a plain C interface
// that avjepa_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces two Pallas TPU kernels of avjepa_tpu/ops/flash_attention.py:
//   avj_attn_fwd_packed <- _fwd_packed_kernel (K1). Attention read in place
//     off the fused qkv projection [B, N, 3C]: head h's q, k, v sit at columns
//     h*d, C + h*d and 2C + h*d. The scale is folded into q, which is rounded
//     back to the input type; the softmax has no max: p = exp(min(s, 80)).
//     Writes out [B, N, C] and lse = log(max(l, 1e-30)) [B, H, N].
//   avj_attn_fwd <- _fwd_kernel (K3). Classic [B, H, N, d] FlashAttention-2
//     forward: s = q.k^T * scale + bias, running max, key tiles whose keys
//     are all masked are skipped. Writes out and lse = m + log(max(l, 1e-30)).
// Both: p is rounded to the input type before the PV product, every
// accumulator is f32, out = acc / max(l, 1e-30). A masked key (bias -1e30)
// or a key past N gets p = 0 exactly, so a row with no valid key writes 0.
//
// What bounds it on the H100: at N = 1664 and d = 64 (ViT-L serving) each
// (batch, head) does 4*N^2*d = 0.71 GFLOP of QK^T and PV products against
// about 0.85 MB of q/k/v/o traffic, far above the ~295 flop/byte ridge, so
// the two products bound it at full tiles and they belong on tensor cores.
//
// Design. One block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 query rows. bf16/f16 inputs take the tensor-core kernel: the q
// tile is loaded once into registers; 64-key K/V tiles are copied into
// shared memory with cp.async; both products are mma.sync m16n8k16 (f32
// accumulate) fed by ldmatrix; scores, probabilities, softmax statistics and
// the output accumulator never leave registers (the FlashAttention-2
// layout: the score accumulator of two 8-key tiles is exactly the A operand
// of the PV product). head_dim is zero-padded to a multiple of 32 in shared
// memory and registers only (d = 24 runs as 32), never in device memory.
// f32 inputs (exact comparisons, not speed) take a simple kernel: shared
// memory tiles and FMA loops. Not yet used: wgmma, TMA, double-buffered K/V.

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  long long q_sb, q_sh, q_sn;  // element strides of batch, head, token
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  void* o;
  long long o_sb, o_sh, o_sn;
  float* lse;          // [B, H, N]
  const float* bias;   // [B, N] additive key bias (0 / -1e30), or null
  long long bias_sb;
  int B, H, N, d;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores, register-resident (FlashAttention-2 layout)
// ---------------------------------------------------------------------------

// CLAMPED = K1 numerics (scale folded into q, no-max clamped softmax);
// otherwise K3 numerics (scale on s, running max). DP = d padded to 32.
//
// Fragment layouts of mma.m16n8k16 (lane = 4*g + t): the f32 accumulator
// c[0..1] is row g, columns 2t and 2t+1; c[2..3] is row g + 8, same
// columns. So each thread holds two query rows (g and g + 8 of its warp's
// 16) and, per 8-key tile, two keys of each.
template <typename T, bool CLAMPED, int DP>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_mma_kernel(const Params prm) {
  constexpr int LD = DP + 8;      // shared row stride: ldmatrix without bank conflicts
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + BQ * LD;
  T* sv = sk + BK * LD;

  const int N = prm.N, d = prm.d;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lm = lane / 8, lr = lane % 8;  // ldmatrix: which 8x8 matrix, which row

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;

  // q tile -> shared (rows past N, columns past d zero) -> this warp's
  // fragments in registers
  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = q0 + r;
    const bool in = row < N && c < d;
    cp_async16(sq + r * LD + c, in ? qg + row * prm.q_sn + c : qg, in);
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kt = 0; kt < DP / 16; ++kt) {
    ldmatrix_x4(qf[kt], sq + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);
    if (CLAMPED) {  // (q * scale) in f32, rounded back to T, as on the TPU
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = Mma<T>::unpack(qf[kt][j]);
        qf[kt][j] = Mma<T>::pack(x.x * prm.scale, x.y * prm.scale);
      }
    }
  }

  float o[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_row[2] = {NEG_BIAS, NEG_BIAS};  // running max (K3)
  float l_row[2] = {0.0f, 0.0f};          // this thread's part of the row sums

  for (int k0 = 0; k0 < N; k0 += BK) {
    // a tile whose keys are all masked adds exactly nothing: skip it. The
    // barrier also keeps the previous tile's readers ahead of the copy below.
    const int valid = tid < BK && key_bias(bias_g, k0 + tid, N) > -1.0f;
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8, key = k0 + r;
      const bool in = key < N && c < d;
      cp_async16(sk + r * LD + c, in ? kg + key * prm.k_sn + c : kg, in);
      cp_async16(sv + r * LD + c, in ? vg + key * prm.v_sn + c : vg, in);
    }
    cp_async_wait_all();
    __syncthreads();

    // s = q . k^T: eight 8-key tiles; ldmatrix gives two tiles' B operands
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];  // keys np*16 + {0-7, 0-7, 8-15, 8-15}, dims kt*16 + {0-7, 8-15, ...}
        ldmatrix_x4(kb, sk + (np * 16 + lr + (lm / 2) * 8) * LD + kt * 16 + (lm % 2) * 8);
        Mma<T>::run(s[2 * np], qf[kt], kb[0], kb[1]);
        Mma<T>::run(s[2 * np + 1], qf[kt], kb[2], kb[3]);
      }
    }

    // bias, softmax statistics, p
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = key_bias(bias_g, k0 + nt * 8 + 2 * t + e, N);
        s[nt][e] = CLAMPED ? s[nt][e] + bv : s[nt][e] * prm.scale + bv;
        s[nt][2 + e] = CLAMPED ? s[nt][2 + e] + bv : s[nt][2 + e] * prm.scale + bv;
      }
    }
    if (!CLAMPED) {
      float mx[2] = {NEG_BIAS, NEG_BIAS};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_row[r], quad_max(mx[r]));
        const float corr = expf(m_row[r] - m_new);
        m_row[r] = m_new;
        l_row[r] *= corr;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
          o[dt][2 * r] *= corr;
          o[dt][2 * r + 1] *= corr;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[nt][j];
        s[nt][j] = CLAMPED ? expf(fminf(x, SOFTMAX_CLAMP)) : expf(x - m_row[j / 2]);
        l_row[j / 2] += s[nt][j];
      }
    }

    // o += p . v: the accumulators of 8-key tiles 2kt and 2kt+1, rounded to
    // T, are the A operand of 16 keys; ldmatrix.trans gives V's B operands
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kt][0], s[2 * kt][1]),
          Mma<T>::pack(s[2 * kt][2], s[2 * kt][3]),
          Mma<T>::pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          Mma<T>::pack(s[2 * kt + 1][2], s[2 * kt + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vb[4];  // keys kt*16 + {0-7, 8-15, 0-7, 8-15}, dims dp*16 + {0-7, 0-7, 8-15, 8-15}
        ldmatrix_x4_trans(vb, sv + (kt * 16 + lr + (lm % 2) * 8) * LD + dp * 16 + (lm / 2) * 8);
        Mma<T>::run(o[2 * dp], pa, vb[0], vb[1]);
        Mma<T>::run(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  T* og = static_cast<T*>(prm.o) + b * prm.o_sb + h * prm.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float l = fmaxf(quad_sum(l_row[r]), 1e-30f);
    if (row >= N) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<uint32_t*>(og + row * prm.o_sn + c) =
            Mma<T>::pack(o[dt][2 * r] / l, o[dt][2 * r + 1] / l);
      }
    }
    if (t == 0) {
      prm.lse[(static_cast<long long>(b) * prm.H + h) * N + row] =
          CLAMPED ? logf(l) : m_row[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiles and FMA loops, in full f32
// ---------------------------------------------------------------------------

constexpr int F32_LDS = BK + 4;  // scores

template <bool CLAMPED>
__global__ void __launch_bounds__(NTHREADS) attn_fwd_f32_kernel(const Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = prm.N, d = prm.d;
  const int ld = d + 1;
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + BQ * ld;
  float* sv = sk + BK * ld;
  float* ss = sv + BK * ld;          // [BQ][F32_LDS] scores, then p
  float* so = ss + BQ * F32_LDS;     // [BQ][ld] output accumulator
  float* sm = so + BQ * ld;          // [BQ] running max
  float* sl = sm + BQ;               // [BQ] row sums

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qg = static_cast<const float*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const float* kg = static_cast<const float*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const float* vg = static_cast<const float*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;

  for (int i = tid; i < BQ * d; i += NTHREADS) {
    const int r = i / d, c = i % d, row = q0 + r;
    const float x = row < N ? qg[row * prm.q_sn + c] : 0.0f;
    sq[r * ld + c] = CLAMPED ? x * prm.scale : x;
    so[r * ld + c] = 0.0f;
  }
  if (tid < BQ) {
    sm[tid] = NEG_BIAS;
    sl[tid] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    const int valid = tid < BK && key_bias(bias_g, k0 + tid, N) > -1.0f;
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < BK * d; i += NTHREADS) {
      const int r = i / d, c = i % d, key = k0 + r;
      sk[r * ld + c] = key < N ? kg[key * prm.k_sn + c] : 0.0f;
      sv[r * ld + c] = key < N ? vg[key * prm.v_sn + c] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) acc = fmaf(sq[r * ld + j], sk[c * ld + j], acc);
      const float bv = key_bias(bias_g, k0 + c, N);
      ss[r * F32_LDS + c] = CLAMPED ? acc + bv : acc * prm.scale + bv;
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += NWARPS) {  // one warp per row
      float x[BK / 32];
      float mx = NEG_BIAS;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        x[i] = ss[r * F32_LDS + lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
      float corr = 1.0f, m_new = 0.0f;
      if (!CLAMPED) {
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        m_new = fmaxf(sm[r], mx);
        corr = expf(sm[r] - m_new);
      }
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const float p = CLAMPED ? expf(fminf(x[i], SOFTMAX_CLAMP)) : expf(x[i] - m_new);
        ss[r * F32_LDS + lane + 32 * i] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int c = lane; c < d; c += 32) so[r * ld + c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sl[r] = sl[r] * corr + sum;
        if (!CLAMPED) sm[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * d; i += NTHREADS) {
      const int r = i / d, c = i % d;
      float acc = so[r * ld + c];
      for (int j = 0; j < BK; ++j) acc = fmaf(ss[r * F32_LDS + j], sv[j * ld + c], acc);
      so[r * ld + c] = acc;
    }
  }
  __syncthreads();

  float* og = static_cast<float*>(prm.o) + b * prm.o_sb + h * prm.o_sh;
  for (int i = tid; i < BQ * d; i += NTHREADS) {
    const int r = i / d, c = i % d, row = q0 + r;
    if (row < N) og[row * prm.o_sn + c] = so[r * ld + c] / fmaxf(sl[r], 1e-30f);
  }
  if (tid < BQ && q0 + tid < N) {
    const float logl = logf(fmaxf(sl[tid], 1e-30f));
    prm.lse[(static_cast<long long>(b) * prm.H + h) * N + q0 + tid] =
        CLAMPED ? logl : sm[tid] + logl;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

dim3 grid_of(const Params& p) { return dim3((p.N + BQ - 1) / BQ, p.H, p.B); }

template <typename T, bool CLAMPED, int DP>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (BQ + 2 * BK) * (DP + 8);
  return launch_kernel(attn_fwd_mma_kernel<T, CLAMPED, DP>, grid_of(p), smem, p, stream);
}

template <typename T, bool CLAMPED>
cudaError_t launch_16bit(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_mma<T, CLAMPED, 32>(p, stream);
  if (p.d <= 64) return launch_mma<T, CLAMPED, 64>(p, stream);
  if (p.d <= 96) return launch_mma<T, CLAMPED, 96>(p, stream);
  return launch_mma<T, CLAMPED, 128>(p, stream);
}

template <bool CLAMPED>
int dispatch(int dtype, const Params& p, void* stream) {
  if (p.d < 1 || p.d > MAX_D || p.N < 1 || p.B < 1 || p.H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int ld = p.d + 1;
    const size_t smem = sizeof(float) * ((BQ + 2 * BK) * ld + BQ * F32_LDS + BQ * ld + 2 * BQ);
    return static_cast<int>(launch_kernel(attn_fwd_f32_kernel<CLAMPED>, grid_of(p), smem, p, s));
  }
  // the 16-bit kernel copies 16-byte chunks: 8-element rows, aligned
  if (p.d % 8 || !aligned16(p.q, p.q_sb, p.q_sh, p.q_sn) ||
      !aligned16(p.k, p.k_sb, p.k_sh, p.k_sn) || !aligned16(p.v, p.v_sb, p.v_sh, p.v_sn)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (dtype == 1) return static_cast<int>(launch_16bit<__half, CLAMPED>(p, s));
  if (dtype == 2) return static_cast<int>(launch_16bit<__nv_bfloat16, CLAMPED>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = f16, 2 = bf16. Strides are in elements. Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
// bf16/f16 need d % 8 == 0, 16-byte aligned base pointers and strides that
// are multiples of 8 elements (else cudaErrorMisalignedAddress).

// K1. qkv [B, N, 3C] with unit stride along features; out [B, N, C]
// contiguous; lse [B, H, N] contiguous; bias [B, N] or null.
int avj_attn_fwd_packed(int dtype, const void* qkv, long long sb, long long sn,
                        void* out, float* lse, const float* bias, long long bias_sb,
                        int B, int N, int H, int d, float scale, void* stream) {
  const long long C = static_cast<long long>(H) * d;
  const char* base = static_cast<const char*>(qkv);
  Params p{};
  p.q = base;
  p.k = base + C * elem_size(dtype);
  p.v = base + 2 * C * elem_size(dtype);
  p.q_sb = p.k_sb = p.v_sb = sb;
  p.q_sh = p.k_sh = p.v_sh = d;
  p.q_sn = p.k_sn = p.v_sn = sn;
  p.o = out;
  p.o_sb = static_cast<long long>(N) * C;
  p.o_sh = d;
  p.o_sn = C;
  p.lse = lse;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.B = B; p.H = H; p.N = N; p.d = d;
  p.scale = scale;
  return dispatch<true>(dtype, p, stream);
}

// K3. q, k, v [B, H, N, d] with unit stride along d and the given strides;
// out [B, H, N, d] contiguous; lse [B, H, N] contiguous; bias [B, N] or null.
int avj_attn_fwd(int dtype,
                 const void* q, long long q_sb, long long q_sh, long long q_sn,
                 const void* k, long long k_sb, long long k_sh, long long k_sn,
                 const void* v, long long v_sb, long long v_sh, long long v_sn,
                 void* out, float* lse, const float* bias, long long bias_sb,
                 int B, int H, int N, int d, float scale, void* stream) {
  Params p{};
  p.q = q; p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k = k; p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v = v; p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o = out;
  p.o_sb = static_cast<long long>(H) * N * d;
  p.o_sh = static_cast<long long>(N) * d;
  p.o_sn = d;
  p.lse = lse;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.B = B; p.H = H; p.N = N; p.d = d;
  p.scale = scale;
  return dispatch<false>(dtype, p, stream);
}

const char* avj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
