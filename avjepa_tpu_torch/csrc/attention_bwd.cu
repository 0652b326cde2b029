// Backward attention kernels for Hopper (sm_90a), behind a plain C interface
// that avjepa_tpu_torch/ops/flash_attention.py binds with ctypes.
//
// Replaces two Pallas TPU kernels of avjepa_tpu/ops/flash_attention.py:
//   avj_attn_bwd_packed <- _bwd_packed_kernel (K2), the backward of K1. Reads
//     q, k, v in place off the fused qkv [B, N, 3C] and writes dq | dk | dv
//     straight into one [B, N, 3C] gradient. Rounding points of the contract:
//     qs = T(f32(q) * scale), ks = T(f32(k) * scale), s = qs.k^T + bias,
//     p = exp(min(s, 80) - lse), dv += T(p)^T.dO, dp = dO.v^T,
//     ds = (s < 80) ? p * (dp - delta) : 0 (a clamped logit is flat in the
//     forward, so its gradient is exactly 0), dk += T(ds)^T.qs, dq = T(ds).ks.
//   avj_attn_bwd <- _bwd_kernel (K4), the backward of K3 over [B, H, N, d]:
//     s = q.k^T * scale + bias, p = exp(s - lse), ds = p * (dp - delta) *
//     scale, dk = T(ds)^T.q, dq = T(ds).k, dv = T(p)^T.dO. Key tiles whose
//     keys are all masked are skipped, as on the TPU.
// Both: delta = rowsum(dO * O) per head in f32 comes in from outside the
// kernel ([B, H, N]); lse is the forward's [B, H, N]; every accumulator is
// f32, cast once to T at the end. A masked key (bias -1e30) or a key past N
// gets p = 0 exactly, so its dk and dv are 0; a query row past N gets
// lse = +1e30, so it adds nothing. An all-masked key tile is skipped in both
// kernels (its keys' p is 0, so this changes no bit), which also gives 0 for
// a batch row with no valid key at all.
//
// What bounds it on the H100: five N x N x d products per (batch, head) --
// 10*N^2*d flops, 1.8 GFLOP at N = 1664, d = 64 -- against ~1.3 MB of
// q/k/v/o/dO/dq/dk/dv traffic; far above the ~295 flop/byte ridge, so the
// tensor cores bound it, and here the two-pass design does 7 products, not 5.
//
// Design: two passes, deterministic. The TPU grid runs in order, so its
// kernel carries dq in VMEM scratch across key blocks; Hopper blocks run in
// parallel in no order, so a cross-block sum needs atomics or a second pass.
// This port takes the second pass (no f32 dq buffer, no atomics, the same
// bits on every run), at the price of recomputing s and dp:
//   pass 1 (dk, dv): one block of 4 warps per (64-key tile, head, batch);
//     each warp owns 16 keys and loops over every query tile, computing
//     s^T = k.q^T and dp^T = v.dO^T with keys as the MMA rows, so p^T and
//     ds^T stay in registers and are exactly the A operand of
//     dv += p^T.dO and dk += ds^T.q (FlashAttention-2 layout);
//   pass 2 (dq): one block per (64-query tile, head, batch); each warp owns
//     16 queries and loops over the key tiles: s = q.k^T, dp = dO.v^T,
//     ds in registers, dq += ds.k.
// Products are mma.sync m16n8k16 (f32 accumulate) fed by ldmatrix from
// shared-memory tiles that cp.async fills; d is zero-padded to a multiple of
// 32 in shared memory and registers only (d = 24 runs as 32), and only the d
// real columns are written. At d > 64 pass 1 takes 32-query tiles so that
// dk, dv, s and dp (160 f32 registers a thread) do not spill. f32 inputs
// (exact comparisons, not speed) take simple FMA kernels over 32 x 32
// shared-memory tiles. Not yet used: wgmma, TMA, double buffering.

#include "attention_common.cuh"

namespace {

constexpr int BT = 64;   // rows (keys in pass 1, queries in pass 2) per block
constexpr int KT = 64;   // key tile of pass 2
constexpr int FT = 32;   // f32 kernels: tile of keys and of queries
constexpr float PAD_LSE = 1e30f;  // lse of a query row past N: p = 0

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long q_sb, q_sh, q_sn;  // element strides of batch, head, token
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;  // of dout
  void* dq;
  void* dk;
  void* dv;
  long long dq_sb, dq_sh, dq_sn;
  long long dk_sb, dk_sh, dk_sn;
  long long dv_sb, dv_sh, dv_sn;
  const float* lse;    // [B, H, N]
  const float* delta;  // [B, H, N]
  const float* bias;   // [B, N] additive key bias (0 / -1e30), or null
  long long bias_sb;
  int B, H, N, d;
  float scale;
};

// p and ds of one score from s (the raw product, before scale and bias) and
// dp; CLAMPED = K2 numerics (scale already in q), else K4's
template <bool CLAMPED>
__device__ __forceinline__ void p_ds(float& s, float& dp, float bias, float lse,
                                     float delta, float scale) {
  float p, ds;
  if (CLAMPED) {
    const float x = s + bias;
    p = expf(fminf(x, SOFTMAX_CLAMP) - lse);
    ds = x < SOFTMAX_CLAMP ? p * (dp - delta) : 0.0f;
  } else {
    p = expf(s * scale + bias - lse);
    ds = p * (dp - delta) * scale;
  }
  s = p;
  dp = ds;
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
// ---------------------------------------------------------------------------

// Copy a [rows, DP] tile (rows from `row0`, zero past N and past d) into
// shared memory with row stride LD.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long sn, int row0,
                                          int N, int d, int tid) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, row = row0 + r;
    const bool in = row < N && c < d;
    cp_async16(dst + r * LD + c, in ? src + row * sn + c : src, in);
  }
}

// pass 1: dk, dv of one 64-key tile
template <typename T, bool CLAMPED, int DP, int QT>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_kernel(const Params prm) {
  constexpr int LD = DP + 8;  // shared row stride: ldmatrix without bank conflicts
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + BT * LD;
  T* sq = sv + BT * LD;
  T* so = sq + QT * LD;  // dO
  float* slse = reinterpret_cast<float*>(so + QT * LD);
  float* sdelta = slse + QT;

  const int N = prm.N, d = prm.d;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lm = lane / 8, lr = lane % 8;  // ldmatrix: which 8x8 matrix, which row

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }

  // a tile whose keys are all masked gets dk = dv = 0 and no work
  const int valid = tid < BT && key_bias(bias_g, k0 + tid, N) > -1.0f;
  if (__syncthreads_or(valid)) {
    load_tile<T, DP, BT>(sk, kg, prm.k_sn, k0, N, d, tid);
    load_tile<T, DP, BT>(sv, vg, prm.v_sn, k0, N, d, tid);
    const float kbias[2] = {key_bias(bias_g, k0 + warp * 16 + g, N),
                            key_bias(bias_g, k0 + warp * 16 + g + 8, N)};
    const T* skw = sk + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // A: this warp's keys
    const T* svw = sv + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

    for (int q0 = 0; q0 < N; q0 += QT) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DP, QT>(sq, qg, prm.q_sn, q0, N, d, tid);
      load_tile<T, DP, QT>(so, og, prm.o_sn, q0, N, d, tid);
      if (tid < QT) {
        const int row = q0 + tid;
        slse[tid] = row < N ? prm.lse[bh * N + row] : PAD_LSE;
        sdelta[tid] = row < N ? prm.delta[bh * N + row] : 0.0f;
      }
      cp_async_wait_all();
      __syncthreads();

      // s^T = k.q^T and dp^T = v.dO^T: this warp's 16 keys x QT queries
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int i = 0; i < QT / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.0f;
      }
#pragma unroll
      for (int kt = 0; kt < DP / 16; ++kt) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, skw + kt * 16);
        ldmatrix_x4(va, svw + kt * 16);
#pragma unroll
        for (int np = 0; np < QT / 16; ++np) {
          // queries np*16 + {0-7, 0-7, 8-15, 8-15}, dims kt*16 + {0-7, 8-15, ...}
          const int off = (np * 16 + lr + (lm / 2) * 8) * LD + kt * 16 + (lm % 2) * 8;
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, sq + off);
          if (CLAMPED) scale_frag<T>(qb, prm.scale);
          ldmatrix_x4(ob, so + off);
          Mma<T>::run(st[2 * np], ka, qb[0], qb[1]);
          Mma<T>::run(st[2 * np + 1], ka, qb[2], qb[3]);
          Mma<T>::run(dpt[2 * np], va, ob[0], ob[1]);
          Mma<T>::run(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // p^T and ds^T in place: element j of tile nt is key row g + 8*(j/2),
      // query nt*8 + 2t + j%2
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = nt * 8 + 2 * t + (j & 1);
          p_ds<CLAMPED>(st[nt][j], dpt[nt][j], kbias[j >> 1], slse[col], sdelta[col],
                        prm.scale);
        }
      }
      // dv += p^T.dO and dk += ds^T.q(s): the accumulators of query tiles 2kt
      // and 2kt+1, rounded to T, are the A operand; ldmatrix.trans gives the
      // B operands of dO and q
#pragma unroll
      for (int kt = 0; kt < QT / 16; ++kt) {
        const uint32_t pa[4] = {
            Mma<T>::pack(st[2 * kt][0], st[2 * kt][1]),
            Mma<T>::pack(st[2 * kt][2], st[2 * kt][3]),
            Mma<T>::pack(st[2 * kt + 1][0], st[2 * kt + 1][1]),
            Mma<T>::pack(st[2 * kt + 1][2], st[2 * kt + 1][3]),
        };
        const uint32_t sa[4] = {
            Mma<T>::pack(dpt[2 * kt][0], dpt[2 * kt][1]),
            Mma<T>::pack(dpt[2 * kt][2], dpt[2 * kt][3]),
            Mma<T>::pack(dpt[2 * kt + 1][0], dpt[2 * kt + 1][1]),
            Mma<T>::pack(dpt[2 * kt + 1][2], dpt[2 * kt + 1][3]),
        };
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          // queries kt*16 + {0-7, 8-15, 0-7, 8-15}, dims dp*16 + {0-7, 0-7, 8-15, 8-15}
          const int off = (kt * 16 + lr + (lm % 2) * 8) * LD + dp * 16 + (lm / 2) * 8;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, so + off);
          ldmatrix_x4_trans(qb, sq + off);
          if (CLAMPED) scale_frag<T>(qb, prm.scale);
          Mma<T>::run(dv[2 * dp], pa, ob[0], ob[1]);
          Mma<T>::run(dv[2 * dp + 1], pa, ob[2], ob[3]);
          Mma<T>::run(dk[2 * dp], sa, qb[0], qb[1]);
          Mma<T>::run(dk[2 * dp + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(prm.dk) + b * prm.dk_sb + h * prm.dk_sh;
  T* dvg = static_cast<T*>(prm.dv) + b * prm.dv_sb + h * prm.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= N) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<uint32_t*>(dkg + key * prm.dk_sn + c) =
            Mma<T>::pack(dk[dt][2 * r], dk[dt][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + key * prm.dv_sn + c) =
            Mma<T>::pack(dv[dt][2 * r], dv[dt][2 * r + 1]);
      }
    }
  }
}

// pass 2: dq of one 64-query tile
template <typename T, bool CLAMPED, int DP>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_kernel(const Params prm) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* so = sq + BT * LD;  // dO
  T* sk = so + BT * LD;
  T* sv = sk + KT * LD;

  const int N = prm.N, d = prm.d;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int lm = lane / 8, lr = lane % 8;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  load_tile<T, DP, BT>(sq, qg, prm.q_sn, q0, N, d, tid);
  load_tile<T, DP, BT>(so, og, prm.o_sn, q0, N, d, tid);
  cp_async_wait_all();  // visible to all after the first barrier below
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse[r] = row < N ? prm.lse[bh * N + row] : PAD_LSE;
    delta[r] = row < N ? prm.delta[bh * N + row] : 0.0f;
  }
  const T* sqw = sq + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // A: this warp's queries
  const T* sow = so + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  float dq[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += KT) {
    // skip an all-masked key tile; the barrier also keeps the previous
    // tile's readers ahead of the copy below
    const int valid = tid < KT && key_bias(bias_g, k0 + tid, N) > -1.0f;
    if (!__syncthreads_or(valid)) continue;
    load_tile<T, DP, KT>(sk, kg, prm.k_sn, k0, N, d, tid);
    load_tile<T, DP, KT>(sv, vg, prm.v_sn, k0, N, d, tid);
    cp_async_wait_all();
    __syncthreads();

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, sqw + kt * 16);
      if (CLAMPED) scale_frag<T>(qa, prm.scale);
      ldmatrix_x4(oa, sow + kt * 16);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        const int off = (np * 16 + lr + (lm / 2) * 8) * LD + kt * 16 + (lm % 2) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, sk + off);
        ldmatrix_x4(vb, sv + off);
        Mma<T>::run(s[2 * np], qa, kb[0], kb[1]);
        Mma<T>::run(s[2 * np + 1], qa, kb[2], kb[3]);
        Mma<T>::run(dp[2 * np], oa, vb[0], vb[1]);
        Mma<T>::run(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // element j of tile nt: query row g + 8*(j/2), key k0 + nt*8 + 2t + j%2
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = key_bias(bias_g, k0 + nt * 8 + 2 * t + (j & 1), N);
        p_ds<CLAMPED>(s[nt][j], dp[nt][j], bv, lse[j >> 1], delta[j >> 1], prm.scale);
      }
    }
    // dq += ds.k(s)
#pragma unroll
    for (int kt = 0; kt < KT / 16; ++kt) {
      const uint32_t sa[4] = {
          Mma<T>::pack(dp[2 * kt][0], dp[2 * kt][1]),
          Mma<T>::pack(dp[2 * kt][2], dp[2 * kt][3]),
          Mma<T>::pack(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
          Mma<T>::pack(dp[2 * kt + 1][2], dp[2 * kt + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < DP / 16; ++dt) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, sk + (kt * 16 + lr + (lm % 2) * 8) * LD + dt * 16 + (lm / 2) * 8);
        if (CLAMPED) scale_frag<T>(kb, prm.scale);
        Mma<T>::run(dq[2 * dt], sa, kb[0], kb[1]);
        Mma<T>::run(dq[2 * dt + 1], sa, kb[2], kb[3]);
      }
    }
  }

  T* dqg = static_cast<T*>(prm.dq) + b * prm.dq_sb + h * prm.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<uint32_t*>(dqg + row * prm.dq_sn + c) =
            Mma<T>::pack(dq[dt][2 * r], dq[dt][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiles and FMA loops, in full f32
// ---------------------------------------------------------------------------

constexpr int FLD = FT + 1;  // row stride of the [FT, FT] score tiles

// pass 1: dk, dv of one 32-key tile
template <bool CLAMPED>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_f32_kernel(const Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = prm.N, d = prm.d, ld = d + 1;
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + FT * ld;
  float* sq = sv + FT * ld;   // q, scaled for K2
  float* so = sq + FT * ld;   // dO
  float* sdk = so + FT * ld;
  float* sdv = sdk + FT * ld;
  float* sp = sdv + FT * ld;  // [key][query] p, then
  float* sds = sp + FT * FLD; // [key][query] ds
  float* slse = sds + FT * FLD;
  float* sdelta = slse + FT;
  float* sbias = sdelta + FT;

  const int k0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const float* qg = static_cast<const float*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const float* kg = static_cast<const float*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const float* vg = static_cast<const float*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const float* og = static_cast<const float*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  for (int i = tid; i < FT * d; i += NTHREADS) {
    const int r = i / d, c = i % d, key = k0 + r;
    sk[r * ld + c] = key < N ? kg[key * prm.k_sn + c] : 0.0f;
    sv[r * ld + c] = key < N ? vg[key * prm.v_sn + c] : 0.0f;
    sdk[r * ld + c] = 0.0f;
    sdv[r * ld + c] = 0.0f;
  }
  if (tid < FT) sbias[tid] = key_bias(bias_g, k0 + tid, N);
  const int valid = tid < FT && key_bias(bias_g, k0 + tid, N) > -1.0f;
  if (__syncthreads_or(valid)) {
    for (int q0 = 0; q0 < N; q0 += FT) {
      for (int i = tid; i < FT * d; i += NTHREADS) {
        const int r = i / d, c = i % d, row = q0 + r;
        const float x = row < N ? qg[row * prm.q_sn + c] : 0.0f;
        sq[r * ld + c] = CLAMPED ? x * prm.scale : x;
        so[r * ld + c] = row < N ? og[row * prm.o_sn + c] : 0.0f;
      }
      if (tid < FT) {
        const int row = q0 + tid;
        slse[tid] = row < N ? prm.lse[bh * N + row] : PAD_LSE;
        sdelta[tid] = row < N ? prm.delta[bh * N + row] : 0.0f;
      }
      __syncthreads();
      for (int i = tid; i < FT * FT; i += NTHREADS) {
        const int r = i / FT, c = i % FT;  // key, query
        float s = 0.0f, dp = 0.0f;
        for (int j = 0; j < d; ++j) {
          s = fmaf(sk[r * ld + j], sq[c * ld + j], s);
          dp = fmaf(sv[r * ld + j], so[c * ld + j], dp);
        }
        p_ds<CLAMPED>(s, dp, sbias[r], slse[c], sdelta[c], prm.scale);
        sp[r * FLD + c] = s;
        sds[r * FLD + c] = dp;
      }
      __syncthreads();
      for (int i = tid; i < FT * d; i += NTHREADS) {
        const int r = i / d, c = i % d;
        float a = sdv[r * ld + c], e = sdk[r * ld + c];
        for (int j = 0; j < FT; ++j) {
          a = fmaf(sp[r * FLD + j], so[j * ld + c], a);
          e = fmaf(sds[r * FLD + j], sq[j * ld + c], e);
        }
        sdv[r * ld + c] = a;
        sdk[r * ld + c] = e;
      }
      __syncthreads();
    }
  }
  float* dkg = static_cast<float*>(prm.dk) + b * prm.dk_sb + h * prm.dk_sh;
  float* dvg = static_cast<float*>(prm.dv) + b * prm.dv_sb + h * prm.dv_sh;
  for (int i = tid; i < FT * d; i += NTHREADS) {
    const int r = i / d, c = i % d, key = k0 + r;
    if (key < N) {
      dkg[key * prm.dk_sn + c] = sdk[r * ld + c];
      dvg[key * prm.dv_sn + c] = sdv[r * ld + c];
    }
  }
}

// pass 2: dq of one 32-query tile
template <bool CLAMPED>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_f32_kernel(const Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = prm.N, d = prm.d, ld = d + 1;
  float* sq = reinterpret_cast<float*>(smem);  // q, scaled for K2
  float* so = sq + FT * ld;
  float* sk = so + FT * ld;
  float* sv = sk + FT * ld;
  float* sdq = sv + FT * ld;
  float* sds = sdq + FT * ld;  // [query][key]
  float* slse = sds + FT * FLD;
  float* sdelta = slse + FT;
  float* sbias = sdelta + FT;

  const int q0 = blockIdx.x * FT, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const float* qg = static_cast<const float*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const float* kg = static_cast<const float*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const float* vg = static_cast<const float*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const float* og = static_cast<const float*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;
  const float kscale = CLAMPED ? prm.scale : 1.0f;  // dq = ds.(scale k) for K2

  for (int i = tid; i < FT * d; i += NTHREADS) {
    const int r = i / d, c = i % d, row = q0 + r;
    const float x = row < N ? qg[row * prm.q_sn + c] : 0.0f;
    sq[r * ld + c] = CLAMPED ? x * prm.scale : x;
    so[r * ld + c] = row < N ? og[row * prm.o_sn + c] : 0.0f;
    sdq[r * ld + c] = 0.0f;
  }
  if (tid < FT) {
    const int row = q0 + tid;
    slse[tid] = row < N ? prm.lse[bh * N + row] : PAD_LSE;
    sdelta[tid] = row < N ? prm.delta[bh * N + row] : 0.0f;
  }
  for (int k0 = 0; k0 < N; k0 += FT) {
    const int valid = tid < FT && key_bias(bias_g, k0 + tid, N) > -1.0f;
    if (!__syncthreads_or(valid)) continue;
    for (int i = tid; i < FT * d; i += NTHREADS) {
      const int r = i / d, c = i % d, key = k0 + r;
      sk[r * ld + c] = key < N ? kg[key * prm.k_sn + c] : 0.0f;
      sv[r * ld + c] = key < N ? vg[key * prm.v_sn + c] : 0.0f;
    }
    if (tid < FT) sbias[tid] = key_bias(bias_g, k0 + tid, N);
    __syncthreads();
    for (int i = tid; i < FT * FT; i += NTHREADS) {
      const int r = i / FT, c = i % FT;  // query, key
      float s = 0.0f, dp = 0.0f;
      for (int j = 0; j < d; ++j) {
        s = fmaf(sq[r * ld + j], sk[c * ld + j], s);
        dp = fmaf(so[r * ld + j], sv[c * ld + j], dp);
      }
      p_ds<CLAMPED>(s, dp, sbias[c], slse[r], sdelta[r], prm.scale);
      sds[r * FLD + c] = dp;
    }
    __syncthreads();
    for (int i = tid; i < FT * d; i += NTHREADS) {
      const int r = i / d, c = i % d;
      float a = sdq[r * ld + c];
      for (int j = 0; j < FT; ++j) a = fmaf(sds[r * FLD + j], sk[j * ld + c] * kscale, a);
      sdq[r * ld + c] = a;
    }
  }
  __syncthreads();
  float* dqg = static_cast<float*>(prm.dq) + b * prm.dq_sb + h * prm.dq_sh;
  for (int i = tid; i < FT * d; i += NTHREADS) {
    const int r = i / d, c = i % d, row = q0 + r;
    if (row < N) dqg[row * prm.dq_sn + c] = sdq[r * ld + c];
  }
}

// ---------------------------------------------------------------------------
// launch: pass 1 then pass 2, on one stream
// ---------------------------------------------------------------------------

dim3 grid_of(const Params& p, int rows) { return dim3((p.N + rows - 1) / rows, p.H, p.B); }

template <typename T, bool CLAMPED, int DP>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int QT = DP > 64 ? 32 : 64;
  const size_t smem1 = sizeof(T) * (2 * BT + 2 * QT) * (DP + 8) + sizeof(float) * 2 * QT;
  cudaError_t err = launch_kernel(attn_bwd_dkdv_kernel<T, CLAMPED, DP, QT>, grid_of(p, BT),
                                  smem1, p, stream);
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(T) * (2 * BT + 2 * KT) * (DP + 8);
  return launch_kernel(attn_bwd_dq_kernel<T, CLAMPED, DP>, grid_of(p, BT), smem2, p, stream);
}

template <typename T, bool CLAMPED>
cudaError_t launch_16bit(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_mma<T, CLAMPED, 32>(p, stream);
  if (p.d <= 64) return launch_mma<T, CLAMPED, 64>(p, stream);
  if (p.d <= 96) return launch_mma<T, CLAMPED, 96>(p, stream);
  return launch_mma<T, CLAMPED, 128>(p, stream);
}

template <bool CLAMPED>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int ld = p.d + 1;
  const size_t smem1 = sizeof(float) * (6 * FT * ld + 2 * FT * FLD + 3 * FT);
  cudaError_t err = launch_kernel(attn_bwd_dkdv_f32_kernel<CLAMPED>, grid_of(p, FT), smem1, p,
                                  stream);
  if (err != cudaSuccess) return err;
  const size_t smem2 = sizeof(float) * (5 * FT * ld + FT * FLD + 3 * FT);
  return launch_kernel(attn_bwd_dq_f32_kernel<CLAMPED>, grid_of(p, FT), smem2, p, stream);
}

template <bool CLAMPED>
int dispatch(int dtype, const Params& p, void* stream) {
  if (p.d < 1 || p.d > MAX_D || p.N < 1 || p.B < 1 || p.H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_f32<CLAMPED>(p, s));
  // the 16-bit kernels copy 16-byte chunks and store 2-element pairs
  if (p.d % 8 || !aligned16(p.q, p.q_sb, p.q_sh, p.q_sn) ||
      !aligned16(p.k, p.k_sb, p.k_sh, p.k_sn) || !aligned16(p.v, p.v_sb, p.v_sh, p.v_sn) ||
      !aligned16(p.dout, p.o_sb, p.o_sh, p.o_sn) ||
      !aligned16(p.dq, p.dq_sb, p.dq_sh, p.dq_sn) || !aligned16(p.dk, p.dk_sb, p.dk_sh, p.dk_sn) ||
      !aligned16(p.dv, p.dv_sb, p.dv_sh, p.dv_sn)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (dtype == 1) return static_cast<int>(launch_16bit<__half, CLAMPED>(p, s));
  if (dtype == 2) return static_cast<int>(launch_16bit<__nv_bfloat16, CLAMPED>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = f16, 2 = bf16. Strides are in elements. Returns a
// cudaError_t (0 on success); both passes are asynchronous on `stream`.
// lse and delta are [B, H, N] f32 contiguous; bias is [B, N] or null.

// K2. qkv [B, N, 3C] with unit stride along features; dout [B, N, C] with
// unit stride along features; dqkv [B, N, 3C] contiguous, written whole
// (rows < N).
int avj_attn_bwd_packed(int dtype, const void* qkv, long long sb, long long sn,
                        const void* dout, long long o_sb, long long o_sn,
                        const float* lse, const float* delta,
                        const float* bias, long long bias_sb, void* dqkv,
                        int B, int N, int H, int d, float scale, void* stream) {
  const long long C = static_cast<long long>(H) * d;
  const size_t es = elem_size(dtype);
  const char* base = static_cast<const char*>(qkv);
  char* dbase = static_cast<char*>(dqkv);
  Params p{};
  p.q = base;
  p.k = base + C * es;
  p.v = base + 2 * C * es;
  p.q_sb = p.k_sb = p.v_sb = sb;
  p.q_sh = p.k_sh = p.v_sh = d;
  p.q_sn = p.k_sn = p.v_sn = sn;
  p.dout = dout;
  p.o_sb = o_sb;
  p.o_sh = d;
  p.o_sn = o_sn;
  p.dq = dbase;
  p.dk = dbase + C * es;
  p.dv = dbase + 2 * C * es;
  p.dq_sb = p.dk_sb = p.dv_sb = static_cast<long long>(N) * 3 * C;
  p.dq_sh = p.dk_sh = p.dv_sh = d;
  p.dq_sn = p.dk_sn = p.dv_sn = 3 * C;
  p.lse = lse;
  p.delta = delta;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.B = B; p.H = H; p.N = N; p.d = d;
  p.scale = scale;
  return dispatch<true>(dtype, p, stream);
}

// K4. q, k, v [B, H, N, d] with unit stride along d and the given strides;
// dout, dq, dk, dv [B, H, N, d] contiguous.
int avj_attn_bwd(int dtype,
                 const void* q, long long q_sb, long long q_sh, long long q_sn,
                 const void* k, long long k_sb, long long k_sh, long long k_sn,
                 const void* v, long long v_sb, long long v_sh, long long v_sn,
                 const void* dout, const float* lse, const float* delta,
                 const float* bias, long long bias_sb, void* dq, void* dk, void* dv,
                 int B, int H, int N, int d, float scale, void* stream) {
  const long long sb = static_cast<long long>(H) * N * d, sh = static_cast<long long>(N) * d;
  Params p{};
  p.q = q; p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k = k; p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v = v; p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.dout = dout; p.o_sb = sb; p.o_sh = sh; p.o_sn = d;
  p.dq = dq; p.dq_sb = sb; p.dq_sh = sh; p.dq_sn = d;
  p.dk = dk; p.dk_sb = sb; p.dk_sh = sh; p.dk_sn = d;
  p.dv = dv; p.dv_sb = sb; p.dv_sh = sh; p.dv_sn = d;
  p.lse = lse;
  p.delta = delta;
  p.bias = bias;
  p.bias_sb = bias_sb;
  p.B = B; p.H = H; p.N = N; p.d = d;
  p.scale = scale;
  return dispatch<false>(dtype, p, stream);
}

}  // extern "C"
