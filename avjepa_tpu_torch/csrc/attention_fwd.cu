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
// the products bound it at full tiles and they belong on tensor cores. But
// a score costs 4*d = 256 tensor-core operations at d = 64 (128 at d = 24
// padded to 32): at the peak rate a 64x64 tile's products take ~256 SM
// clocks, and its 4096 exponentials take as long again on the SM's 16
// MUFU lanes, so the softmax work sets a second floor as high as the
// products', and every other scalar instruction per score adds to it.
//
// Design (one 16-bit kernel for K1 and K3, templated on the numerics; an
// earlier version ran the same tile list, ring and softmax on mma.sync):
// - Two warpgroups a block, 64 query rows each: 128 rows share every K/V
//   tile. S = Q.K^T is wgmma m64n64k16 with both operands in shared memory
//   (SS); O += P.V is wgmma m64nDPk16 with P from registers (the S
//   accumulator, exp2'ed and rounded to T, is exactly the A fragment) and V
//   read as an MN-major operand (the transpose flag). Tiles are stored as
//   wgmma reads them (TileLayout): 128-byte swizzled rows for d = 64 and
//   two 64-element column blocks for d = 128, 64-byte rows for d = 32.
// - A block first lists its 64-key tiles: a tile whose keys are all masked
//   or past N is left out (skipped, never read); a "full" tile (every key
//   below N with bias exactly 0) takes a path with no bias add. With no mask
//   every tile but a ragged last one is full.
// - K/V tiles (and a partial tile's 64 biases) stream through a 3-slot
//   cp.async ring (commit_group / wait_group), whose copies write the
//   swizzled addresses: tiles j+1 and j+2 are in flight while tile j is
//   computed; one barrier a tile.
// - Logits are in log2 units and p = ex2.approx (one MUFU op): K1 computes
//   min(s * log2e, 80 * log2e) (the same f32 value as min(s, 80) * log2e),
//   K3 folds scale * log2e and bias * log2e into one FFMA and keeps its
//   running max in log2 units. lse is written back in natural units; a K3
//   row that saw no valid key writes -1e30 + log(1e-30), the plain
//   version's value, exactly.
// - head_dim is zero-padded to 32, 64 or 128 in shared memory and registers
//   only (d = 24 runs as 32, d = 80 as 128), never in device memory.
// f32 inputs (exact comparisons, not speed) take a simple kernel: shared
// memory tiles and FMA loops, accurate expf.
//
// Each warpgroup runs S, waits, runs its softmax, runs PV, waits, and the
// two warpgroups of a block meet at every tile's barrier, so the tensor
// cores idle during a block's softmax unless the SM's other block fills
// them. Measured on an H100 (PERF.md): overlapping the softmax with
// the previous tile's PV in the same warpgroup, 1 or 4 warpgroups a block,
// or a shallower ring did not help. Not yet used: TMA and mbarriers, warp
// specialisation with a producer warp, warpgroup ping-pong, setmaxnreg,
// persistent blocks.

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = KEY_TILE;  // keys per tile, and the granularity of the skip rule

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
// bf16 / f16: wgmma, softmax in registers
// ---------------------------------------------------------------------------

constexpr int FWD_WARPS = 8;             // two warpgroups
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_BQ = FWD_WARPS * 16;  // query rows per block: 64 a warpgroup
constexpr int NSTAGE = 3;               // K/V tiles in the cp.async ring

// blocks a SM, which caps registers: 3 at DP = 32 (o is 16 registers a
// thread; on an H100 the third block takes the d = 24 calls from 0.58 to
// 0.51 ms), 2 at DP = 64 (3 would spill), 1 at DP = 128
constexpr int fwd_blocks_per_sm(int dp) { return dp <= 32 ? 3 : dp <= 64 ? 2 : 1; }

// CLAMPED = K1 numerics (scale folded into q, no-max clamped softmax);
// otherwise K3 numerics (scale on s, running max). DP = d padded to 32, 64
// or 128. Two warpgroups a block, each 64 query rows (warp w of the block
// owns rows 16w..16w+15). Logits are kept in log2 units: x = s * log2(e)
// (K1) or s * scale * log2(e) (K3), plus bias * log2(e), and p = ex2(...).
//
// The wgmma accumulators are laid out as mma.sync m16n8 tiles (wgmma.cuh):
// s[4j..4j+3] and o[4j..4j+3] are 8-column tile j, entries 0-1 row g of
// the warp's 16 (columns 2t, 2t+1), entries 2-3 row g + 8. So each thread
// holds two query rows and, per 8-key tile, two keys of each; and the
// scores of 8-key tiles 2kt and 2kt+1, rounded to T, are exactly the
// register A operand of the PV product over keys 16kt..16kt+15.
template <typename T, bool CLAMPED, int DP>
__global__ void __launch_bounds__(FWD_THREADS, fwd_blocks_per_sm(DP))
attn_fwd_wgmma_kernel(const Params prm) {
  using L = TileLayout<DP>;
  constexpr int CHUNKS = DP / 8;                 // 16-byte chunks per row
  constexpr int Q_BYTES = FWD_BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;          // one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = smem;
  unsigned char* ring = sq + Q_BYTES;  // [NSTAGE][K | V]
  float* sbias = reinterpret_cast<float*>(ring + NSTAGE * 2 * KV_BYTES);  // [NSTAGE][BK]
  int* list = reinterpret_cast<int*>(sbias + NSTAGE * BK);

  const int N = prm.N, d = prm.d;
  const int q0 = blockIdx.x * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;

  // q tile -> shared (rows past N, columns past d zero): copy group 0
  for (int i = tid; i < FWD_BQ * CHUNKS; i += FWD_THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS, row = q0 + r;
    const bool in = row < N && 8 * c < d;
    cp_async16(sq + L::offset(r, c, FWD_BQ), in ? qg + row * prm.q_sn + 8 * c : qg, in);
  }
  cp_async_commit();
  const int ntiles = list_key_tiles<FWD_THREADS>(bias_g, N, list);

  // copy group of one listed key tile into ring slot i % NSTAGE (empty past
  // the list, so that every thread commits the same number of groups); a
  // partial tile's bias comes along, zero past N
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      const int e = list[i], k0 = (e >> 1) * BK, slot = i % NSTAGE;
      unsigned char* sk = ring + slot * 2 * KV_BYTES;
      unsigned char* sv = sk + KV_BYTES;
      for (int j = tid; j < BK * CHUNKS; j += FWD_THREADS) {
        const int r = j / CHUNKS, c = j % CHUNKS, key = k0 + r;
        const bool in = key < N && 8 * c < d;
        const int off = L::offset(r, c, BK);
        cp_async16(sk + off, in ? kg + key * prm.k_sn + 8 * c : kg, in);
        cp_async16(sv + off, in ? vg + key * prm.v_sn + 8 * c : vg, in);
      }
      if (bias_g && !(e & 1) && tid < BK) {
        const bool in = k0 + tid < N;
        cp_async4(sbias + slot * BK + tid, in ? bias_g + k0 + tid : bias_g, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) load_tile(i);

  cp_async_wait<NSTAGE - 1>();  // the q tile
  if (CLAMPED) {
    // (q * scale) in f32, rounded back to T, as on the TPU: in place, each
    // thread on the chunks it copied (zero chunks stay zero)
    for (int i = tid; i < FWD_BQ * CHUNKS; i += FWD_THREADS) {
      const int off = L::offset(i / CHUNKS, i % CHUNKS, FWD_BQ);
      scale_frag<T>(*reinterpret_cast<uint32_t(*)[4]>(sq + off), prm.scale);
    }
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t sq_addr = smem_addr(sq), ring_addr = smem_addr(ring);
  const int q_row = 64 * (warp / 4);  // this warpgroup's first row of the q tile
  float s[BK / 2];
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m_row[2] = {NEG_BIAS, NEG_BIAS};  // running max in log2 units (K3)
  float l_row[2] = {0.0f, 0.0f};          // this thread's part of the row sums
  // x = s * xs (+ bias * log2e): K1's s already carries the scale
  const float xs = CLAMPED ? LOG2E : prm.scale * LOG2E;
  constexpr float CLAMP2 = SOFTMAX_CLAMP * LOG2E;

  for (int i = 0; i < ntiles; ++i) {
    // tile i has landed for every thread and is visible to wgmma, and every
    // warpgroup is done with tile i - 1, whose slot the copy below refills
    cp_async_wait<NSTAGE - 2>();
    fence_proxy_async();
    __syncthreads();
    load_tile(i + NSTAGE - 1);
    const int e = list[i], k0 = (e >> 1) * BK, slot = i % NSTAGE;
    const uint32_t sk_addr = ring_addr + slot * 2 * KV_BYTES, sv_addr = sk_addr + KV_BYTES;

    // s = q . k^T over 64 keys, both operands in shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      WgmmaSS<T>::n64(s, L::k_major(sq_addr, FWD_BQ, q_row, kk),
                      L::k_major(sk_addr, BK, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // logits in log2 units; a partial tile adds its bias (keys past N get
    // the masked bias, so p = 0 exactly)
    if (e & 1) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] *= xs;
    } else {
      const float* sb = sbias + slot * BK;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = nt * 8 + 2 * t + c;
          const float bl = (k0 + col < N ? (bias_g ? sb[col] : 0.0f) : NEG_BIAS) * LOG2E;
          s[4 * nt + c] = fmaf(s[4 * nt + c], xs, bl);
          s[4 * nt + 2 + c] = fmaf(s[4 * nt + 2 + c], xs, bl);
        }
      }
    }
    if (!CLAMPED) {
      float mx[2] = {NEG_BIAS, NEG_BIAS};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_row[r], quad_max(mx[r]));
        const float corr = ex2(m_row[r] - m_new);
        m_row[r] = m_new;
        l_row[r] *= corr;
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
          o[4 * dt + 2 * r] *= corr;
          o[4 * dt + 2 * r + 1] *= corr;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float x = s[j];
      s[j] = CLAMPED ? ex2(fminf(x, CLAMP2)) : ex2(x - m_row[(j / 2) % 2]);
      l_row[(j / 2) % 2] += s[j];
    }

    // o += p . v: p rounded to T, from registers; V from shared memory
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      pa[kt][0] = Mma<T>::pack(s[8 * kt], s[8 * kt + 1]);
      pa[kt][1] = Mma<T>::pack(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = Mma<T>::pack(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = Mma<T>::pack(s[8 * kt + 6], s[8 * kt + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) WgmmaRS<T, DP>::run(o, pa[kt], L::mn_major(sv_addr, kt));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }
  cp_async_wait_all();  // no copy may still target shared memory at exit

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
            Mma<T>::pack(o[4 * dt + 2 * r] / l, o[4 * dt + 2 * r + 1] / l);
      }
    }
    if (t == 0) {
      // natural units; a K3 row that saw no valid key keeps the sentinel
      // max and writes -1e30 + log(1e-30), as the plain version does
      const float lse = CLAMPED ? logf(l)
                        : m_row[r] == NEG_BIAS ? NEG_BIAS + logf(l)
                                               : (m_row[r] + log2f(l)) * LN2;
      prm.lse[(static_cast<long long>(b) * prm.H + h) * N + row] = lse;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: shared-memory tiles and FMA loops, in full f32
// ---------------------------------------------------------------------------

constexpr int BQ = 64;           // query rows per block
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

dim3 grid_of(const Params& p, int bq) { return dim3((p.N + bq - 1) / bq, p.H, p.B); }

template <typename T, bool CLAMPED, int DP>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  const int ntiles = (p.N + BK - 1) / BK;
  // + 1024: the kernel aligns its tiles to 1024 bytes (the swizzle's period)
  const size_t smem = 2 * (FWD_BQ + NSTAGE * 2 * BK) * DP + sizeof(float) * NSTAGE * BK +
                      sizeof(int) * ntiles + 1024;
  return launch_kernel(attn_fwd_wgmma_kernel<T, CLAMPED, DP>, grid_of(p, FWD_BQ), smem, p,
                       stream, FWD_THREADS);
}

template <typename T, bool CLAMPED>
cudaError_t launch_16bit(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_wgmma<T, CLAMPED, 32>(p, stream);
  if (p.d <= 64) return launch_wgmma<T, CLAMPED, 64>(p, stream);
  return launch_wgmma<T, CLAMPED, 128>(p, stream);
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
    return static_cast<int>(
        launch_kernel(attn_fwd_f32_kernel<CLAMPED>, grid_of(p, BQ), smem, p, s));
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
