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
// two passes ([B, H, N]; avj_attn_delta below computes it, called by the
// wrappers first); lse is the forward's [B, H, N]; every accumulator is
// f32, cast once to T at the end. A masked key (bias -1e30) or a key past N
// gets p = 0 exactly, so its dk and dv are 0; a query row past N gets
// lse = +1e30, so it adds nothing. An all-masked key tile is skipped in both
// kernels (its keys' p is 0, so this changes no bit), which also gives 0 for
// a batch row with no valid key at all.
//
// What bounds it on the H100: per (batch, head) the two passes below do
// seven N x N x d products (14*N^2*d flops with d padded as stated) and two
// exponentials a score of every key tile they do not skip. At d = 64 the
// products dominate: 10*N^2*d flops of the contract against ~1.3 MB of
// q/k/v/o/dO/dq/dk/dv traffic, far above the ~295 flop/byte ridge. At
// d = 24 (the ViT-L predictor) a score costs ~450 tensor-core flops in all,
// and the exponentials (16 a clock on an SM's MUFU units) and the ~10 f32
// instructions around each of them a pass take longer than the products:
// that, not the number of passes, is the floor there. Measured (PERF.md),
// the kernels run well above both floors, waiting on the chain product ->
// exponentials -> product more than issuing.
//
// Design: two passes, deterministic. The TPU grid runs in order, so its
// kernel carries dq in VMEM scratch across key blocks; Hopper blocks run in
// parallel in no order, so a cross-block sum needs atomics or a second pass.
// This port takes the second pass (no f32 dq buffer, no atomics, the same
// bits on every run), at the price of recomputing s and dp. A single pass
// with f32 atomics into dq would save two of the seven products and half
// the exponentials, and give up bit-identical runs: kept out.
//   pass 1 (dk, dv): a block owns 128 keys (64 on the mma.sync path) and
//     walks every query tile: s^T = k.qs^T and dp^T = v.dO^T with keys as
//     the MMA rows, so p^T and ds^T stay in registers and are exactly the A
//     operand of dv += p^T.dO and dk += ds^T.qs (FlashAttention-2 layout).
//     A block whose keys are all masked does no work; a "full" block (every
//     key below N with bias exactly 0) runs its whole loop with no bias add.
//   pass 2 (dq): a block owns 128 queries (64 on the mma.sync path) and
//     first lists its 64-key tiles (list_key_tiles): all-masked tiles are
//     left out, full tiles add no bias, a partial tile's 64 biases are
//     staged in shared memory with its K/V copy. s = qs.k^T, dp = dO.v^T,
//     ds in registers, dq += ds.ks.
// Streamed tiles (pass 1: q, dO, lse and delta; pass 2: K, V and a partial
// tile's bias) go through a 3-slot cp.async ring (commit_group/wait_group;
// 2 slots where 3 would leave one block a SM): tiles j+1 and j+2 are in
// flight while tile j is computed, one barrier a tile. The threads that
// copied a tile finish it when it lands: qs = T(q * scale) in place (pass
// 1), a ks = T(k * scale) copy (pass 2), lse into log2 units. Every score
// takes one MUFU ex2 in log2 units (p_ds2).
// Products, d <= 64 (d zero-padded to 32 or 64 in shared memory and
// registers only, so d = 24 runs every product at 32): wgmma, two
// warpgroups of 64 rows a block. S^T, dP^T, S and dP are SS (both operands
// K-major in swizzled tiles, as the forward's Q.K^T); dV, dK and dQ take p^T,
// ds^T or ds from registers and dO, qs or ks as an MN-major B operand (as
// the forward's P.V). A 64-wide tile runs as two 32-wide parts where the
// registers freed let more blocks fit a SM (pass 1 at d = 64, pass 2 at
// d <= 32). d > 64 (d padded to a multiple of 16): mma.sync m16n8k16 fed by
// ldmatrix, 4 warps of 16 rows a block, 32-query tiles in pass 1. Only the
// d real columns are written. f32 inputs (exact comparisons, not speed)
// take simple FMA kernels over 32 x 32 shared-memory tiles with the
// accurate expf. Not yet used: TMA and mbarriers, warp specialisation,
// overlap of one tile's products with another's exponentials, wgmma at
// d > 64.

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

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
// dp, in full f32 with the accurate expf: the f32 kernels' arithmetic;
// CLAMPED = K2 numerics (scale already in q), else K4's
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

// The same in log2 units, for the 16-bit kernels, with the score's query
// row given as nl = -lse * log2(e) (-1e30 past N: p = 0) and, for K2, c2 =
// 80 * log2(e) + nl; p = 2^x in one MUFU op. K2: x = min(s * log2e + nl,
// c2), the clamp min(s, 80) - lse in log2 units, and the clamp test on s in
// natural units (s * log2e could round across 80 * log2e where s does
// not); K4: x = s * (scale * log2e) + nl in one FFMA. A FULL tile adds no
// bias; otherwise `bias` is the key's, natural units for K2 and times
// log2(e) for K4 (-1e30 for a masked key or one past N: p = 0 exactly).
template <bool CLAMPED, bool FULL>
__device__ __forceinline__ void p_ds2(float& s, float& dp, float bias, float nl, float c2,
                                      float delta, float scale) {
  if (CLAMPED) {
    const float x = FULL ? s : s + bias;
    const float p = ex2(fminf(fmaf(x, LOG2E, nl), c2));
    dp = x < SOFTMAX_CLAMP ? p * (dp - delta) : 0.0f;
    s = p;
  } else {
    const float xs = scale * LOG2E;
    const float p = FULL ? ex2(fmaf(s, xs, nl)) : ex2(fmaf(s, xs, bias) + nl);
    dp = p * (dp - delta) * scale;
    s = p;
  }
}

// nl and c2 of p_ds2 from a query row's lse (natural units), PAD past N
__device__ __forceinline__ float2 row_stats(float lse, bool in) {
  const float nl = in ? -(lse * LOG2E) : -PAD_LSE;
  return make_float2(nl, SOFTMAX_CLAMP * LOG2E + nl);
}

// Tile geometry of the mma.sync kernels (d > 64): DK = d zero-padded to a
// multiple of 16 (the k16 step of S and dP; also the n of dK, dV and dQ),
// 4 warps of 16 rows each. Shared tiles are [rows][DK] with a row stride of
// DK + 8 elements (ldmatrix reads 8 rows without bank conflicts).
template <int DK>
struct Geo {
  static constexpr int LD = DK + 8;
  static constexpr int CHUNKS = DK / 8;  // 16-byte chunks a row
  static constexpr int ROWS = NWARPS * 16;  // keys (pass 1) or queries (pass 2) a block
};

// cp.async a [ROWS][DK] tile (rows from `row0`; zero past N and past d)
// into shared memory; each thread copies chunks tid, tid + NTHREADS, ...
template <typename T, int DK, int ROWS>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long sn, int row0,
                                          int N, int d) {
  using G = Geo<DK>;
  for (int i = threadIdx.x; i < ROWS * G::CHUNKS; i += NTHREADS) {
    const int r = i / G::CHUNKS, c = (i % G::CHUNKS) * 8, row = row0 + r;
    const bool in = row < N && c < d;
    cp_async16(dst + r * G::LD + c, in ? src + row * sn + c : src, in);
  }
}

// dst = T(f32(src) * scale) over the chunks this thread copied with
// copy_tile (so it needs only its own copies to have landed); dst may be src
template <typename T, int DK, int ROWS>
__device__ __forceinline__ void scale_tile(T* dst, const T* src, float scale) {
  using G = Geo<DK>;
  for (int i = threadIdx.x; i < ROWS * G::CHUNKS; i += NTHREADS) {
    const int off = (i / G::CHUNKS) * G::LD + (i % G::CHUNKS) * 8;
    uint32_t v[4];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + off);
    scale_frag<T>(v, scale);
    *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<uint4*>(v);
  }
}

// acc[DK/8][4] += a (16 x 16 from registers) . B, B = 16 rows of `b` (row
// stride LD, from row `r0`) x DK columns, read with ldmatrix.trans: the
// product of dV, dK and dQ
template <typename T, int DK>
__device__ __forceinline__ void mma_rows(float (&acc)[DK / 8][4], const uint32_t (&a)[4],
                                         const T* b, int r0) {
  constexpr int LD = DK + 8;
  const int lane = threadIdx.x % 32, lm = lane / 8, lr = lane % 8;
  // rows r0 + {0-7, 8-15, 0-7, 8-15}, columns 16c + {0-7, 0-7, 8-15, 8-15}
  const T* p = b + (r0 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;
#pragma unroll
  for (int c = 0; c < DK / 16; ++c) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, p + c * 16);
    Mma<T>::run(acc[2 * c], a, f[0], f[1]);
    Mma<T>::run(acc[2 * c + 1], a, f[2], f[3]);
  }
}

// the score accumulators of 8-column tiles 2kt and 2kt+1, rounded to T:
// the A operand of a product over those 16 columns
template <typename T, int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[NT][4], int kt) {
  a[0] = Mma<T>::pack(x[2 * kt][0], x[2 * kt][1]);
  a[1] = Mma<T>::pack(x[2 * kt][2], x[2 * kt][3]);
  a[2] = Mma<T>::pack(x[2 * kt + 1][0], x[2 * kt + 1][1]);
  a[3] = Mma<T>::pack(x[2 * kt + 1][2], x[2 * kt + 1][3]);
}

// x[NT][4] (+)= A . B^T over DK: A = this warp's 16 rows of `a`, B = NT * 8
// rows of `b` (both [rows][DK], row stride LD): S and dP (and their
// transposes) in m16n8k16 steps
template <typename T, int DK, int NT>
__device__ __forceinline__ void mma_scores(float (&x)[NT][4], float (&y)[NT][4], const T* a1,
                                           const T* b1, const T* a2, const T* b2) {
  constexpr int LD = DK + 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.0f;
  }
  const int aoff = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
#pragma unroll
  for (int kt = 0; kt < DK / 16; ++kt) {
    uint32_t fa1[4], fa2[4];
    ldmatrix_x4(fa1, a1 + aoff + kt * 16);
    ldmatrix_x4(fa2, a2 + aoff + kt * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // rows np*16 + {0-7, 0-7, 8-15, 8-15}, columns kt*16 + {0-7, 8-15, ...}
      const int off = (np * 16 + lr + (lm / 2) * 8) * LD + kt * 16 + (lm % 2) * 8;
      uint32_t fb1[4], fb2[4];
      ldmatrix_x4(fb1, b1 + off);
      ldmatrix_x4(fb2, b2 + off);
      Mma<T>::run(x[2 * np], fa1, fb1[0], fb1[1]);
      Mma<T>::run(x[2 * np + 1], fa1, fb1[2], fb1[3]);
      Mma<T>::run(y[2 * np], fa2, fb2[0], fb2[1]);
      Mma<T>::run(y[2 * np + 1], fa2, fb2[2], fb2[3]);
    }
  }
}

// p_ds2 over a warp's score tiles of pass 1 (s^T, dp^T: element j of tile
// nt is key row g + 8*(j/2), query nt*8 + 2t + j%2): the bias by key row
// from registers, {nl, c2, delta} by query from shared memory
template <bool CLAMPED, bool FULL, int NT>
__device__ __forceinline__ void grads_by_key(float (&s)[NT][4], float (&dp)[NT][4],
                                             const float (&kbias)[2], const float4* sstat,
                                             float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float4 q = sstat[nt * 8 + 2 * t + c];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        p_ds2<CLAMPED, FULL>(s[nt][2 * r + c], dp[nt][2 * r + c], kbias[r], q.x, q.y, q.z,
                             scale);
      }
    }
  }
}

// the same for pass 2 (s, dp: element j of tile nt is query row g +
// 8*(j/2), key nt*8 + 2t + j%2): {nl, c2} and delta by query row from
// registers, the bias by key from shared memory (read only if !FULL)
template <bool CLAMPED, bool FULL, int NT>
__device__ __forceinline__ void grads_by_query(float (&s)[NT][4], float (&dp)[NT][4],
                                               const float* sb, const float2 (&stat)[2],
                                               const float (&delta)[2], float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = FULL ? 0.0f : sb[nt * 8 + 2 * t + (j & 1)];
      p_ds2<CLAMPED, FULL>(s[nt][j], dp[nt][j], bv, stat[j >> 1].x, stat[j >> 1].y,
                           delta[j >> 1], scale);
    }
  }
}

constexpr int NSTAGE = 3;  // tiles in a cp.async ring: two in flight, one read

// pass 1 on mma.sync: dk, dv of 64 keys, over 32-query tiles (dK, dV, S^T
// and dP^T of 64 keys at d > 64 hold ~2 * DK + 32 f32 registers a thread)
template <typename T, bool CLAMPED, int DK>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv_kernel(const Params prm) {
  using G = Geo<DK>;
  constexpr int LD = G::LD, ROWS = G::ROWS, QT = 32;
  constexpr int SLOT = 2 * QT * LD;  // a ring slot: q | dO
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + ROWS * LD;
  T* ring = sv + ROWS * LD;
  // [NSTAGE][lse | delta as copied, then {nl, c2, delta, 0} by query]
  float* sstat = reinterpret_cast<float*>(ring + NSTAGE * SLOT);

  const int N = prm.N, d = prm.d;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  float dk[DK / 8][4], dv[DK / 8][4];
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }

  // a block whose keys are all masked gets dk = dv = 0 and no work; a
  // "full" block (every key below N with bias 0) adds no bias
  const float kb = tid < ROWS ? key_bias(bias_g, k0 + tid, N) : 0.0f;
  const bool any = __syncthreads_or(tid < ROWS && kb > -1.0f);
  const bool full = !__syncthreads_or(kb != 0.0f);
  if (any) {
    copy_tile<T, DK, ROWS>(sk, kg, prm.k_sn, k0, N, d);
    copy_tile<T, DK, ROWS>(sv, vg, prm.v_sn, k0, N, d);
    cp_async_commit();
    const int nq = (N + QT - 1) / QT;
    // copy group of query tile i into slot i % NSTAGE (empty past the last
    // tile, so that every thread commits the same number of groups)
    auto load_q = [&](int i) {
      if (i < nq) {
        T* sq = ring + (i % NSTAGE) * SLOT;
        float* st = sstat + (i % NSTAGE) * 6 * QT;
        copy_tile<T, DK, QT>(sq, qg, prm.q_sn, i * QT, N, d);
        copy_tile<T, DK, QT>(sq + QT * LD, og, prm.o_sn, i * QT, N, d);
        if (tid < QT) {
          const int row = i * QT + tid;
          const bool in = row < N;
          cp_async4(st + tid, in ? prm.lse + bh * N + row : prm.lse, in);
          cp_async4(st + QT + tid, in ? prm.delta + bh * N + row : prm.delta, in);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) load_q(i);
    // this thread's two keys' bias (natural units for K2, times log2e for K4)
    float kbias[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float bv = key_bias(bias_g, k0 + warp * 16 + g + 8 * r, N);
      kbias[r] = CLAMPED ? bv : bv * LOG2E;
    }

    for (int i = 0; i < nq; ++i) {
      // tile i has landed for this thread; q is scaled (K2) and lse turned
      // into log2 units by the threads that copied them; after the barrier,
      // tile i is visible to all, and every warp is done with tile i - 1,
      // whose slot the copy below refills
      cp_async_wait<NSTAGE - 2>();
      T* sq = ring + (i % NSTAGE) * SLOT;
      T* so = sq + QT * LD;
      float* st = sstat + (i % NSTAGE) * 6 * QT;
      float4* qstat = reinterpret_cast<float4*>(st + 2 * QT);
      if (CLAMPED) scale_tile<T, DK, QT>(sq, sq, prm.scale);
      if (tid < QT) {
        const float2 r = row_stats(st[tid], i * QT + tid < N);
        qstat[tid] = make_float4(r.x, r.y, st[QT + tid], 0.0f);
      }
      __syncthreads();
      load_q(i + NSTAGE - 1);

      // s^T = k.qs^T and dp^T = v.dO^T: this warp's 16 keys x QT queries
      float sc[QT / 8][4], dpt[QT / 8][4];
      mma_scores<T, DK, QT / 8>(sc, dpt, sk, sq, sv, so);
      // p^T and ds^T in place
      if (full) {
        grads_by_key<CLAMPED, true>(sc, dpt, kbias, qstat, prm.scale);
      } else {
        grads_by_key<CLAMPED, false>(sc, dpt, kbias, qstat, prm.scale);
      }
      // dv += p^T.dO and dk += ds^T.qs (K4: ds^T.q) over the QT queries
#pragma unroll
      for (int kt = 0; kt < QT / 16; ++kt) {
        uint32_t pa[4], sa[4];
        pack_a<T>(pa, sc, kt);
        pack_a<T>(sa, dpt, kt);
        mma_rows<T, DK>(dv, pa, so, kt * 16);
        mma_rows<T, DK>(dk, sa, sq, kt * 16);
      }
    }
    cp_async_wait_all();  // no copy may still target shared memory at exit
  }

  T* dkg = static_cast<T*>(prm.dk) + b * prm.dk_sb + h * prm.dk_sh;
  T* dvg = static_cast<T*>(prm.dv) + b * prm.dv_sb + h * prm.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= N) continue;
#pragma unroll
    for (int dt = 0; dt < DK / 8; ++dt) {
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

// ring slots of pass 2: 3, or 2 where 3 would leave room for only one
// block a SM (a slot holds K, V and, for K2, ks: KEY_TILE rows each)
template <bool CLAMPED, int DK>
__host__ __device__ constexpr int dq_stages() {
  constexpr int tiles = CLAMPED ? 3 : 2;
  constexpr int bytes = 2 * (2 * Geo<DK>::ROWS + NSTAGE * tiles * KEY_TILE) * (DK + 8);
  return 2 * bytes <= 200 * 1024 ? NSTAGE : 2;
}

// pass 2 on mma.sync: dq of 64 queries, over the block's listed key tiles
template <typename T, bool CLAMPED, int DK>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq_kernel(const Params prm) {
  using G = Geo<DK>;
  constexpr int LD = G::LD, ROWS = G::ROWS, KT = KEY_TILE;
  constexpr int STAGES = dq_stages<CLAMPED, DK>();
  constexpr int TILES = CLAMPED ? 3 : 2;  // K, V and (K2) ks = T(k * scale)
  constexpr int SLOT = TILES * KT * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* so = sq + ROWS * LD;  // dO
  T* ring = so + ROWS * LD;
  float* sbias = reinterpret_cast<float*>(ring + STAGES * SLOT);  // [STAGES][KT]
  int* list = reinterpret_cast<int*>(sbias + STAGES * KT);

  const int N = prm.N, d = prm.d;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  copy_tile<T, DK, ROWS>(sq, qg, prm.q_sn, q0, N, d);
  copy_tile<T, DK, ROWS>(so, og, prm.o_sn, q0, N, d);
  cp_async_commit();
  const int ntiles = list_key_tiles<NTHREADS>(bias_g, N, list);

  // copy group of listed key tile i into slot i % STAGES (empty past the
  // list); a partial tile's bias comes along
  auto load_kv = [&](int i) {
    if (i < ntiles) {
      const int e = list[i], k0 = (e >> 1) * KT, slot = i % STAGES;
      T* sk = ring + slot * SLOT;
      copy_tile<T, DK, KT>(sk, kg, prm.k_sn, k0, N, d);
      copy_tile<T, DK, KT>(sk + KT * LD, vg, prm.v_sn, k0, N, d);
      if (bias_g && !(e & 1) && tid < KT) {
        const bool in = k0 + tid < N;
        cp_async4(sbias + slot * KT + tid, in ? bias_g + k0 + tid : bias_g, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_kv(i);

  float2 stat[2];
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    stat[r] = row_stats(row < N ? prm.lse[bh * N + row] : 0.0f, row < N);
    delta[r] = row < N ? prm.delta[bh * N + row] : 0.0f;
  }
  cp_async_wait<STAGES - 1>();  // the q and dO tiles (this thread's copies)
  if (CLAMPED) scale_tile<T, DK, ROWS>(sq, sq, prm.scale);  // qs, once

  float dq[DK / 8][4];
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    // tile i has landed for this thread; it makes its part of ks (K2) and
    // of a partial tile's bias; the barrier shows all of it to every warp
    // and frees slot i - 1 for the copy below
    cp_async_wait<STAGES - 2>();
    const int e = list[i], k0 = (e >> 1) * KT, slot = i % STAGES;
    T* sk = ring + slot * SLOT;
    T* sv = sk + KT * LD;
    float* sb = sbias + slot * KT;
    if (CLAMPED) scale_tile<T, DK, KT>(sk + 2 * KT * LD, sk, prm.scale);
    if (!(e & 1) && tid < KT) {
      // keys past N, or all keys without a bias array: set here, not copied
      const float bv = k0 + tid >= N ? NEG_BIAS : bias_g ? sb[tid] : 0.0f;
      sb[tid] = CLAMPED ? bv : bv * LOG2E;
    }
    __syncthreads();
    load_kv(i + STAGES - 1);

    // s = qs.k^T and dp = dO.v^T: this warp's 16 queries x 64 keys
    float s[KT / 8][4], dp[KT / 8][4];
    mma_scores<T, DK, KT / 8>(s, dp, sq, sk, so, sv);
    if (e & 1) {
      grads_by_query<CLAMPED, true>(s, dp, sb, stat, delta, prm.scale);
    } else {
      grads_by_query<CLAMPED, false>(s, dp, sb, stat, delta, prm.scale);
    }
    // dq += ds.ks (K4: ds.k)
    const T* kb = CLAMPED ? sk + 2 * KT * LD : sk;
#pragma unroll
    for (int kt = 0; kt < KT / 16; ++kt) {
      uint32_t sa[4];
      pack_a<T>(sa, dp, kt);
      mma_rows<T, DK>(dq, sa, kb, kt * 16);
    }
  }
  cp_async_wait_all();

  T* dqg = static_cast<T*>(prm.dq) + b * prm.dq_sb + h * prm.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int dt = 0; dt < DK / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) {
        *reinterpret_cast<uint32_t*>(dqg + row * prm.dq_sn + c) =
            Mma<T>::pack(dq[dt][2 * r], dq[dt][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 at d <= 64: wgmma
// ---------------------------------------------------------------------------

// cp.async a [ROWS][DP] tile (rows from `row0`; zero past N and past d)
// into shared memory laid out as wgmma reads it (TileLayout); each thread
// copies chunks tid, tid + THREADS, ...
template <typename T, int DP, int THREADS, int ROWS>
__device__ __forceinline__ void copy_wg_tile(unsigned char* dst, const T* src, long long sn,
                                             int row0, int N, int d) {
  constexpr int CHUNKS = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS, row = row0 + r;
    const bool in = row < N && 8 * c < d;
    cp_async16(dst + TileLayout<DP>::offset(r, c, ROWS), in ? src + row * sn + 8 * c : src, in);
  }
}

// dst = T(f32(src) * scale) over the chunks this thread copied with
// copy_wg_tile; dst may be src
template <typename T, int DP, int THREADS, int ROWS>
__device__ __forceinline__ void scale_wg_tile(unsigned char* dst, const unsigned char* src,
                                              float scale) {
  constexpr int CHUNKS = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int off = TileLayout<DP>::offset(i / CHUNKS, i % CHUNKS, ROWS);
    uint32_t v[4];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src + off);
    scale_frag<T>(v, scale);
    *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<uint4*>(v);
  }
}

constexpr int WG_THREADS = 256;  // two warpgroups, 64 rows each
constexpr int WG_ROWS = 128;

// d (+)= A . B^T over N rows of B (wgmma m64nNk16, both operands K-major)
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) {
    WgmmaSS<T>::n64(d, da, db, accumulate);
  } else {
    WgmmaSS<T>::n32(d, da, db, accumulate);
  }
}

// pass 1 on wgmma: dk, dv of 128 keys (64 a warpgroup) over 64-query tiles.
// S^T = K.Qs^T and dP^T = V.dO^T are SS m64n64k16 (both operands K-major,
// as the forward's Q.K^T); dV += P^T.dO and dK += dS^T.Qs take P^T and dS^T
// from registers and dO, Qs as MN-major B operands (as the forward's P.V).
template <typename T, bool CLAMPED, int DP>
__global__ void __launch_bounds__(WG_THREADS, 2) attn_bwd_dkdv_wgmma_kernel(const Params prm) {
  using L = TileLayout<DP>;
  // queries a part of the tile (see the loop): 32 at d=64, where dK and dV
  // take 64 registers, so that two blocks fit a SM
  constexpr int SUB = DP <= 32 ? 64 : 32;
  constexpr int QT = 64, KV_BYTES = WG_ROWS * DP * 2, Q_BYTES = QT * DP * 2;
  constexpr int SLOT = 2 * Q_BYTES;  // q | dO
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sk = smem;
  unsigned char* sv = sk + KV_BYTES;
  unsigned char* ring = sv + KV_BYTES;  // [NSTAGE][SLOT], 1024-byte aligned slots
  // [NSTAGE][lse | delta as copied, then {nl, c2, delta, 0} by query]
  float* sstat = reinterpret_cast<float*>(ring + NSTAGE * SLOT);

  const int N = prm.N, d = prm.d;
  const int k0 = blockIdx.x * WG_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;

  const float kb = tid < WG_ROWS ? key_bias(bias_g, k0 + tid, N) : 0.0f;
  const bool any = __syncthreads_or(tid < WG_ROWS && kb > -1.0f);
  const bool full = !__syncthreads_or(kb != 0.0f);
  if (any) {
    copy_wg_tile<T, DP, WG_THREADS, WG_ROWS>(sk, kg, prm.k_sn, k0, N, d);
    copy_wg_tile<T, DP, WG_THREADS, WG_ROWS>(sv, vg, prm.v_sn, k0, N, d);
    cp_async_commit();
    const int nq = (N + QT - 1) / QT;
    auto load_q = [&](int i) {
      if (i < nq) {
        unsigned char* sq = ring + (i % NSTAGE) * SLOT;
        float* st = sstat + (i % NSTAGE) * 6 * QT;
        copy_wg_tile<T, DP, WG_THREADS, QT>(sq, qg, prm.q_sn, i * QT, N, d);
        copy_wg_tile<T, DP, WG_THREADS, QT>(sq + Q_BYTES, og, prm.o_sn, i * QT, N, d);
        if (tid < QT) {
          const int row = i * QT + tid;
          const bool in = row < N;
          cp_async4(st + tid, in ? prm.lse + bh * N + row : prm.lse, in);
          cp_async4(st + QT + tid, in ? prm.delta + bh * N + row : prm.delta, in);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) load_q(i);
    float kbias[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float bv = key_bias(bias_g, k0 + warp * 16 + g + 8 * r, N);
      kbias[r] = CLAMPED ? bv : bv * LOG2E;
    }
    const uint32_t sk_addr = smem_addr(sk), sv_addr = smem_addr(sv);
    const int key_row = 64 * (warp / 4);  // this warpgroup's first key of the block

    for (int i = 0; i < nq; ++i) {
      cp_async_wait<NSTAGE - 2>();
      unsigned char* sq = ring + (i % NSTAGE) * SLOT;
      float* st = sstat + (i % NSTAGE) * 6 * QT;
      float4* qstat = reinterpret_cast<float4*>(st + 2 * QT);
      if (CLAMPED) scale_wg_tile<T, DP, WG_THREADS, QT>(sq, sq, prm.scale);
      if (tid < QT) {
        const float2 r = row_stats(st[tid], i * QT + tid < N);
        qstat[tid] = make_float4(r.x, r.y, st[QT + tid], 0.0f);
      }
      fence_proxy_async();
      __syncthreads();
      load_q(i + NSTAGE - 1);
      const uint32_t sq_addr = smem_addr(sq), so_addr = sq_addr + Q_BYTES;

      // the tile's queries in SUB-column parts (fewer live registers): for
      // each, s^T = k.qs^T and dp^T = v.dO^T over this warpgroup's 64 keys,
      // p^T and ds^T, then dv += p^T.dO and dk += ds^T.qs (K4: ds^T.q) with
      // p^T and ds^T from registers
#pragma unroll 1
      for (int part = 0; part < QT / SUB; ++part) {
        float sc[SUB / 8][4], dpt[SUB / 8][4];
        float(&sc_flat)[SUB / 2] = reinterpret_cast<float(&)[SUB / 2]>(sc);
        float(&dp_flat)[SUB / 2] = reinterpret_cast<float(&)[SUB / 2]>(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<T, SUB>(sc_flat, L::k_major(sk_addr, WG_ROWS, key_row, kk),
                           L::k_major(sq_addr, QT, SUB * part, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wgmma_ss<T, SUB>(dp_flat, L::k_major(sv_addr, WG_ROWS, key_row, kk),
                           L::k_major(so_addr, QT, SUB * part, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc_flat);
        fence_regs(dp_flat);
        if (full) {
          grads_by_key<CLAMPED, true>(sc, dpt, kbias, qstat + SUB * part, prm.scale);
        } else {
          grads_by_key<CLAMPED, false>(sc, dpt, kbias, qstat + SUB * part, prm.scale);
        }
        uint32_t pa[SUB / 16][4], sa[SUB / 16][4];
#pragma unroll
        for (int kt = 0; kt < SUB / 16; ++kt) {
          pack_a<T>(pa[kt], sc, kt);
          pack_a<T>(sa[kt], dpt, kt);
        }
        wgmma_fence();
#pragma unroll
        for (int kt = 0; kt < SUB / 16; ++kt) {
          WgmmaRS<T, DP>::run(dv, pa[kt], L::mn_major(so_addr, SUB / 16 * part + kt));
        }
#pragma unroll
        for (int kt = 0; kt < SUB / 16; ++kt) {
          WgmmaRS<T, DP>::run(dk, sa[kt], L::mn_major(sq_addr, SUB / 16 * part + kt));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(sa);
      }
    }
    cp_async_wait_all();
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
            Mma<T>::pack(dk[4 * dt + 2 * r], dk[4 * dt + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + key * prm.dv_sn + c) =
            Mma<T>::pack(dv[4 * dt + 2 * r], dv[4 * dt + 2 * r + 1]);
      }
    }
  }
}

// pass 2 on wgmma: dq of 128 queries (64 a warpgroup) over the block's
// listed key tiles. S = Qs.K^T and dP = dO.V^T are SS; dQ += dS.Ks takes dS
// from registers and Ks as the MN-major B operand.
template <typename T, bool CLAMPED, int DP>
__global__ void __launch_bounds__(WG_THREADS, DP <= 32 ? 3 : 2)
attn_bwd_dq_wgmma_kernel(const Params prm) {
  using L = TileLayout<DP>;
  // keys a part of the tile (see the loop): 32 at d <= 32, so that three
  // blocks fit a SM
  constexpr int SUB = DP <= 32 ? 32 : 64;
  constexpr int KT = KEY_TILE, Q_BYTES = WG_ROWS * DP * 2, K_BYTES = KT * DP * 2;
  constexpr int TILES = CLAMPED ? 3 : 2;  // K, V and (K2) ks = T(k * scale)
  constexpr int SLOT = TILES * K_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = smem;
  unsigned char* so = sq + Q_BYTES;
  unsigned char* ring = so + Q_BYTES;
  float* sbias = reinterpret_cast<float*>(ring + NSTAGE * SLOT);  // [NSTAGE][KT]
  int* list = reinterpret_cast<int*>(sbias + NSTAGE * KT);

  const int N = prm.N, d = prm.d;
  const int q0 = blockIdx.x * WG_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const T* qg = static_cast<const T*>(prm.q) + b * prm.q_sb + h * prm.q_sh;
  const T* kg = static_cast<const T*>(prm.k) + b * prm.k_sb + h * prm.k_sh;
  const T* vg = static_cast<const T*>(prm.v) + b * prm.v_sb + h * prm.v_sh;
  const T* og = static_cast<const T*>(prm.dout) + b * prm.o_sb + h * prm.o_sh;
  const float* bias_g = prm.bias ? prm.bias + b * prm.bias_sb : nullptr;
  const long long bh = static_cast<long long>(b) * prm.H + h;

  copy_wg_tile<T, DP, WG_THREADS, WG_ROWS>(sq, qg, prm.q_sn, q0, N, d);
  copy_wg_tile<T, DP, WG_THREADS, WG_ROWS>(so, og, prm.o_sn, q0, N, d);
  cp_async_commit();
  const int ntiles = list_key_tiles<WG_THREADS>(bias_g, N, list);

  auto load_kv = [&](int i) {
    if (i < ntiles) {
      const int e = list[i], k0 = (e >> 1) * KT, slot = i % NSTAGE;
      unsigned char* sk = ring + slot * SLOT;
      copy_wg_tile<T, DP, WG_THREADS, KT>(sk, kg, prm.k_sn, k0, N, d);
      copy_wg_tile<T, DP, WG_THREADS, KT>(sk + K_BYTES, vg, prm.v_sn, k0, N, d);
      if (bias_g && !(e & 1) && tid < KT) {
        const bool in = k0 + tid < N;
        cp_async4(sbias + slot * KT + tid, in ? bias_g + k0 + tid : bias_g, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) load_kv(i);

  float2 stat[2];
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    stat[r] = row_stats(row < N ? prm.lse[bh * N + row] : 0.0f, row < N);
    delta[r] = row < N ? prm.delta[bh * N + row] : 0.0f;
  }
  cp_async_wait<NSTAGE - 1>();  // the q and dO tiles (this thread's copies)
  if (CLAMPED) scale_wg_tile<T, DP, WG_THREADS, WG_ROWS>(sq, sq, prm.scale);  // qs, once

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
  const uint32_t sq_addr = smem_addr(sq), so_addr = smem_addr(so);
  const int q_row = 64 * (warp / 4);  // this warpgroup's first query of the block

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<NSTAGE - 2>();
    const int e = list[i], k0 = (e >> 1) * KT, slot = i % NSTAGE;
    unsigned char* sk = ring + slot * SLOT;
    float* sb = sbias + slot * KT;
    if (CLAMPED) scale_wg_tile<T, DP, WG_THREADS, KT>(sk + 2 * K_BYTES, sk, prm.scale);
    if (!(e & 1) && tid < KT) {
      const float bv = k0 + tid >= N ? NEG_BIAS : bias_g ? sb[tid] : 0.0f;
      sb[tid] = CLAMPED ? bv : bv * LOG2E;
    }
    fence_proxy_async();
    __syncthreads();
    load_kv(i + NSTAGE - 1);
    const uint32_t sk_addr = smem_addr(sk), sv_addr = sk_addr + K_BYTES;

    const uint32_t kb_addr = CLAMPED ? sk_addr + 2 * K_BYTES : sk_addr;  // ks (K4: k)
    // the tile's keys in SUB-row parts: s = qs.k^T and dp = dO.v^T over this
    // warpgroup's 64 queries, ds, then dq += ds.ks with ds from registers
#pragma unroll 1
    for (int part = 0; part < KT / SUB; ++part) {
      float s[SUB / 8][4], dp[SUB / 8][4];
      float(&s_flat)[SUB / 2] = reinterpret_cast<float(&)[SUB / 2]>(s);
      float(&dp_flat)[SUB / 2] = reinterpret_cast<float(&)[SUB / 2]>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<T, SUB>(s_flat, L::k_major(sq_addr, WG_ROWS, q_row, kk),
                         L::k_major(sk_addr, KT, SUB * part, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<T, SUB>(dp_flat, L::k_major(so_addr, WG_ROWS, q_row, kk),
                         L::k_major(sv_addr, KT, SUB * part, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_flat);
      fence_regs(dp_flat);
      if (e & 1) {
        grads_by_query<CLAMPED, true>(s, dp, sb + SUB * part, stat, delta, prm.scale);
      } else {
        grads_by_query<CLAMPED, false>(s, dp, sb + SUB * part, stat, delta, prm.scale);
      }
      uint32_t sa[SUB / 16][4];
#pragma unroll
      for (int kt = 0; kt < SUB / 16; ++kt) pack_a<T>(sa[kt], dp, kt);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < SUB / 16; ++kt) {
        WgmmaRS<T, DP>::run(dq, sa[kt], L::mn_major(kb_addr, SUB / 16 * part + kt));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(sa);
    }
  }
  cp_async_wait_all();

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
            Mma<T>::pack(dq[4 * dt + 2 * r], dq[4 * dt + 2 * r + 1]);
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

template <typename T, bool CLAMPED, int DK>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  using G = Geo<DK>;
  constexpr int QT = 32;
  const size_t smem1 = sizeof(T) * (2 * G::ROWS + NSTAGE * 2 * QT) * G::LD +
                       sizeof(float) * NSTAGE * 6 * QT;
  cudaError_t err = launch_kernel(attn_bwd_dkdv_kernel<T, CLAMPED, DK>, grid_of(p, G::ROWS),
                                  smem1, p, stream);
  if (err != cudaSuccess) return err;
  constexpr int STAGES = dq_stages<CLAMPED, DK>();
  const int ntiles = (p.N + KEY_TILE - 1) / KEY_TILE;
  const size_t smem2 = sizeof(T) * (2 * G::ROWS + STAGES * (CLAMPED ? 3 : 2) * KEY_TILE) * G::LD +
                       sizeof(float) * STAGES * KEY_TILE + sizeof(int) * ntiles;
  return launch_kernel(attn_bwd_dq_kernel<T, CLAMPED, DK>, grid_of(p, G::ROWS), smem2, p, stream);
}

template <typename T, bool CLAMPED, int DP>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  // + 1024: the kernels align their tiles to 1024 bytes (the swizzle's period)
  const size_t smem1 = 2 * (2 * WG_ROWS + NSTAGE * 2 * 64) * DP + sizeof(float) * NSTAGE * 6 * 64 +
                       1024;
  cudaError_t err = launch_kernel(attn_bwd_dkdv_wgmma_kernel<T, CLAMPED, DP>,
                                  grid_of(p, WG_ROWS), smem1, p, stream, WG_THREADS);
  if (err != cudaSuccess) return err;
  const int ntiles = (p.N + KEY_TILE - 1) / KEY_TILE;
  const size_t smem2 = 2 * (2 * WG_ROWS + NSTAGE * (CLAMPED ? 3 : 2) * KEY_TILE) * DP +
                       sizeof(float) * NSTAGE * KEY_TILE + sizeof(int) * ntiles + 1024;
  return launch_kernel(attn_bwd_dq_wgmma_kernel<T, CLAMPED, DP>, grid_of(p, WG_ROWS), smem2, p,
                       stream, WG_THREADS);
}

template <typename T, bool CLAMPED>
cudaError_t launch_16bit(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_wgmma<T, CLAMPED, 32>(p, stream);
  if (p.d <= 64) return launch_wgmma<T, CLAMPED, 64>(p, stream);
  if (p.d <= 80) return launch_mma<T, CLAMPED, 80>(p, stream);
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

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) per head, the softmax-correction term both passes
// read: one thread per (batch, head, query row), threads of a warp on
// neighbouring heads of one row (so a packed row is read contiguously), f32
// products and sum; T = float reads 4-byte elements, 16-bit types 16-byte
// chunks (d % 8 == 0, aligned, as the 16-bit kernels require)
// ---------------------------------------------------------------------------

struct DeltaParams {
  const void* out;
  const void* dout;
  long long o_sb, o_sh, o_sn;
  long long d_sb, d_sh, d_sn;
  float* delta;  // [B, H, N]
  int B, H, N, d;
};

template <typename T>
__global__ void __launch_bounds__(256) attn_delta_kernel(const DeltaParams prm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(prm.B) * prm.N * prm.H) return;
  const int h = static_cast<int>(i % prm.H), n = static_cast<int>((i / prm.H) % prm.N);
  const int b = static_cast<int>(i / (static_cast<long long>(prm.H) * prm.N));
  const T* o = static_cast<const T*>(prm.out) + b * prm.o_sb + h * prm.o_sh + n * prm.o_sn;
  const T* g = static_cast<const T*>(prm.dout) + b * prm.d_sb + h * prm.d_sh + n * prm.d_sn;
  float acc = 0.0f;
  if constexpr (sizeof(T) == 4) {
    for (int c = 0; c < prm.d; ++c) acc = fmaf(g[c], o[c], acc);
  } else {
    for (int c = 0; c < prm.d; c += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c);
      const uint4 y = *reinterpret_cast<const uint4*>(g + c);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = Mma<T>::unpack(xs[j]), e = Mma<T>::unpack(ys[j]);
        acc = fmaf(e.x, a.x, acc);
        acc = fmaf(e.y, a.y, acc);
      }
    }
  }
  prm.delta[(static_cast<long long>(b) * prm.H + h) * prm.N + n] = acc;
}

template <typename T>
cudaError_t launch_delta(const DeltaParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.N * p.H;
  const dim3 grid(static_cast<unsigned>((rows + 255) / 256));
  return launch_kernel(attn_delta_kernel<T>, grid, 0, p, stream, 256);
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

// delta [B, H, N] f32 contiguous = rowsum(dout * out) over d per head, from
// out and dout with the given element strides (unit stride along d); the
// backward wrappers call it before avj_attn_bwd_packed / avj_attn_bwd.
int avj_attn_delta(int dtype, const void* out, long long o_sb, long long o_sh, long long o_sn,
                   const void* dout, long long d_sb, long long d_sh, long long d_sn,
                   float* delta, int B, int H, int N, int d, void* stream) {
  if (d < 1 || d > MAX_D || N < 1 || B < 1 || H < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeltaParams p{out, dout, o_sb, o_sh, o_sn, d_sb, d_sh, d_sn, delta, B, H, N, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_delta<float>(p, s));
  if (d % 8 || !aligned16(out, o_sb, o_sh, o_sn) || !aligned16(dout, d_sb, d_sh, d_sn)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (dtype == 1) return static_cast<int>(launch_delta<__half>(p, s));
  if (dtype == 2) return static_cast<int>(launch_delta<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
