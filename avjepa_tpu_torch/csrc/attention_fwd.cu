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
// a score costs 4*d tensor-core operations (256 at d = 64, 320 at d = 80,
// 128 at d = 24 padded to 32): at the peak rate a warpgroup's 64x64 tile
// takes ~128 SM clocks of S and as many of P.V at d = 64 (~160 each at d =
// 80), and its 4096 exponentials take ~256 clocks on the SM's 16 MUFU
// lanes. So the exponentials set a floor as high as the products' at d = 64
// and 80% of it at d = 80, and the kernel nears that floor only where the
// exponentials of one warpgroup run under the products of another.
//
// Two designs, chosen by what the call is (uses_ws; ops/flash_attention.py's
// fwd_design names the same rule):
// - K1 at DP = 64 and 80 (ViT-L's and ViT-H's encoders): warp-specialised
//   and persistent (attn_fwd_wgmma_kernel<T, DP>), one block a SM walking
//   over work items of 192 q rows. A producer warpgroup gives up its
//   registers (setmaxnreg);
//   one of its warps lists each item's key tiles and streams the item's q
//   rows and then its listed K/V tiles by TMA into a 4-slot ring, read in
//   place off the packed qkv through a tensor map (qkv_map: 4-D {d, 3H, N,
//   B}, zeros past N and past d), each slot with a full and an empty
//   mbarrier: no block-wide barrier a tile, and the next item's loads run
//   under this item's products. Three consumer warpgroups of 64 rows raise
//   their registers, hold their q rows as S's register operand, and take
//   turns on the tensor cores (named barriers, the ping-pong): a consumer
//   starts S_j = Q.K_j^T and O += P_{j-1}.V_{j-1}, hands the tensor cores on,
//   exponentiates S_j while its P.V and the others' products run, then
//   frees tile j-1's slot. K1 keeps no running max, so nothing of O is
//   rescaled between tiles. Each tile commits the same two wgmma groups
//   and waits the same way, and no product is in flight across a tile:
//   ptxas otherwise cannot prove an accumulator retired before it is read
//   and makes every wgmma wait for the one before (it says so with C7514 /
//   C7515 under -Xptxas -v; this kernel's SASS has one wait a group).
// - Every other 16-bit call (K1 at d <= 32 and d > 80, K3): the cp.async
//   ring (attn_fwd_wgmma_kernel<T, CLAMPED, DP>). Two warpgroups a block, 64
//   query rows each: 128 rows share every K/V tile; K/V tiles (and a partial tile's 64 biases)
//   stream through a 3-slot cp.async ring (commit_group / wait_group), whose
//   copies write the swizzled addresses: tiles j+1 and j+2 are in flight
//   while tile j is computed; one barrier a tile. Each warpgroup runs S,
//   waits, runs its softmax, runs PV, waits, so the tensor cores idle during
//   a block's softmax unless the SM's other block fills them: three blocks
//   a SM at d <= 32, two at d = 64 and 80 (K3), one at d = 128.
// Both designs:
// - S = Q.K^T is wgmma m64n64k16 with K in shared memory (Q from registers
//   in the warp-specialised kernel, from shared memory in the ring); O += P.V
//   is wgmma m64nDPk16 with P from registers (the S accumulator, exp2'ed and
//   rounded to T, is exactly the A fragment) and V read as an MN-major
//   operand (the transpose flag). Tiles are stored as wgmma reads them
//   (TileLayout): 128-byte swizzled rows for d = 64, two 64-element column
//   blocks for d = 128, 64-byte rows for d = 32, and for d = 80 a 64-column
//   block of 128-byte rows beside a 16-column block of 32-byte rows (32-byte
//   swizzle): S takes 4 + 1 k16 steps and P.V an n64 and an n16 product, so
//   no product runs over padding. TMA writes the same layouts (128- and
//   32-byte swizzle boxes).
// - A block lists its 64-key tiles: a tile whose keys are all masked or
//   past N is left out (skipped, never read); a "full" tile (every key below
//   N with bias exactly 0) takes a path with no bias add. With no mask every
//   tile but a ragged last one is full; keys past N, which TMA fills with
//   zeros, take the partial tile's masked bias, so their p is 0.
// - Logits are in log2 units and p = ex2.approx (one MUFU op): K1 computes
//   min(s * log2e, 80 * log2e) (the same f32 value as min(s, 80) * log2e),
//   K3 folds scale * log2e and bias * log2e into one FFMA and keeps its
//   running max in log2 units. lse is written back in natural units; a K3
//   row that saw no valid key writes -1e30 + log(1e-30), the plain
//   version's value, exactly. Both sum the tiles in list order.
// - head_dim is zero-padded to 32, 64, 80 or 128 in shared memory and
//   registers only (d = 24 runs as 32), never in device memory.
// f32 inputs (exact comparisons, not speed) take a simple kernel: shared
// memory tiles and FMA loops, accurate expf.
//
// Measured on an H100 (PERF.md §6), K1 in bf16 at ViT-L's shape (B=24,
// N=1664, d=64) against the ring's 0.799 ms: one consumer pair waiting on
// each product (the serialised wgmma above) 0.99 ms; without the waits, two
// consumers 0.776, three 0.666, persistent 0.648, with the ping-pong
// 0.608-0.629 (SDPA 0.571-0.576). At d=80, N=4608, B=24: 5.01-5.12 ms
// against 6.56-6.58. What bounds it now: without any exponential it runs
// as fast (the MUFU lanes are no longer the floor); without the softmax at
// all it takes 0.449 ms, so the products, loads and hand-offs themselves
// run at ~60% of the tensor cores' peak. Tried and left: 128-key stages
// (slower with two consumers, spills with three), 6 or 8 slots (alike), q
// read from shared memory by S (slower). Not yet used: a cluster of two
// blocks sharing each K/V tile by TMA multicast (half the L2 traffic), K3
// on this design (its running max rescales O between tiles).

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

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

// the warp-specialised kernel's: K1's qkv as TMA reads it (qkv_map), 64-
// column boxes and at DP = 80 the 16-column boxes beside them
struct WsParams {
  CUtensorMap tm[2];
  Params p;
};

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma, softmax in registers
// ---------------------------------------------------------------------------

constexpr int FWD_WARPS = 8;             // two warpgroups
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_BQ = FWD_WARPS * 16;  // query rows per block: 64 a warpgroup
constexpr int NSTAGE = 3;               // K/V tiles in the cp.async ring

// The warp-specialised kernel (K1 at DP = 64 and 80): one persistent block
// a SM of a producer warpgroup and WS_CONSUMERS consumer warpgroups of 64
// query rows each. Three consumers ran K1 at ViT-L's shape in 0.666 ms on
// an H100 against two's 0.776 (192 q rows share each K/V tile, not 128);
// 4, 6 or 8 slots in the ring ran alike.
constexpr int WS_CONSUMERS = 3;
constexpr int WS_THREADS = (WS_CONSUMERS + 1) * 128;
constexpr int WS_BQ = 64 * WS_CONSUMERS;  // query rows of a work item
constexpr int WS_STAGES = 4;              // K/V tiles in the TMA ring
// a consumer holds two tiles at a time: j - 1 (P.V) and j (S)
static_assert(WS_STAGES >= 3, "the ring needs a slot for the tile being loaded");
// registers a thread after setmaxnreg, within the SM's 65536
constexpr int WS_PRODUCER_REGS = 32;
constexpr int WS_CONSUMER_REGS = 160;
static_assert(128 * (WS_PRODUCER_REGS + WS_CONSUMERS * WS_CONSUMER_REGS) <= 65536,
              "the warpgroups' registers exceed the SM's");
constexpr int SCHED = 1;  // named barriers SCHED + c: consumer c's turn on the tensor cores

// the design of a 16-bit instance: K1 (CLAMPED) at DP = 64 or 80 is
// warp-specialised, every other the cp.async ring (ops/flash_attention.py's
// fwd_design names the same rule)
__host__ __device__ constexpr bool uses_ws(bool clamped, int dp) {
  return clamped && (dp == 64 || dp == 80);
}

// blocks a SM of the ring kernel, which caps registers: 3 at DP = 32 (o is
// 16 registers a thread; on an H100 the third block takes the d = 24 calls
// from 0.58 to 0.51 ms), 2 at DP = 64 (3 would spill) and DP = 80 (o is 40
// registers; ~84 KB of shared memory a block), 1 at DP = 128
constexpr int fwd_blocks_per_sm(int dp) { return dp <= 32 ? 3 : dp <= 80 ? 2 : 1; }

// K1's logits of one listed 64-key tile in log2 units, in place, on the
// thread's columns (2t, 2t + 1 of each 8-key tile), as the ring kernel
// computes them: a full tile (no bias) is s * log2e; a partial tile adds
// bias * log2e, its keys' bias from sb (the tile's 64, or null without a
// mask), and keys past N get the masked bias, so p = 0 exactly. (The ring
// kernel keeps them inline: through this function it ran 3-4% slower at
// d = 24 on an H100.)
template <int NS>
__device__ __forceinline__ void tile_logits(float (&s)[NS], bool full, int k0, int N,
                                            const float* sb, int t) {
  if (full) {
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] *= LOG2E;
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NS / 4; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = nt * 8 + 2 * t + c;
      const float bl = (k0 + col < N ? (sb ? sb[col] : 0.0f) : NEG_BIAS) * LOG2E;
      s[4 * nt + c] = fmaf(s[4 * nt + c], LOG2E, bl);
      s[4 * nt + 2 + c] = fmaf(s[4 * nt + 2 + c], LOG2E, bl);
    }
  }
}

// K1's out = o / max(l, 1e-30) and lse = log(max(l, 1e-30)) of the thread's
// two rows (row0 and row0 + 8) of head h of batch row b, l_row the thread's
// part of each row sum: the ring kernel's epilogue
template <typename T, int DP>
__device__ __forceinline__ void write_rows(const Params& prm, const float (&o)[DP / 2],
                                           const float (&l_row)[2], int row0, int t, int h,
                                           int b) {
  const int N = prm.N, d = prm.d;
  T* og = static_cast<T*>(prm.o) + b * prm.o_sb + h * prm.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
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
    if (t == 0) prm.lse[(static_cast<long long>(b) * prm.H + h) * N + row] = logf(l);
  }
}

// CLAMPED = K1 numerics (scale folded into q, no-max clamped softmax);
// otherwise K3 numerics (scale on s, running max). DP = d padded to 32, 64,
// 80 or 128. Two warpgroups a block, each 64 query rows (warp w of the
// block owns rows 16w..16w+15). Logits are kept in log2 units: x = s * log2(e)
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
    for (int kt = 0; kt < BK / 16; ++kt) L::template rs<T>(o, pa[kt], sv_addr, kt);
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


// rows [row, row + 64) of qkv head `head` (q's heads are 0..H-1, k's H..2H-1,
// v's 2H..3H-1) of batch row b by TMA into rows [first, first + 64) of a
// [rows][DP] tile at dst (TileLayout<DP>): one box a column block, its bytes
// counted on `bar`
template <int DP>
__device__ __forceinline__ void tma_rows(const WsParams& prm, uint32_t dst, int rows, int first,
                                         int head, int row, int b, uint32_t bar) {
  tma_load_4d(dst + first * 128, &prm.tm[0], bar, 0, head, row, b);
  if (DP == 80) tma_load_4d(dst + rows * 128 + first * 32, &prm.tm[1], bar, 64, head, row, b);
}

// K1 at DP = 64 and 80, warp-specialised and persistent: one block a SM
// walks over the work items (a tile of WS_BQ q rows of one head of one batch
// row; item w + gridDim.x after item w). Warpgroup 0 is the producer: it
// gives up registers, and one warp runs ahead of the consumers over the
// items. For each it loads the item's q rows into the q slot once the
// consumers hold the last item's, then lists the item's 64-key tiles as
// list_key_tiles would (32 tiles at a time, a lane's own) and streams each
// listed K/V tile into a ring of WS_STAGES slots by TMA, off the packed qkv
// in place (qkv_map), with the tile's list entry and an item's-last mark in
// the slot's info word. An item with no listed tile gets one past N (zeros,
// all masked). Each slot has a full mbarrier (TMA's bytes complete it) and
// an empty one (each consumer warp arrives when done with it); the q slot
// likewise. The other warpgroups are consumers, 64 q rows each: per item
// each takes its scaled q rows into registers (the A operand of S = Q.K^T),
// then per tile j starts S_j and P_{j-1}.V_{j-1} (P from registers),
// exponentiates S_j while P.V runs, and frees tile j-1's slot; at the
// item's last tile it finishes P.V and writes the item's rows. Named
// barriers SCHED + c hand the tensor cores from consumer to consumer after
// each start (the ping-pong), so that one consumer's exponentials run under
// the others' products. The numerics are the ring kernel's for K1, in the
// same order of sums.
template <typename T, int DP>
__global__ void __launch_bounds__(WS_THREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ WsParams prm) {
  const Params& p = prm.p;
  using L = TileLayout<DP>;
  constexpr int Q_BYTES = WS_BQ * DP * 2;
  constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  constexpr int LAST = 1 << 30;          // info: the item's last tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = smem;
  const uint32_t sq_addr = smem_addr(sq), ring_addr = sq_addr + Q_BYTES;  // [WS_STAGES][K | V]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sq + Q_BYTES + WS_STAGES * 2 * KV_BYTES);
  volatile int* info = reinterpret_cast<volatile int*>(bars + 2 * WS_STAGES + 2);  // [WS_STAGES]
  // full[WS_STAGES], empty[WS_STAGES], then the q slot's full and empty
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * WS_STAGES;
  const uint32_t q_full = empty0 + 8 * WS_STAGES, q_empty = q_full + 8;

  const int N = p.N, H = p.H;
  const int qtiles = (N + WS_BQ - 1) / WS_BQ, items = qtiles * H * p.B;
  // the warpgroup, read from lane 0 so that the compiler knows it is the
  // same across the warp (a wgmma on a path it cannot prove converged is
  // made to wait for each product before the next)
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < WS_STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 4 * WS_CONSUMERS);  // the consumers' warps
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * WS_CONSUMERS);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (tid >= 32) return;
    const int ktiles = (N + BK - 1) / BK;
    if (lane == 0) {
      prefetch_tensor_map(&prm.tm[0]);
      if (DP == 80) prefetch_tensor_map(&prm.tm[1]);
    }
    int n = 0;  // tiles streamed so far, over all items
    for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
      const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
      const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;
      mbar_wait(q_empty, (it & 1) ^ 1);  // the consumers hold the last item's q
      if (lane == 0) {
        mbar_expect_tx(q_full, Q_BYTES);
        for (int r = 0; r < WS_BQ; r += BK) {
          tma_rows<DP>(prm, sq_addr, WS_BQ, r, h, qt * WS_BQ + r, b, q_full);
        }
      }
      // one listed tile (its entry, with LAST on the item's last) into the
      // next slot of the ring, once the consumers are done with the slot
      auto stream = [&](int entry) {
        const int stage = n % WS_STAGES;
        mbar_wait(empty0 + 8 * stage, ((n / WS_STAGES) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t sk = ring_addr + stage * 2 * KV_BYTES, full = full0 + 8 * stage;
          const int k0 = ((entry & (LAST - 1)) >> 1) * BK;
          info[stage] = entry;
          mbar_expect_tx(full, 2 * KV_BYTES);
          tma_rows<DP>(prm, sk, BK, 0, H + h, k0, b, full);
          tma_rows<DP>(prm, sk + KV_BYTES, BK, 0, 2 * H + h, k0, b, full);
        }
        ++n;
      };
      // the item's tiles as list_key_tiles lists them: skip (0), partial
      // (1) or full (3), lane i flagging tile k32 + i; each listed tile is
      // held back by one, so that the item's last gets its mark
      int held = -1;
      for (int k32 = 0; k32 < ktiles; k32 += 32) {
        const int kt = k32 + lane;
        int flag = kt < ktiles ? ((kt + 1) * BK <= N ? 3 : 1) : 0;
        if (bias_g && kt < ktiles) {
          int valid = 0, zero = 1;
#pragma unroll 16
          for (int e = 0; e < BK; ++e) {
            const int key = kt * BK + e;
            const float bv = key < N ? bias_g[key] : NEG_BIAS;
            valid |= bv > -1.0f;
            zero &= bv == 0.0f;
          }
          flag = valid ? (zero ? 3 : 1) : 0;
        }
        for (int i = 0; i < 32 && k32 + i < ktiles; ++i) {
          const int f = __shfl_sync(0xffffffffu, flag, i);
          if (f == 0) continue;
          if (held >= 0) stream(held);
          held = 2 * (k32 + i) + (f >> 1);
        }
      }
      // an item with no listed tile streams one past N: zeros, all masked
      stream((held >= 0 ? held : 2 * ktiles) | LAST);
    }
    return;
  }

  setmaxnreg_inc<WS_CONSUMER_REGS>();
  const int c = wg - 1, warp = (tid - 128 * wg) / 32;
  const int g = lane / 4, t = lane % 4;
  constexpr float CLAMP2 = SOFTMAX_CLAMP * LOG2E;
  uint32_t qa[DP / 16][4];
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  float o[DP / 2];
  float l_row[2];
  auto k_addr = [&](int n) { return ring_addr + (n % WS_STAGES) * 2 * KV_BYTES; };
  // the registers a turn's products read or write are fenced before it,
  // so that no other instruction lands between its products
  auto take_turn = [&]() {
    named_sync(SCHED + c, 256);
    fence_regs(o);
    fence_regs(pa);
    fence_regs(s);
    fence_regs(qa);
    wgmma_fence();
  };
  auto pass_turn = [&]() {
    named_arrive(SCHED + (c + 1) % WS_CONSUMERS, 256);
  };
  auto start_pv = [&](int n) {  // O += P . V of the tile streamed n-th
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) L::template rs<T>(o, pa[kt], k_addr(n) + KV_BYTES, kt);
  };
  auto release = [&](int n) {  // the consumers are done with the n-th tile's slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (n % WS_STAGES));
  };

  // consumer 0 takes the first turn; each turn passes to the next consumer
  if (c == WS_CONSUMERS - 1) named_arrive(SCHED, 256);
  int n = 0;  // tiles consumed so far, over all items
  for (int w = blockIdx.x, it = 0; w < items; w += gridDim.x, ++it) {
    const int qt = w % qtiles, h = (w / qtiles) % H, b = w / (qtiles * H);
    const float* bias_g = p.bias ? p.bias + b * p.bias_sb : nullptr;
    // (q * scale) in f32, rounded back to T, as the A operand of S: this
    // consumer's 64 rows (rows past N and columns past d arrived as zeros
    // and stay zero); then the q slot is free for the next item's
    mbar_wait(q_full, it & 1);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int r = 64 * c + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
      ldmatrix_x4(qa[kk], sq + L::offset(r, 2 * kk + (lane >> 4), WS_BQ));
      scale_frag<T>(qa[kk], p.scale);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    l_row[0] = l_row[1] = 0.0f;

    // Tile j of the item: S_j = Q.K_j^T and P_{j-1}.V_{j-1} are two commit
    // groups (the second empty at j = 0), so that every tile waits the same
    // way: S_j first, then the softmax under the P.V product, then the
    // rest. Nothing is in flight from one tile to the next, nor while its
    // registers are read or written: else ptxas makes each product wait for
    // the one before.
    for (int j = 0;; ++j, ++n) {
      mbar_wait(full0 + 8 * (n % WS_STAGES), (n / WS_STAGES) & 1);
      const int entry = __shfl_sync(0xffffffffu, info[n % WS_STAGES], 0);
      take_turn();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        WgmmaRK<T>::n64(s, qa[kk], L::k_major(k_addr(n), BK, 0, kk), kk > 0);
      }
      wgmma_commit();
      if (j > 0) start_pv(n - 1);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();  // S_j
      fence_regs(s);

      const int k0 = ((entry & (LAST - 1)) >> 1) * BK;
      tile_logits(s, entry & 1, k0, N, bias_g ? bias_g + k0 : nullptr, t);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = ex2(fminf(s[i], CLAMP2));
        l_row[(i / 2) % 2] += s[i];
      }
      wgmma_wait<0>();  // P_{j-1}.V_{j-1}
      fence_regs(o);
      fence_regs(pa);
      if (j > 0) release(n - 1);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        pa[kt][0] = Mma<T>::pack(s[8 * kt], s[8 * kt + 1]);
        pa[kt][1] = Mma<T>::pack(s[8 * kt + 2], s[8 * kt + 3]);
        pa[kt][2] = Mma<T>::pack(s[8 * kt + 4], s[8 * kt + 5]);
        pa[kt][3] = Mma<T>::pack(s[8 * kt + 6], s[8 * kt + 7]);
      }
      if (entry & LAST) break;
    }
    // the item's last P.V
    take_turn();
    start_pv(n);
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(n);
    ++n;
    write_rows<T, DP>(p, o, l_row, qt * WS_BQ + 64 * c + 16 * warp + g, t, h, b);
  }
  // the last consumer's last turn was passed on to consumer 0, which takes
  // no more: close that barrier's phase
  if (c == WS_CONSUMERS - 1) named_sync(SCHED, 256);
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

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has loaded
// (the library does not link libcuda); null if it is not found
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// K1's qkv [B, N, 3C] as TMA reads it: a 4-D tensor {d, 3H, N, B}
// (innermost first; heads 0..H-1 are q's, then k's, then v's), read in boxes
// of `cols` columns of one head's 64 rows with `swizzle`, the tile layout of
// wgmma.cuh. Columns past d and rows past N arrive as zeros.
template <typename T>
cudaError_t qkv_map(CUtensorMap* map, const Params& p, int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.d), static_cast<cuuint64_t>(3 * p.H),
                              static_cast<cuuint64_t>(p.N), static_cast<cuuint64_t>(p.B)};
  // bytes between heads, rows and batch rows
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.q_sh * 2),
                                 static_cast<cuuint64_t>(p.q_sn * 2),
                                 static_cast<cuuint64_t>(p.q_sb * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(p.q), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool CLAMPED, int DP>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  if constexpr (uses_ws(CLAMPED, DP)) {
    WsParams w{};
    w.p = p;
    cudaError_t err = qkv_map<T>(&w.tm[0], p, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess && DP == 80) {
      err = qkv_map<T>(&w.tm[1], p, 16, CU_TENSOR_MAP_SWIZZLE_32B);
    }
    int device = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    // one block a SM over the work items; + 1024: the kernel aligns its
    // tiles to 1024 bytes (the swizzle's period)
    const long long items = static_cast<long long>((p.N + WS_BQ - 1) / WS_BQ) * p.H * p.B;
    const size_t smem = 2 * (WS_BQ + WS_STAGES * 2 * BK) * DP +
                        sizeof(uint64_t) * (2 * WS_STAGES + 2) + sizeof(int) * WS_STAGES + 1024;
    return launch_kernel(static_cast<void (*)(WsParams)>(attn_fwd_wgmma_kernel<T, DP>),
                         dim3(static_cast<unsigned>(items < sms ? items : sms)), smem, w, stream,
                         WS_THREADS);
  } else {
    const int ntiles = (p.N + BK - 1) / BK;
    // + 1024: the kernel aligns its tiles to 1024 bytes (the swizzle's period)
    const size_t smem = 2 * (FWD_BQ + NSTAGE * 2 * BK) * DP + sizeof(float) * NSTAGE * BK +
                        sizeof(int) * ntiles + 1024;
    return launch_kernel(static_cast<void (*)(Params)>(attn_fwd_wgmma_kernel<T, CLAMPED, DP>),
                         grid_of(p, FWD_BQ), smem, p, stream, FWD_THREADS);
  }
}

template <typename T, bool CLAMPED>
cudaError_t launch_16bit(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_wgmma<T, CLAMPED, 32>(p, stream);
  if (p.d <= 64) return launch_wgmma<T, CLAMPED, 64>(p, stream);
  if (p.d <= 80) return launch_wgmma<T, CLAMPED, 80>(p, stream);
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
