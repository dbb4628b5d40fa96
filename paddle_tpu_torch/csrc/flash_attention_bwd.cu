// Flash-attention backward for Hopper (sm_90a), written by hand: K3 (dQ)
// and K4 (dK, dV).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fa_dq_kernel (K3)
// and ::_fa_dkv_kernel (K4), both launched by _flash_bwd_bhsd. With
// delta = rowsum(dO * O) (f32, computed by the caller, as the reference
// does outside Pallas) and the forward's lse, they compute the
// FlashAttention-2 backward:
//   P  = exp(scale * Q K^T - lse)                 (f32, masked entries 0)
//   dS = P * (dO V^T - delta)                     (f32)
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO
// with P rounded to the input dtype before P^T dO and dS rounded to it
// before dS K and dS^T Q, as the TPU kernels round them; every product
// accumulates in f32. The causal mask is aligned bottom-right (offset =
// sk - sq) and GQA is by index: query head bh reads kv head bh / q_per_kv,
// and K4 sums dK and dV over the q_per_kv query heads of its kv head.
// Neither kernel uses atomics, so dQ, dK and dV are the same bits on every
// run.
//
// Bound at the training slice's shape (b8 h16 s2048 d128, causal, bf16) on
// an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s, NVIDIA's published
// peaks): 2,098,176 causal (row, key) pairs per head x 128 heads; each
// product costs 2 d FLOP a pair. K3 runs three products (Q K^T, dO V^T,
// dS K): 206.3 GFLOP, 0.209 ms, against about 0.10 ms of bytes; K4 runs
// four (K Q^T, V dO^T, P^T dO, dS^T Q): 275.0 GFLOP, 0.278 ms, against
// about 0.12 ms of bytes. Both are bound by the tensor cores, so the design
// is K1's (flash_attention_fwd.cu), built from csrc/hopper_common.cuh:
// - Warp specialisation. A block is three warpgroups: a producer that
//   gives registers back (setmaxnreg 40) and two consumers (setmaxnreg 232)
//   of 64 rows each. One producer thread issues every TMA load.
// - TMA rings under mbarriers. The operand a block keeps (K3: its 128 rows
//   of Q and dO; K4: its 128 keys of K and V) arrives once; the operand it
//   walks over streams through a ring of 128-byte-swizzled slots, each with
//   "full" barriers completed by the TMA's byte count and an "empty"
//   barrier that each consumer warp arrives on after the wgmma.wait_group
//   of the last product that reads the slot. Tensor maps are 3-D
//   (D, S, heads): rows past sq or sk read as zero, the head is a
//   coordinate.
// - Every product on wgmma.mma_async, f32 accumulators in registers:
//   K3 (one block per (bh, 128-row q tile), 128-key K/V tiles):
//     S = Q K^T and dP = dO V^T, m64n128k16, both operands K-major;
//     dQ += dS K, m64nDk16, dS from registers (the accumulator re-packed),
//     K read as it lies (MN-major, the transpose bit set).
//     lse and delta are per row and stay in registers.
//   K4 (one block per (kv head, 128-key tile); the q_per_kv query heads of
//   the kv head and, in each, the 64-row q tiles that can see the key tile
//   stream through a 3-slot (d128) or 4-slot (d64) ring of (Q, dO) tiles:
//   the reference's in-kernel GQA sum):
//     S^T = K Q^T and dP^T = V dO^T, m64n64k16, both operands K-major, so
//     P^T and dS^T come out with keys as rows, shaped as the A operands of
//     dV += P^T dO and dK += dS^T Q, m64nDk16 with Q and dO read MN-major.
//     dK and dV stay in f32 registers (64 + 64 a thread at d128) across
//     the whole walk; both consumer warpgroups read each (Q, dO) slot.
//     lse and delta run along the columns: a second producer warp reads
//     each tile's 64 values of each with ordinary loads (a row's offset
//     bh * sq + q0 is not 16-byte aligned in general, so TMA and bulk
//     copies cannot take them), zero past sq, lse pre-scaled by log2(e),
//     into the slot beside the tiles, and arrives on its full barrier.
// - P is one FMA and an exp2f: exp2(s * scale * log2(e) - lse * log2(e)).
//   Only tiles that cross the causal diagonal or a sequence tail are
//   masked (a test uniform over the warpgroup); a masked score is -inf, so
//   its P is 0. Rows past sq in K3 and keys past sk in K4 are never stored
//   and need no mask. The heaviest causal tiles are scheduled first.
// - A block with no work (K3: causal sq > sk, rows that admit no key)
//   still stores zeros; its producer and consumers agree on the trip
//   count, so no barrier waits for a load that never comes.
// What it leaves open: within a warpgroup, the next tile's products are
// not issued behind the current tile's elementwise work, and the two
// consumer warpgroups are not ping-ponged; the grid is not persistent; the
// results are stored from registers; K3 and K4 read Q, K, V, dO, lse and
// delta twice between them (a fused backward with an atomic f32 dQ would
// run five products instead of seven, but dQ would stop repeating bit for
// bit); delta = rowsum(dO * O) is a separate torch pass.

#include <cmath>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;
using flash::Elem;
using flash::LOG2E;
using flash::pack2;

constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr int CONSUMER_REGS = 232;

// ---- K3: dQ ---------------------------------------------------------------

// shared-memory plan, byte offsets from a 1024-byte aligned base
template <int D>
struct DqPlan {
  static constexpr int BM = 128;   // query rows of a block
  static constexpr int BN = 128;   // keys of a ring tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t DO_OFF = Q_OFF + Q_BYTES;
  static constexpr uint32_t K_OFF = DO_OFF + Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q and dO, then full K, full V and empty, one per stage
  static constexpr uint32_t SMEM = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    typename Elem<BF16>::T* __restrict__ dq, int sq, int sk,
                    int q_per_kv, int causal, float scale) {
  using P = DqPlan<D>;
  using T = typename Elem<BF16>::T;
  constexpr int S = P::STAGES;
  constexpr int BM = P::BM;
  constexpr int BN = P::BN;
  constexpr int BOXES = D / 64;    // 64-column boxes of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + P::BAR_OFF;
  const uint32_t q_full = bars;
  auto full_k = [&](int s) { return bars + 8 + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 + 8 * (S + s); };
  auto empty = [&](int s) { return bars + 8 + 8 * (2 * S + s); };

  const int bh = blockIdx.x;
  // heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = sk - sq;
  int kv_end = sk;
  if (causal)
    kv_end = max(0, min(sk, min(q0 + BM - 1, sq - 1) + offset + 1));
  // 0 when no row of the block admits a key: the block stores zeros
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);      // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kvh = bh / q_per_kv;
      mbar_arrive_expect_tx(q_full, 2 * P::Q_BYTES);
      for (int b = 0; b < BOXES; ++b) {
        tma_load_3d(base + P::Q_OFF + b * BM * 128, &tm_q, q_full, 64 * b,
                    q0, bh);
        tma_load_3d(base + P::DO_OFF + b * BM * 128, &tm_do, q_full, 64 * b,
                    q0, bh);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % S;
        mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        const uint32_t ks = base + P::K_OFF + s * P::KV_BYTES;
        const uint32_t vs = base + P::V_OFF + s * P::KV_BYTES;
        mbar_arrive_expect_tx(full_k(s), P::KV_BYTES);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(ks + b * BN * 128, &tm_k, full_k(s), 64 * b, kt * BN,
                      kvh);
        mbar_arrive_expect_tx(full_v(s), P::KV_BYTES);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(vs + b * BN * 128, &tm_v, full_v(s), 64 * b, kt * BN,
                      kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator coordinates
    const int wrow0 = q0 + 64 * cw;         // the warpgroup's first row
    const int rows[2] = {wrow0 + 16 * warp + g, wrow0 + 16 * warp + g + 8};
    const float sl2 = scale * LOG2E;
    float lse2[2], dlt[2];                  // lse * log2(e) and delta
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = rows[i] < sq;
      lse2[i] = in ? lse[size_t(bh) * sq + rows[i]] * LOG2E : 0.f;
      dlt[i] = in ? delta[size_t(bh) * sq + rows[i]] : 0.f;
    }
    const uint32_t qs = base + P::Q_OFF + cw * 64 * 128;
    const uint32_t dos = base + P::DO_OFF + cw * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % S;
      const uint32_t ph = (kt / S) & 1;
      const int kv0 = kt * BN;
      const uint32_t ks = base + P::K_OFF + s * P::KV_BYTES;
      const uint32_t vs = base + P::V_OFF + s * P::KV_BYTES;

      // S = Q K^T and dP = dO V^T, 64 x BN per warpgroup
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BF16>(
            sc, sw128_desc(qs + (kk / 4) * BM * 128 + (kk % 4) * 32, 16),
            sw128_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16),
            kk > 0);
      mbar_wait(full_v(s), ph);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BF16>(
            dp, sw128_desc(dos + (kk / 4) * BM * 128 + (kk % 4) * 32, 16),
            sw128_desc(vs + (kk / 4) * BN * 128 + (kk % 4) * 32, 16),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // mask only a tile that crosses the diagonal or the key tail for
      // some row of this warpgroup (the test is uniform over it)
      if (kv0 + BN > sk || (causal && kv0 + BN - 1 > wrow0 + offset)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = rows[(i >> 1) & 1];
          if (col >= sk || (causal && col > row + offset))
            sc[i] = -INFINITY;
        }
      }

      // dS = P (dP - delta), rounded to the input dtype as the A operand
      // of dS K
      uint32_t da[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = exp2f(fmaf(sc[4 * j + e], sl2, -lse2[i]));
          ds[e] = p * (dp[4 * j + e] - dlt[i]);
        }
        da[2 * j] = pack2<BF16>(ds[0], ds[1]);
        da[2 * j + 1] = pack2<BF16>(ds[2], ds[3]);
      }

      // dQ += dS K: keys 16 kk .. 16 kk + 15 are da[4 kk .. 4 kk + 3]; K
      // is read as it lies (MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                               da[4 * kk + 3]};
        wgmma_rs<BF16>(acc, a, sw128_desc(ks + kk * 16 * 128, BN * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      // the slot's K and V have been read by this warp's products
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= sq) continue;
      T* out = dq + (size_t(bh) * sq + rows[i]) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) = pack2<BF16>(
            acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// ---- K4: dK, dV -----------------------------------------------------------

template <int D>
struct DkvPlan {
  static constexpr int BN = 128;   // keys of a block
  static constexpr int BQ = 64;    // query rows of a ring tile
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t QT_BYTES = BQ * D * 2;
  static constexpr uint32_t K_OFF = 0;
  static constexpr uint32_t V_OFF = K_OFF + KV_BYTES;
  static constexpr uint32_t Q_OFF = V_OFF + KV_BYTES;
  static constexpr uint32_t DO_OFF = Q_OFF + STAGES * QT_BYTES;
  // per stage: the tile's lse * log2(e), then its delta, BQ f32 each
  static constexpr uint32_t ROW_OFF = DO_OFF + STAGES * QT_BYTES;
  static constexpr uint32_t BAR_OFF = ROW_OFF + STAGES * 2 * BQ * 4;
  // barriers: K and V, then full Q, full dO (with lse and delta) and
  // empty, one per stage
  static constexpr uint32_t SMEM = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     typename Elem<BF16>::T* __restrict__ dk,
                     typename Elem<BF16>::T* __restrict__ dv, int sq, int sk,
                     int q_per_kv, int causal, float scale) {
  using P = DkvPlan<D>;
  using T = typename Elem<BF16>::T;
  constexpr int S = P::STAGES;
  constexpr int BN = P::BN;
  constexpr int BQ = P::BQ;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const rows_sm =
      reinterpret_cast<float*>(smem_raw + (base - raw) + P::ROW_OFF);
  const uint32_t bars = base + P::BAR_OFF;
  const uint32_t kv_full = bars;
  auto full_q = [&](int s) { return bars + 8 + 8 * s; };
  auto full_do = [&](int s) { return bars + 8 + 8 * (S + s); };
  auto empty = [&](int s) { return bars + 8 + 8 * (2 * S + s); };

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * BN;   // the first (heaviest) tiles first
  const int offset = sk - sq;
  // the q tiles that may see a key of the block, in each query head
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / BQ;
  const int n_qt = max(0, (sq + BQ - 1) / BQ - qt0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_q(s), 1);
      mbar_init(full_do(s), 1 + 32);   // the TMA thread and the row warp
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 reads lse and
    // delta; both walk the same (head, q tile) sequence ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * P::KV_BYTES);
      for (int b = 0; b < BOXES; ++b) {
        tma_load_3d(base + P::K_OFF + b * BN * 128, &tm_k, kv_full, 64 * b,
                    k0, kvh);
        tma_load_3d(base + P::V_OFF + b * BN * 128, &tm_v, kv_full, 64 * b,
                    k0, kvh);
      }
      int it = 0;
      for (int rep = 0; rep < q_per_kv; ++rep) {
        const int bh = kvh * q_per_kv + rep;
        for (int qt = qt0; qt < qt0 + n_qt; ++qt, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          const uint32_t qs = base + P::Q_OFF + s * P::QT_BYTES;
          const uint32_t dos = base + P::DO_OFF + s * P::QT_BYTES;
          mbar_arrive_expect_tx(full_q(s), P::QT_BYTES);
          for (int b = 0; b < BOXES; ++b)
            tma_load_3d(qs + b * BQ * 128, &tm_q, full_q(s), 64 * b,
                        qt * BQ, bh);
          mbar_arrive_expect_tx(full_do(s), P::QT_BYTES);
          for (int b = 0; b < BOXES; ++b)
            tma_load_3d(dos + b * BQ * 128, &tm_do, full_do(s), 64 * b,
                        qt * BQ, bh);
        }
      }
    } else if (warp == 1) {
      int it = 0;
      for (int rep = 0; rep < q_per_kv; ++rep) {
        const size_t row0 = size_t(kvh * q_per_kv + rep) * sq;
        for (int qt = qt0; qt < qt0 + n_qt; ++qt, ++it) {
          const int s = it % S;
          mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          float* dst = rows_sm + s * 2 * BQ;
          for (int r = lane; r < BQ; r += 32) {
            const int q = qt * BQ + r;
            const bool in = q < sq;
            dst[r] = in ? lse[row0 + q] * LOG2E : 0.f;
            dst[BQ + r] = in ? delta[row0 + q] : 0.f;
          }
          mbar_arrive(full_do(s));   // release: the stores come first
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * cw;           // the warpgroup's first key
    const int keys[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
    const float sl2 = scale * LOG2E;
    const uint32_t ks = base + P::K_OFF + cw * 64 * 128;
    const uint32_t vs = base + P::V_OFF + cw * 64 * 128;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int rep = 0; rep < q_per_kv; ++rep) {
      for (int qt = qt0; qt < qt0 + n_qt; ++qt, ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        const int q0 = qt * BQ;
        const uint32_t qs = base + P::Q_OFF + s * P::QT_BYTES;
        const uint32_t dos = base + P::DO_OFF + s * P::QT_BYTES;

        // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries
        float st[BQ / 2], dpt[BQ / 2];
        mbar_wait(full_q(s), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BF16>(
              st, sw128_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16),
              sw128_desc(qs + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
              kk > 0);
        mbar_wait(full_do(s), ph);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BF16>(
              dpt, sw128_desc(vs + (kk / 4) * BN * 128 + (kk % 4) * 32, 16),
              sw128_desc(dos + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // mask only a tile that crosses the diagonal or the query tail for
        // some key of this warpgroup
        if (q0 + BQ > sq || (causal && kw0 + 63 > q0 + offset)) {
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) {
            const int col = q0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int key = keys[(i >> 1) & 1];
            if (col >= sq || (causal && key > col + offset))
              st[i] = -INFINITY;
          }
        }

        // P^T and dS^T = P^T (dP^T - delta), each rounded to the input
        // dtype as the A operand of its product; lse and delta by column
        const float* lse2 = rows_sm + s * 2 * BQ;
        const float* dlt = lse2 + BQ;
        uint32_t pa[BQ / 4], da[BQ / 4];
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j +
                                                            2 * t);
          const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j +
                                                             2 * t);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f(fmaf(st[4 * j + e], sl2, (e & 1) ? -l.y : -l.x));
            ds[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
          pa[2 * j] = pack2<BF16>(p[0], p[1]);
          pa[2 * j + 1] = pack2<BF16>(p[2], p[3]);
          da[2 * j] = pack2<BF16>(ds[0], ds[1]);
          da[2 * j + 1] = pack2<BF16>(ds[2], ds[3]);
        }

        // dV += P^T dO and dK += dS^T Q: queries 16 kk .. 16 kk + 15 are
        // pa / da[4 kk .. 4 kk + 3]; dO and Q are read as they lie
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                 pa[4 * kk + 3]};
          wgmma_rs<BF16>(acc_v, a,
                         sw128_desc(dos + kk * 16 * 128, BQ * 128));
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                                 da[4 * kk + 3]};
          wgmma_rs<BF16>(acc_k, a, sw128_desc(qs + kk * 16 * 128, BQ * 128));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(pa);
        fence_regs(da);
        // the slot's Q, dO, lse and delta have been read by this warp
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (keys[i] >= sk) continue;
      const size_t off = (size_t(kvh) * sk + keys[i]) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack2<BF16>(acc_k[4 * j + 2 * i] * scale,
                        acc_k[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack2<BF16>(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int D, bool BF16>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int q_per_kv, int causal, float scale, int device,
              cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  using P = DqPlan<D>;
  static bool raised[MAX_DEVICES] = {};
  cudaError_t err = raise_smem(flash_bwd_dq_kernel<D, BF16>, P::SMEM, raised,
                               device);
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv, tdo;
  const int kvh = bh / q_per_kv;
  if (!encode_map(&tq, q, D, sq, bh, P::BM, BF16) ||
      !encode_map(&tdo, dout, D, sq, bh, P::BM, BF16) ||
      !encode_map(&tk, k, D, sk, kvh, P::BN, BF16) ||
      !encode_map(&tv, v, D, sk, kvh, P::BN, BF16))
    return int(cudaErrorInvalidValue);
  dim3 grid(bh, (sq + P::BM - 1) / P::BM);
  flash_bwd_dq_kernel<D, BF16><<<grid, THREADS, P::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk,
      q_per_kv, causal, scale);
  return int(cudaGetLastError());
}

template <int D, bool BF16>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int sq, int sk, int q_per_kv, int causal, float scale,
               int device, cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  using P = DkvPlan<D>;
  static bool raised[MAX_DEVICES] = {};
  cudaError_t err = raise_smem(flash_bwd_dkv_kernel<D, BF16>, P::SMEM,
                               raised, device);
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv, tdo;
  const int kvh = bh / q_per_kv;
  if (!encode_map(&tq, q, D, sq, bh, P::BQ, BF16) ||
      !encode_map(&tdo, dout, D, sq, bh, P::BQ, BF16) ||
      !encode_map(&tk, k, D, sk, kvh, P::BN, BF16) ||
      !encode_map(&tv, v, D, sk, kvh, P::BN, BF16))
    return int(cudaErrorInvalidValue);
  dim3 grid(kvh, (sk + P::BN - 1) / P::BN);
  flash_bwd_dkv_kernel<D, BF16><<<grid, THREADS, P::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, q_per_kv, causal, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q and dout (bh, sq, d), k/v (bh / q_per_kv, sk, d) in the input dtype,
// lse and delta (bh, sq) f32 -> dq (bh, sq, d) in the input dtype; all
// contiguous and 16-byte aligned on CUDA device `device`, d in {64, 128}.
// Launches K3 on `stream` and returns the CUDA error code of the launch (0
// on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int q_per_kv, int causal,
                            float scale, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dq<64, true>(q, k, v, dout, lse, delta, dq, bh,
                                         sq, sk, q_per_kv, causal, scale,
                                         device, s)
                   : launch_dq<64, false>(q, k, v, dout, lse, delta, dq, bh,
                                          sq, sk, q_per_kv, causal, scale,
                                          device, s);
  if (d == 128)
    return is_bf16 ? launch_dq<128, true>(q, k, v, dout, lse, delta, dq, bh,
                                          sq, sk, q_per_kv, causal, scale,
                                          device, s)
                   : launch_dq<128, false>(q, k, v, dout, lse, delta, dq, bh,
                                           sq, sk, q_per_kv, causal, scale,
                                           device, s);
  return int(cudaErrorInvalidValue);
}

// As flash_bwd_dq, -> dk, dv (bh / q_per_kv, sk, d) in the input dtype,
// summed over each kv head's q_per_kv query heads. Launches K4.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int q_per_kv, int causal,
                             float scale, int is_bf16, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dkv<64, true>(q, k, v, dout, lse, delta, dk, dv,
                                          bh, sq, sk, q_per_kv, causal,
                                          scale, device, s)
                   : launch_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, sq, sk, q_per_kv, causal,
                                           scale, device, s);
  if (d == 128)
    return is_bf16 ? launch_dkv<128, true>(q, k, v, dout, lse, delta, dk,
                                           dv, bh, sq, sk, q_per_kv, causal,
                                           scale, device, s)
                   : launch_dkv<128, false>(q, k, v, dout, lse, delta, dk,
                                            dv, bh, sq, sk, q_per_kv, causal,
                                            scale, device, s);
  return int(cudaErrorInvalidValue);
}
