// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fa_fwd_kernel (the
// epilogue=False forward) as launched by _flash_fwd_bhsd. It computes the
// FlashAttention-2 forward:
//   O   = softmax(scale * Q K^T + mask) V          (in the input dtype)
//   lse = m + log(l)                                (f32, one per row)
// with the running (m, l, acc) state in f32, P rounded to the input dtype
// before the P V product as the TPU kernel does, the causal mask aligned
// bottom-right (offset = sk - sq), the ragged key tail masked with the
// finite -1e30 of the reference, and GQA by index: query head bh reads kv
// head bh / q_per_kv (batch-major bh), so K/V are never expanded.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// training shape (b8 h16 s2048 d128, causal) the two products are about
// 137 GFLOP, 0.139 ms, against 0.040 ms of bytes, so the kernel is bound
// by the tensor cores; at the serving prefill shape (b4 h32 s512 d128) by
// bytes, about 0.020 ms. The design keeps the tensor cores fed:
// - Warp specialisation. A block is three warpgroups and owns 128 query
//   rows of one bh. Warpgroup 0 is the producer: it gives registers back
//   (setmaxnreg.dec) and one thread issues every TMA load. Warpgroups 1
//   and 2 are consumers (setmaxnreg.inc), 64 query rows each, with the
//   running state in registers.
// - TMA into a ring. Q (and K2's residual) arrive once; the 128-key K and V
//   tiles stream through a ring of STAGES slots guarded by mbarriers: a
//   "full" barrier per slot and tensor that the TMA completes by bytes, an
//   "empty" barrier per slot that each consumer warp arrives on when its
//   products have read the slot. The tensor maps are 3-D (D, S, heads), so
//   rows past sq or sk read as zero inside each head and the kv head is a
//   coordinate. Tiles are 128-byte swizzled, 64 columns a box.
// - Both products on wgmma.mma_async: S = Q K^T as m64n128k16 with Q and K
//   K-major from shared memory; O += P V as m64nDk16 with P from registers
//   (the S accumulator re-packed to the input dtype, hopper_common.cuh) and
//   V as it lies (MN-major, the transpose bit set): no transposed copy.
// - Only tiles that cross the causal diagonal or the sk tail are masked
//   (a per-warpgroup test); scale * log2(e) is folded into one FMA before
//   exp2f, with m kept on the raw scores; the quad sum of l waits for the
//   flush. The key loop stops at the block's causal limit and the heaviest
//   q tiles are scheduled first.
// What it leaves for later: the next tile's Q K^T is not issued behind the
// current softmax, the two consumer warpgroups are not ping-ponged, the
// grid is not persistent, and O is stored from registers.
//
// K2, the fused RMSNorm epilogue (the same Pallas kernel with
// epilogue=True, launched through flash_attention_rms_epilogue_bshd), is
// this kernel with EPI = true: only the flush differs. Per query row, in
// f32 and without rounding the attention output first,
//   h   = acc / l + residual
//   ms  = sum(h^2) / rms_d          (rms_d: the true head dim; the pad
//                                    columns of acc, residual and gamma are 0)
//   out = h * rsqrt(ms + eps) * gamma      (gamma f32), written in q's dtype
// and lse as K1 writes it, bit for bit. A row's D values are spread over
// the four lanes of a quad (t = lane % 4) and the 8-wide column chunks, so
// the sum of squares is a per-thread sum then two xor shuffles inside the
// quad; every lane takes part, rows past sq included (their residual reads
// as 0 and nothing is stored). The residual tile and gamma have their own
// buffer, loaded by TMA and a bulk copy after the last K/V tile is issued,
// so their reads run behind the products.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;
using flash::Elem;
using flash::LOG2E;
using flash::NEG_INF;
using flash::pack2;
using flash::unpack2;

constexpr int BM = 128;            // query rows of a block
constexpr int BN = 128;            // keys of a tile
constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr int CONSUMER_REGS = 232;

// shared-memory plan, byte offsets from a 1024-byte aligned base
template <int D, bool EPI>
struct Plan {
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = Q_OFF + Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t R_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t G_OFF = R_OFF + (EPI ? Q_BYTES : 0);
  static constexpr uint32_t BAR_OFF = G_OFF + (EPI ? D * 4 : 0);
  // barriers: q, residual and gamma, then full K, full V and empty, one per
  // stage
  static constexpr uint32_t SMEM = BAR_OFF + (2 + 3 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

template <int D, bool BF16, bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_r,
                 const float* __restrict__ gamma,
                 typename Elem<BF16>::T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int q_per_kv,
                 int causal, float scale, float eps, int rms_d) {
  using P = Plan<D, EPI>;
  constexpr int S = P::STAGES;
  constexpr int BOXES = D / 64;    // 64-column boxes of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + P::BAR_OFF;
  const uint32_t q_full = bars, r_full = bars + 8;
  auto full_k = [&](int s) { return bars + 16 + 8 * s; };
  auto full_v = [&](int s) { return bars + 16 + 8 * (S + s); };
  auto empty = [&](int s) { return bars + 16 + 8 * (2 * S + s); };

  const int bh = blockIdx.x;
  // heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = sk - sq;
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + BM - 1, sq - 1) + offset + 1);
  // a block whose rows admit no key still runs one (fully masked) tile
  const int n_tiles = max(1, (kv_end + BN - 1) / BN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(r_full, 1);
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
      mbar_arrive_expect_tx(q_full, P::Q_BYTES);
      for (int b = 0; b < BOXES; ++b)
        tma_load_3d(base + P::Q_OFF + b * BM * 128, &tm_q, q_full, 64 * b,
                    q0, bh);
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
      // K2's residual and gamma are needed only at the flush: they follow
      // the last K/V tile, so they do not delay the first products. They
      // are issued after the loop, not from inside it: with the load inside
      // the loop, nvcc 12.9's cicc did not finish in ten minutes.
      if constexpr (EPI) {
        mbar_arrive_expect_tx(r_full, P::Q_BYTES + D * 4);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(base + P::R_OFF + b * BM * 128, &tm_r, r_full, 64 * b,
                      q0, bh);
        bulk_load(base + P::G_OFF, gamma, D * 4, r_full);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    using T = typename Elem<BF16>::T;
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator coordinates
    const int wrow0 = q0 + 64 * cw;         // the warpgroup's first row
    const int r0 = wrow0 + 16 * warp + g;   // this thread's two rows
    const int r1 = r0 + 8;
    const float sl2 = scale * LOG2E;
    const float neg_raw = NEG_INF / scale;  // -1e30 once scaled
    const uint32_t qs = base + P::Q_OFF + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {neg_raw, neg_raw};        // row max of the raw scores
    float l[2] = {0.f, 0.f};                // this thread's part of l

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % S;
      const uint32_t ph = (kt / S) & 1;
      const int kv0 = kt * BN;
      const uint32_t ks = base + P::K_OFF + s * P::KV_BYTES;
      const uint32_t vs = base + P::V_OFF + s * P::KV_BYTES;

      // S = Q K^T (raw scores), 64 x 128 per warpgroup
      float sc[BN / 2];
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BF16>(
            sc, sw128_desc(qs + (kk / 4) * BM * 128 + (kk % 4) * 32, 16),
            sw128_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask only a tile that crosses the diagonal or the key tail for
      // some row of this warpgroup (the test is uniform over it)
      if (kv0 + BN > sk || (causal && kv0 + BN - 1 > wrow0 + offset)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          if (col >= sk || (causal && col > row + offset)) sc[i] = neg_raw;
        }
      }

      // online softmax: (m, l) and acc rescaled by alpha
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2], mb[2], rsl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f((m[i] - mx[i]) * sl2);
        m[i] = mx[i];
        // a row that has met no admissible key yet (causal, sq > sk) has
        // only masked scores: give each p = 1, as exp(-1e30 - -1e30) is,
        // so the row stays finite. With sl2, fmaf would leave the rounding
        // residual of -1e30 * log2(e) (up to 2^76) in the exponent.
        rsl[i] = mx[i] == neg_raw ? 0.f : sl2;
        mb[i] = mx[i] * rsl[i];
      }
      // P = exp(scale (s - m)), rounded to the input dtype as the A operand
      // of P V; l sums the unrounded values
      uint32_t pa[BN / 4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2f(fmaf(sc[4 * j], rsl[0], -mb[0]));
        const float p1 = exp2f(fmaf(sc[4 * j + 1], rsl[0], -mb[0]));
        const float p2 = exp2f(fmaf(sc[4 * j + 2], rsl[1], -mb[1]));
        const float p3 = exp2f(fmaf(sc[4 * j + 3], rsl[1], -mb[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[2 * j] = pack2<BF16>(p0, p1);
        pa[2 * j + 1] = pack2<BF16>(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // acc += P V: keys 16 kk .. 16 kk + 15 are accumulator chunks 2 kk
      // and 2 kk + 1, i.e. pa[4 kk .. 4 kk + 3]
      mbar_wait(full_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<BF16>(o, a, sw128_desc(vs + kk * 16 * 128, BN * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      // the slot's K and V have been read by this warp's products
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // flush: out = acc / l (K1) or the RMSNorm epilogue (K2), and
    // lse = m + log(l), as the reference's _flush
    if constexpr (EPI) mbar_wait(r_full, 0);
    const unsigned char* rsm = smem_raw + (base - raw) + P::R_OFF;
    const float* gsm =
        reinterpret_cast<const float*>(smem_raw + (base - raw) + P::G_OFF);
    const int rows[2] = {r0, r1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const bool valid = rows[i] < sq;
      const float lsafe = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lsafe;
      float ns[D / 8][2];   // this row's outputs at the thread's columns
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        ns[j][0] = o[4 * j + 2 * i] * inv;
        ns[j][1] = o[4 * j + 2 * i + 1] * inv;
      }
      if constexpr (EPI) {
        // the residual tile's row (zero past sq) at the thread's columns:
        // local row lr, chunk j % 8 of box j / 8, swizzled by lr % 8 = g
        const int lr = 64 * cw + 16 * warp + g + 8 * i;
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 r = unpack2<BF16>(flash::ld32(
              rsm + (j / 8) * BM * 128 + lr * 128 + (((j % 8) ^ g) << 4) +
              4 * t));
          ns[j][0] += r.x;
          ns[j][1] += r.y;
          ss += ns[j][0] * ns[j][0] + ns[j][1] * ns[j][1];
        }
        // the row's other columns live in the quad's other three lanes; all
        // 32 lanes reach these shuffles
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float rn = rsqrtf(ss / float(rms_d) + eps);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 w =
              *reinterpret_cast<const float2*>(gsm + 8 * j + 2 * t);
          ns[j][0] *= rn * w.x;
          ns[j][1] *= rn * w.y;
        }
      }
      if (!valid) continue;
      T* orow = out + (size_t(bh) * sq + rows[i]) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack2<BF16>(ns[j][0], ns[j][1]);
      if (t == 0) lse[size_t(bh) * sq + rows[i]] = m[i] * scale + logf(lsafe);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <int D, bool BF16, bool EPI>
int launch(const void* q, const void* k, const void* v, const void* residual,
           const float* gamma, void* out, void* lse, int bh, int sq, int sk,
           int q_per_kv, int causal, float scale, float eps, int rms_d,
           int device, cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  constexpr uint32_t smem = Plan<D, EPI>::SMEM;
  static bool raised[MAX_DEVICES] = {};
  const cudaError_t err =
      raise_smem(flash_fwd_kernel<D, BF16, EPI>, smem, raised, device);
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv, tr;
  const int kvh = bh / q_per_kv;
  if (!encode_map(&tq, q, D, sq, bh, BM, BF16) ||
      !encode_map(&tk, k, D, sk, kvh, BN, BF16) ||
      !encode_map(&tv, v, D, sk, kvh, BN, BF16))
    return int(cudaErrorInvalidValue);
  tr = tq;   // K1 reads no residual
  if (EPI && !encode_map(&tr, residual, D, sq, bh, BM, BF16))
    return int(cudaErrorInvalidValue);
  dim3 grid(bh, (sq + BM - 1) / BM);
  flash_fwd_kernel<D, BF16, EPI><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tr, gamma, static_cast<T*>(out), static_cast<float*>(lse),
      sq, sk, q_per_kv, causal, scale, eps, rms_d);
  return int(cudaGetLastError());
}

template <bool EPI>
int dispatch(const void* q, const void* k, const void* v,
             const void* residual, const float* gamma, void* out, void* lse,
             int bh, int sq, int sk, int d, int q_per_kv, int causal,
             float scale, float eps, int rms_d, int is_bf16, int device,
             void* stream) {
  // this library links its own CUDA runtime: select the tensors' device
  // here rather than rely on the caller's runtime state
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch<64, true, EPI>(q, k, v, residual, gamma, out,
                                           lse, bh, sq, sk, q_per_kv, causal,
                                           scale, eps, rms_d, device, s)
                   : launch<64, false, EPI>(q, k, v, residual, gamma, out,
                                            lse, bh, sq, sk, q_per_kv,
                                            causal, scale, eps, rms_d,
                                            device, s);
  if (d == 128)
    return is_bf16 ? launch<128, true, EPI>(q, k, v, residual, gamma, out,
                                            lse, bh, sq, sk, q_per_kv,
                                            causal, scale, eps, rms_d,
                                            device, s)
                   : launch<128, false, EPI>(q, k, v, residual, gamma, out,
                                             lse, bh, sq, sk, q_per_kv,
                                             causal, scale, eps, rms_d,
                                             device, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// K1. q (bh, sq, d), k/v (bh / q_per_kv, sk, d), out (bh, sq, d) in the
// input dtype, lse (bh, sq) f32; all contiguous and 16-byte aligned on CUDA
// device `device`, d in {64, 128}. Launches on `stream` and returns the
// CUDA error code of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int sq, int sk, int d,
                         int q_per_kv, int causal, float scale, int is_bf16,
                         int device, void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, out, lse, bh, sq, sk, d,
                         q_per_kv, causal, scale, 0.f, d, is_bf16, device,
                         stream);
}

// K2: as flash_fwd, plus residual (bh, sq, d) in the input dtype and gamma
// (d,) f32, both zero in the pad columns; out = rmsnorm(attn + residual) *
// gamma over the head dim with the mean taken over rms_d columns.
extern "C" int flash_fwd_rms_epilogue(
    const void* q, const void* k, const void* v, const void* residual,
    const void* gamma, void* out, void* lse, int bh, int sq, int sk, int d,
    int q_per_kv, int causal, float scale, float eps, int rms_d, int is_bf16,
    int device, void* stream) {
  return dispatch<true>(q, k, v, residual, static_cast<const float*>(gamma),
                        out, lse, bh, sq, sk, d, q_per_kv, causal, scale, eps,
                        rms_d, is_bf16, device, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
