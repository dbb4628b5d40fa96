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
// sk - sq), the ragged key tail and the padded query rows are masked, and
// GQA is by index: query head bh reads kv head bh / q_per_kv, and K4 sums
// dK and dV over the q_per_kv query heads of its kv head.
//
// Design:
// - K3: one block per (bh, 64-row q tile), 4 warps of 16 query rows. The
//   TPU's sequential k-block grid dimension becomes a loop over 64-key
//   tiles inside the block, with dQ in f32 registers; the causal loop
//   stops at the last tile the tile's last row may see (in place of the
//   TPU's packed triangle grid, _tri_decode). Q and dO stay in shared
//   memory for the whole loop; K and V tiles are reloaded per step.
// - K4: one block per (kv head, 64-key tile), 4 warps of 16 keys. It loops
//   over the q_per_kv query heads of the kv head and over the q tiles that
//   can see the key tile, and flushes dK and dV once: the reference's
//   in-kernel GQA reduction, with no atomics and no second pass, so dK and
//   dV are the same bits on every run. It computes the transposed scores
//   S^T = K Q^T with keys as rows, so P^T and dS^T come out of the
//   accumulators already shaped as the A operands of P^T dO and dS^T Q
//   (re-packed in registers, never stored); lse and delta then run along
//   columns and are read from shared memory. Each 64-row q tile is taken
//   as two halves of 32 columns so that the two f32 (64, D) accumulators
//   and the score fragments fit in registers without spilling at D = 128.
// - Both kernels run their products on the tensor cores as
//   mma.sync.m16n8k16 with bf16 (or fp16) operands and f32 accumulation,
//   and stage tiles in shared memory with 16-byte loads, zero-filling rows
//   past the sequence end (flash_common.cuh, shared with K1).
//
// Bound at the training slice's shape (b8 h16 s2048 d128, causal, bf16) on
// an H100 SXM at its 700 W limit (989 TFLOP/s dense bf16, 3.35 TB/s,
// NVIDIA's published peaks): 2,098,176 causal (row, key) pairs per head x
// 128 heads; each product costs 2 d FLOP a pair. K3 runs three products
// (Q K^T, dO V^T, dS K): 206.3 GFLOP, 0.209 ms, against about 0.10 ms of
// bytes; K4 runs four (Q K^T, dO V^T, P^T dO, dS^T Q): 275.0 GFLOP,
// 0.278 ms, against about 0.12 ms of bytes. Both are bound by operations.
//
// What this simple design leaves on the table: no wgmma (mma.sync reaches
// a fraction of Hopper's tensor-core rate), no TMA and no cp.async, no
// pipelining of the next tile behind the current products (every tile load
// is followed by a block-wide barrier), B fragments of the X * Y products
// assembled from 16-bit shared-memory loads instead of ldmatrix.trans, and
// one block per tile instead of a persistent schedule.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const typename Elem<BF16>::T* __restrict__ q,
                    const typename Elem<BF16>::T* __restrict__ k,
                    const typename Elem<BF16>::T* __restrict__ v,
                    const typename Elem<BF16>::T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    typename Elem<BF16>::T* __restrict__ dq, int sq, int sk,
                    int q_per_kv, int causal, float scale) {
  using T = typename Elem<BF16>::T;
  constexpr int LD = D + PAD;
  constexpr int KC = D / 16;         // 16-deep chunks of the head dim
  constexpr int DT = D / 8;          // 8-wide output tiles of the head dim
  constexpr int NT = BLOCK_N / 8;    // 8-wide key tiles of a K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BLOCK_M * LD;
  T* ks = dos + BLOCK_M * LD;
  T* vs = ks + BLOCK_N * LD;

  const int bh = blockIdx.x;
  // heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const int kvh = bh / q_per_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int offset = sk - sq;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const T* kg = k + size_t(kvh) * sk * D;
  const T* vg = v + size_t(kvh) * sk * D;
  load_tile<D>(qs, q + size_t(bh) * sq * D, q0, sq);
  load_tile<D>(dos, dout + size_t(bh) * sq * D, q0, sq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < sq;
    row_lse[i] = in ? lse[size_t(bh) * sq + rows[i]] : 0.f;
    row_delta[i] = in ? delta[size_t(bh) * sq + rows[i]] : 0.f;
  }
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int kv_end = sk;
  if (causal) {
    const int last_row = min(q0 + BLOCK_M - 1, sq - 1);
    kv_end = max(0, min(sk, last_row + offset + 1));
  }
  const int n_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv0 = kt * BLOCK_N;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(ks, kg, kv0, sk);
    load_tile<D>(vs, vg, kv0, sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, qw, kc, g, t);
      load_a<LD>(ado, dow, kc, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        load_b_t<LD>(b, ks, nt, kc, g, t);
        mma16816<BF16>(s[nt], aq, b);
        load_b_t<LD>(b, vs, nt, kc, g, t);
        mma16816<BF16>(dp[nt], ado, b);
      }
    }

    // dS = P * (dP - delta), in place of s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool keep = rows[i] < sq && col < sk &&
                          !(causal && col > rows[i] + offset);
        const float p =
            keep ? exp2f((s[nt][e] * scale - row_lse[i]) * LOG2E) : 0.f;
        s[nt][e] = p * (dp[nt][e] - row_delta[i]);
      }
    }

    // dQ += dS K with dS rounded to the input dtype
#pragma unroll
    for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
      uint32_t a[4];
      pack_a<BF16>(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b[2];
        load_b<LD>(b, ks, kc, dt, g, t);
        mma16816<BF16>(acc[dt], a, b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sq) continue;
    T* out = dq + (size_t(bh) * sq + rows[i]) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(out + dt * 8) = pack2<BF16>(
          acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const typename Elem<BF16>::T* __restrict__ q,
                     const typename Elem<BF16>::T* __restrict__ k,
                     const typename Elem<BF16>::T* __restrict__ v,
                     const typename Elem<BF16>::T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     typename Elem<BF16>::T* __restrict__ dk,
                     typename Elem<BF16>::T* __restrict__ dv, int sq, int sk,
                     int q_per_kv, int causal, float scale) {
  using T = typename Elem<BF16>::T;
  constexpr int LD = D + PAD;
  constexpr int KC = D / 16;
  constexpr int DT = D / 8;
  constexpr int HALF = BLOCK_M / 2;  // q columns per pass over a q tile
  constexpr int NT = HALF / 8;       // 8-wide q tiles of a half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BLOCK_N * LD;
  T* qs = vs + BLOCK_N * LD;
  T* dos = qs + BLOCK_M * LD;
  float* lses = reinterpret_cast<float*>(dos + BLOCK_M * LD);
  float* dels = lses + BLOCK_M;

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * BLOCK_N;   // the first (heaviest) tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int offset = sk - sq;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  load_tile<D>(ks, k + size_t(kvh) * sk * D, k0, sk);
  load_tile<D>(vs, v + size_t(kvh) * sk * D, k0, sk);
  const T* kw = ks + warp * 16 * LD;
  const T* vw = vs + warp * 16 * LD;

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.f;

  // the first query row that may see key k0
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int n_qt = (sq + BLOCK_M - 1) / BLOCK_M;

  for (int rep = 0; rep < q_per_kv; ++rep) {
    const int bh = kvh * q_per_kv + rep;
    const T* qg = q + size_t(bh) * sq * D;
    const T* dog = dout + size_t(bh) * sq * D;
    for (int qt = q_first / BLOCK_M; qt < n_qt; ++qt) {
      const int q0 = qt * BLOCK_M;
      __syncthreads();   // every warp is done with the previous q tile
      load_tile<D>(qs, qg, q0, sq);
      load_tile<D>(dos, dog, q0, sq);
      for (int r = threadIdx.x; r < BLOCK_M; r += THREADS) {
        const bool in = q0 + r < sq;
        lses[r] = in ? lse[size_t(bh) * sq + q0 + r] : 0.f;
        dels[r] = in ? delta[size_t(bh) * sq + q0 + r] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int c0 = 0; c0 < BLOCK_M; c0 += HALF) {
        // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ak[4], av[4];
          load_a<LD>(ak, kw, kc, g, t);
          load_a<LD>(av, vw, kc, g, t);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b[2];
            load_b_t<LD>(b, qs + c0 * LD, nt, kc, g, t);
            mma16816<BF16>(s[nt], ak, b);
            load_b_t<LD>(b, dos + c0 * LD, nt, kc, g, t);
            mma16816<BF16>(dp[nt], av, b);
          }
        }

        // P^T in place of s, dS^T = P^T * (dP^T - delta) in place of dp
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = keys[e >> 1];
            const int c = c0 + nt * 8 + 2 * t + (e & 1);
            const int row = q0 + c;
            const bool keep = row < sq && key < sk &&
                              !(causal && key > row + offset);
            const float p =
                keep ? exp2f((s[nt][e] * scale - lses[c]) * LOG2E) : 0.f;
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - dels[c]);
          }
        }

        // dV += P^T dO and dK += dS^T Q, both operands rounded to the
        // input dtype
#pragma unroll
        for (int kc = 0; kc < HALF / 16; ++kc) {
          uint32_t ap[4], ads[4];
          pack_a<BF16>(ap, s[2 * kc], s[2 * kc + 1]);
          pack_a<BF16>(ads, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            uint32_t b[2];
            load_b<LD>(b, dos + c0 * LD, kc, dt, g, t);
            mma16816<BF16>(acc_v[dt], ap, b);
            load_b<LD>(b, qs + c0 * LD, kc, dt, g, t);
            mma16816<BF16>(acc_k[dt], ads, b);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= sk) continue;
    const size_t off = (size_t(kvh) * sk + keys[i]) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) = pack2<BF16>(
          acc_k[dt][2 * i] * scale, acc_k[dt][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) =
          pack2<BF16>(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
    }
  }
}

template <int D, typename T>
constexpr size_t tiles_smem() {
  return size_t(2 * BLOCK_M + 2 * BLOCK_N) * (D + PAD) * sizeof(T);
}

template <int D, bool BF16>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int q_per_kv, int causal, float scale,
              cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const size_t smem = tiles_smem<D, T>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(bh, (sq + BLOCK_M - 1) / BLOCK_M);
  flash_bwd_dq_kernel<D, BF16><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, q_per_kv, causal, scale);
  return int(cudaGetLastError());
}

template <int D, bool BF16>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int sq, int sk, int q_per_kv, int causal, float scale,
               cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const size_t smem = tiles_smem<D, T>() + 2 * BLOCK_M * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(bh / q_per_kv, (sk + BLOCK_N - 1) / BLOCK_N);
  flash_bwd_dkv_kernel<D, BF16><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, q_per_kv, causal,
      scale);
  return int(cudaGetLastError());
}

}  // namespace

// q and dout (bh, sq, d), k/v (bh / q_per_kv, sk, d) in the input dtype,
// lse and delta (bh, sq) f32 -> dq (bh, sq, d) in the input dtype; all
// contiguous on CUDA device `device`, d in {64, 128}. Launches K3 on
// `stream` and returns the CUDA error code of the launch (0 on success).
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
                                         sq, sk, q_per_kv, causal, scale, s)
                   : launch_dq<64, false>(q, k, v, dout, lse, delta, dq, bh,
                                          sq, sk, q_per_kv, causal, scale, s);
  if (d == 128)
    return is_bf16 ? launch_dq<128, true>(q, k, v, dout, lse, delta, dq, bh,
                                          sq, sk, q_per_kv, causal, scale, s)
                   : launch_dq<128, false>(q, k, v, dout, lse, delta, dq, bh,
                                           sq, sk, q_per_kv, causal, scale,
                                           s);
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
                                          scale, s)
                   : launch_dkv<64, false>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, sq, sk, q_per_kv, causal,
                                           scale, s);
  if (d == 128)
    return is_bf16 ? launch_dkv<128, true>(q, k, v, dout, lse, delta, dk,
                                           dv, bh, sq, sk, q_per_kv, causal,
                                           scale, s)
                   : launch_dkv<128, false>(q, k, v, dout, lse, delta, dk,
                                            dv, bh, sq, sk, q_per_kv, causal,
                                            scale, s);
  return int(cudaErrorInvalidValue);
}
