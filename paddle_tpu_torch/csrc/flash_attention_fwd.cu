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
// Design, taken from what K1 computes and not from its Pallas blocks:
// - One thread block per (bh, q tile of 64 rows); 4 warps, each warp owns
//   16 query rows. The TPU's sequential k-block grid dimension and its VMEM
//   scratch become a loop over 64-key tiles inside the block, with the
//   running state in registers.
// - The TPU's packed lower-triangle grid becomes a k loop that stops at the
//   last tile the causal bound of the tile's last row admits.
// - Q, K and V tiles are staged in shared memory with 16-byte loads; rows
//   past the sequence end are zero-filled. Rows are padded by 8 elements so
//   the fragment loads hit distinct banks. At D=128 the three tiles take
//   52 KB, above the 48 KB default, so the launch raises the block's
//   dynamic shared-memory limit.
// - Q K^T and P V run on the tensor cores as mma.sync.m16n8k16 with bf16
//   (or fp16) operands and f32 accumulation. The S accumulator fragments
//   are re-packed in registers as the A operand of P V (the FA-2 register
//   trick): P never goes to shared memory.
//
// Bound at the slice's prefill shape (b4 h32 s512 d128, causal, bf16) on an
// H100 SXM at its 700 W limit (3.35 TB/s, 989 TFLOP/s dense bf16, NVIDIA's
// published peaks): reading q/k/v and writing o is about 67 MB, about
// 20 us; the causal products are about 8.6 GFLOP, about 8.7 us. So the
// kernel is bound by bytes, about 20 us per launch.
//
// What this simple design leaves on the table: no wgmma (mma.sync reaches a
// fraction of Hopper's tensor-core rate), no TMA and no cp.async, no
// pipelining of the next K/V tile behind the current products (every tile
// load is followed by a block-wide barrier), V fragments assembled from
// 16-bit shared-memory loads instead of ldmatrix.trans, and one block per
// q tile instead of a persistent schedule.
//
// K2, the fused RMSNorm epilogue (the same Pallas kernel with
// epilogue=True, launched through flash_attention_rms_epilogue_bshd), is
// this kernel with EPI = true: only the flush differs. Per query row, in
// f32 and without rounding the attention output first,
//   h   = acc / l + residual
//   ms  = sum(h^2) / rms_d          (rms_d: the true head dim; the pad
//                                    columns of acc, residual and gamma are 0)
//   out = h * rsqrt(ms + eps) * gamma      (gamma f32), written in q's dtype
// and lse as K1 writes it. A row's D values are spread over the four lanes
// of a quad (t = lane % 4) and the DT 8-wide tiles, so the sum of squares
// is a per-thread sum then two xor shuffles inside the quad; every lane
// takes part in the shuffles, rows past sq included (their residual reads
// as 0 and nothing is stored). The residual tile is copied with cp.async
// into the Q tile's shared memory (free once the Q fragments are in
// registers) before the key loop, so its read runs behind the products
// and the flush reads it from shared memory at the (row, column)
// fragments the thread writes. K2 moves q, k, v and the residual in and
// the output out once: about 25 us at the prefill shape (bytes); K1 plus
// a separate epilogue pass moves the output three more times.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D, bool BF16, bool EPI>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const typename Elem<BF16>::T* __restrict__ q,
                 const typename Elem<BF16>::T* __restrict__ k,
                 const typename Elem<BF16>::T* __restrict__ v,
                 const typename Elem<BF16>::T* __restrict__ residual,
                 const float* __restrict__ gamma,
                 typename Elem<BF16>::T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int q_per_kv,
                 int causal, float scale, float eps, int rms_d) {
  using T = typename Elem<BF16>::T;
  constexpr int LD = D + PAD;
  constexpr int KC = D / 16;         // 16-wide chunks of the head dim
  constexpr int DT = D / 8;          // 8-wide output tiles of the head dim
  constexpr int NT = BLOCK_N / 8;    // 8-wide key tiles of a K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BLOCK_M * LD;
  T* vs = ks + BLOCK_N * LD;

  const int bh = blockIdx.x;
  // heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;
  const int kvh = bh / q_per_kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates
  const int offset = sk - sq;
  const int r0 = q0 + warp * 16 + g;      // this thread's two rows
  const int r1 = r0 + 8;

  const T* qg = q + size_t(bh) * sq * D;
  const T* kg = k + size_t(kvh) * sk * D;
  const T* vg = v + size_t(kvh) * sk * D;

  load_tile<D>(qs, qg, q0, sq);
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    load_a<LD>(qa[kc], qs + warp * 16 * LD, kc, g, t);
  if constexpr (EPI) {
    // the Q tile is in registers now: its shared memory takes the residual
    // tile, copied in the background while the key loop runs
    __syncthreads();
    load_tile_async<D>(qs, residual + size_t(bh) * sq * D, q0, sq);
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  int kv_end = sk;
  if (causal) {
    int last_row = min(q0 + BLOCK_M - 1, sq - 1);
    kv_end = min(sk, last_row + offset + 1);
  }
  // a tile whose rows admit no key still runs one (fully masked) k tile
  const int n_tiles = max(1, (kv_end + BLOCK_N - 1) / BLOCK_N);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int kv0 = kt * BLOCK_N;
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<D>(ks, kg, kv0, sk);
    load_tile<D>(vs, vg, kv0, sk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[2];
        load_b_t<LD>(b, ks, nt, kc, g, t);
        mma16816<BF16>(s[nt], qa[kc], b);
      }
    }

    // scale, mask, and the online-softmax update of (m, l, acc)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= sk || (causal && col > row + offset)) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f((s[nt][e] - m[e >> 1]) * LOG2E);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // acc += P V with P rounded to the input dtype
#pragma unroll
    for (int kc = 0; kc < BLOCK_N / 16; ++kc) {
      uint32_t a[4];
      pack_a<BF16>(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b[2];
        load_b<LD>(b, vs, kc, dt, g, t);
        mma16816<BF16>(o[dt], a, b);
      }
    }
  }

  // flush: out = acc / l (K1) or the RMSNorm epilogue (K2), and
  // lse = m + log(l), as the reference's _flush
  if constexpr (EPI) {
    cp_async_wait_all();
    __syncthreads();   // every thread's part of the residual tile landed
  }
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = rows[i] < sq;
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    const size_t row_off = (size_t(bh) * sq + rows[i]) * D + 2 * t;
    float ns[DT][2];   // this row's outputs at the thread's columns, f32
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      ns[dt][0] = o[dt][2 * i] * inv;
      ns[dt][1] = o[dt][2 * i + 1] * inv;
    }
    if constexpr (EPI) {
      // this row of the residual tile (zero past sq), at the columns the
      // thread writes
      const T* rrow = qs + (warp * 16 + g + 8 * i) * LD + 2 * t;
      float ss = 0.f;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const float2 r = unpack2<BF16>(ld32(rrow + dt * 8));
        ns[dt][0] += r.x;
        ns[dt][1] += r.y;
        ss += ns[dt][0] * ns[dt][0] + ns[dt][1] * ns[dt][1];
      }
      // the row's other columns live in the quad's other three lanes; all
      // 32 lanes reach these shuffles (no lane has left the loop)
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float rs = rsqrtf(ss / float(rms_d) + eps);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const float2 w = *reinterpret_cast<const float2*>(
            gamma + dt * 8 + 2 * t);
        ns[dt][0] *= rs * w.x;
        ns[dt][1] *= rs * w.y;
      }
    }
    if (!valid) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(out + row_off + dt * 8) =
          pack2<BF16>(ns[dt][0], ns[dt][1]);
    if (t == 0) lse[size_t(bh) * sq + rows[i]] = m[i] + logf(lsafe);
  }
}

template <int D, bool BF16, bool EPI>
int launch(const void* q, const void* k, const void* v, const void* residual,
           const float* gamma, void* out, void* lse, int bh, int sq, int sk,
           int q_per_kv, int causal, float scale, float eps, int rms_d,
           cudaStream_t stream) {
  using T = typename Elem<BF16>::T;
  const size_t smem = size_t(BLOCK_M + 2 * BLOCK_N) * (D + PAD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BF16, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(bh, (sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<D, BF16, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(residual), gamma,
      static_cast<T*>(out), static_cast<float*>(lse), sq, sk, q_per_kv,
      causal, scale, eps, rms_d);
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
                                           scale, eps, rms_d, s)
                   : launch<64, false, EPI>(q, k, v, residual, gamma, out,
                                            lse, bh, sq, sk, q_per_kv,
                                            causal, scale, eps, rms_d, s);
  if (d == 128)
    return is_bf16 ? launch<128, true, EPI>(q, k, v, residual, gamma, out,
                                            lse, bh, sq, sk, q_per_kv,
                                            causal, scale, eps, rms_d, s)
                   : launch<128, false, EPI>(q, k, v, residual, gamma, out,
                                             lse, bh, sq, sk, q_per_kv,
                                             causal, scale, eps, rms_d, s);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// K1. q (bh, sq, d), k/v (bh / q_per_kv, sk, d), out (bh, sq, d) in the
// input dtype, lse (bh, sq) f32; all contiguous on CUDA device `device`, d
// in {64, 128}. Launches on `stream` and returns the CUDA error code of the
// launch (0 on success).
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
