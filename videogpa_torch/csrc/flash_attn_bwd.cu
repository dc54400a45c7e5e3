// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T / sqrt(D)) V, non-causal, bf16 operands, f32 accumulation.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py
// `_dq_kernel_T` and `_dkv_kernel_T` (the head_dim < 128 backward of
// `_flash_bwd_T`). Same function, recomputed from the forward's natural-log
// LSE and delta = rowsum(O * dO), which the caller computes:
//   P  = exp(S - LSE),  S = Q K^T / sqrt(D)
//   dV = P^T dO
//   dS = P * (dO V^T - delta)
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// Keys >= Nk and queries >= Nq get P = 0, so they contribute nothing and their
// gradient rows are never stored. P and dS are rounded to bf16 before their
// products, as the TPU kernels round them.
//
// Bound: tensor-core operations. The function needs five N x N x D products
// per head, 10*B*H*Nq*Nk*D FLOPs; at the CogVideoX-5B training shape
// (B=1, N=17,776, H=48, D=64) that is 9.71 TFLOP, 9.8 ms at the 989 TFLOP/s
// bf16 dense peak, while its ~0.6 GB of operands and gradients need ~0.2 ms
// at 3.35 TB/s.
// Design: two kernels, as on the TPU, with no atomics, so the result is
// deterministic. The dK/dV kernel runs one CTA of 4 warps per (b*h, 64-key
// tile); each warp owns 16 keys, keeps their K and V fragments and its dK/dV
// accumulators in registers, and loops over 64-query tiles of Q and dO
// double-buffered in shared memory with cp.async. The dQ kernel runs one CTA
// per (b*h, 64-query tile) and loops over 64-key tiles of K and V the same way.
// Both recompute S and dP (7 products instead of 5): the cost of keeping
// every accumulator in registers without atomics. Products run on mma.sync
// m16n8k16 bf16 -> f32; accumulators are re-packed in registers as the A
// operand of the next product; row-major tiles become B fragments through
// ldmatrix.trans. The softmax is recomputed in the log2 domain with
// D^-0.5*log2(e) folded into the exponent and the LSE converted to base 2 on
// load. Operands are addressed through element strides for (b, n, h), so
// (B, N, H, D) and (B, H, N, D) tensors go in without a copy.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace videogpa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = 16 * kWarps;  // rows of every tile: queries or keys
static_assert(kThreads == 2 * kBlock, "load_row_stats gives one thread per row and stat");
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // (B*H, Nq) natural-log logsumexp of the scaled scores
  const float* delta;  // (B*H, Nq) rowsum(O * dO)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Nq, Nk;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 * log2(e)
};

// LSE (as base 2) and delta of query rows [row0, row0 + kBlock) into shared
// memory; rows >= n_rows read as zero.
__device__ __forceinline__ void load_row_stats(float* s_lse2, float* s_delta, const float* lse,
                                               const float* delta, int row0, int n_rows) {
  const int t = threadIdx.x % kBlock;
  const int row = row0 + t;
  if (threadIdx.x < kBlock) {
    s_lse2[t] = row < n_rows ? lse[row] * kLog2e : 0.f;
  } else {
    s_delta[t] = row < n_rows ? delta[row] : 0.f;
  }
}

// A fragments (16 rows of this warp x D) of a padded shared tile.
template <int D, int kStride>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16 (*tile)[kStride], int r0,
                                             int tig) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    f[kk][0] = lds32(&tile[r0][c]);
    f[kk][1] = lds32(&tile[r0 + 8][c]);
    f[kk][2] = lds32(&tile[r0][c + 8]);
    f[kk][3] = lds32(&tile[r0 + 8][c + 8]);
  }
}

// acc (16 x 64) = A (16 x D, fragments) * tile^T, tile = 64 rows x D in shared.
template <int D, int kStride>
__device__ __forceinline__ void mma_a_tileT(float (&acc)[kBlock / 8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16 (*tile)[kStride], int g,
                                            int tig) {
#pragma unroll
  for (int nt = 0; nt < kBlock / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      const uint32_t b0 = lds32(&tile[nt * 8 + g][c]);
      const uint32_t b1 = lds32(&tile[nt * 8 + g][c + 8]);
      mma_16816(acc[nt], a[kk], b0, b1);
    }
  }
}

// out (16 x D) += bf16(x) (16 x 64, accumulator layout) * tile (64 x D).
template <int D, int kStride>
__device__ __forceinline__ void mma_acc_tile(float (&out)[D / 8][4],
                                             const float (&x)[kBlock / 8][4],
                                             const __nv_bfloat16 (*tile)[kStride], int lane) {
  const int mi = lane / 8;
  const int mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, &tile[kk * 16 + mr + 8 * (mi & 1)][dp * 16 + 8 * (mi >> 1)]);
      mma_16816(out[2 * dp], a, bt[0], bt[1]);
      mma_16816(out[2 * dp + 1], a, bt[2], bt[3]);
    }
  }
}

// Rows `row` and `row + 8` of a 16 x D accumulator, times `mul`, as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (&acc)[D / 8][4], int row, int n_rows,
                                           int tig, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n_rows) continue;
    __nv_bfloat16* out = base + r * row_stride;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_bwd_dkv_kernel(const Params p) {
  constexpr int kStride = D + 8;  // +16 bytes per row: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 sQ[2][kBlock][kStride];
  __shared__ __align__(16) __nv_bfloat16 sdO[2][kBlock][kStride];
  __shared__ float sLse2[2][kBlock];
  __shared__ float sDelta[2][kBlock];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's keys in the tile: r0, r0 + 8

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Nq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Nq;
  const int n_q = (p.Nq + kBlock - 1) / kBlock;

  // prologue: this CTA's K and V tiles go through buffer 1, which is free
  // until the first prefetch; query tile 0 goes to buffer 0
  load_tile<D, kStride, kBlock, kThreads>(sQ[1], k, p.k_sn, k0, p.Nk);
  load_tile<D, kStride, kBlock, kThreads>(sdO[1], v, p.v_sn, k0, p.Nk);
  load_tile<D, kStride, kBlock, kThreads>(sQ[0], q, p.q_sn, 0, p.Nq);
  load_tile<D, kStride, kBlock, kThreads>(sdO[0], dout, p.do_sn, 0, p.Nq);
  cp_async_commit();
  load_row_stats(sLse2[0], sDelta[0], lse, delta, 0, p.Nq);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  load_a_frags<D, kStride>(kf, sQ[1], r0, tig);
  load_a_frags<D, kStride>(vf, sdO[1], r0, tig);
  __syncthreads();  // buffer 1 is refilled by the first prefetch

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const bool key_ok[2] = {k0 + r0 < p.Nk, k0 + r0 + 8 < p.Nk};

  for (int i = 0; i < n_q; ++i) {
    const int st = i & 1;
    if (i + 1 < n_q) {
      load_tile<D, kStride, kBlock, kThreads>(sQ[st ^ 1], q, p.q_sn, (i + 1) * kBlock, p.Nq);
      load_tile<D, kStride, kBlock, kThreads>(sdO[st ^ 1], dout, p.do_sn, (i + 1) * kBlock,
                                              p.Nq);
      load_row_stats(sLse2[st ^ 1], sDelta[st ^ 1], lse, delta, (i + 1) * kBlock, p.Nq);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();

    // P^T = exp2(S^T * scale * log2(e) - LSE2), S^T = K Q^T: 16 keys x 64 queries
    float s[kBlock / 8][4];
    mma_a_tileT<D, kStride>(s, kf, sQ[st], g, tig);
    const int qbase = i * kBlock;
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const bool ok = key_ok[e >> 1] && qbase + col < p.Nq;
        s[nt][e] = ok ? exp2f(fmaf(s[nt][e], p.scale_log2, -sLse2[st][col])) : 0.f;
      }
    }
    // dV += P^T dO
    mma_acc_tile<D, kStride>(dv, s, sdO[st], lane);
    // dS^T = P^T * (dP^T - delta), dP^T = V dO^T
    float dpt[kBlock / 8][4];
    mma_a_tileT<D, kStride>(dpt, vf, sdO[st], g, tig);
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= dpt[nt][e] - sDelta[st][nt * 8 + tig * 2 + (e & 1)];
      }
    }
    // dK += dS^T Q (scaled by D^-0.5 at the store)
    mma_acc_tile<D, kStride>(dk, s, sQ[st], lane);
    __syncthreads();  // buffer st is refilled by the next iteration's prefetch
  }

  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, k0 + r0, p.Nk, tig, p.scale);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, k0 + r0, p.Nk, tig, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_bwd_dq_kernel(const Params p) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlock][kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlock][kStride];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's queries in the tile: r0, r0 + 8

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Nq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Nq;
  const int n_kv = (p.Nk + kBlock - 1) / kBlock;

  // prologue: this CTA's Q and dO tiles go through buffer 1, key tile 0 to
  // buffer 0
  load_tile<D, kStride, kBlock, kThreads>(sK[1], q, p.q_sn, q0, p.Nq);
  load_tile<D, kStride, kBlock, kThreads>(sV[1], dout, p.do_sn, q0, p.Nq);
  load_tile<D, kStride, kBlock, kThreads>(sK[0], k, p.k_sn, 0, p.Nk);
  load_tile<D, kStride, kBlock, kThreads>(sV[0], v, p.v_sn, 0, p.Nk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  uint32_t df[D / 16][4];
  load_a_frags<D, kStride>(qf, sK[1], r0, tig);
  load_a_frags<D, kStride>(df, sV[1], r0, tig);
  __syncthreads();

  float lse2[2];
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse2[i] = row < p.Nq ? lse[row] * kLog2e : 0.f;
    dl[i] = row < p.Nq ? delta[row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D, kStride, kBlock, kThreads>(sK[st ^ 1], k, p.k_sn, (j + 1) * kBlock, p.Nk);
      load_tile<D, kStride, kBlock, kThreads>(sV[st ^ 1], v, p.v_sn, (j + 1) * kBlock, p.Nk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // P = exp2(S * scale * log2(e) - LSE2), S = Q K^T: 16 queries x 64 keys
    float s[kBlock / 8][4];
    mma_a_tileT<D, kStride>(s, qf, sK[st], g, tig);
    const int key0 = j * kBlock;
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + tig * 2 + (e & 1);
        s[nt][e] = key < p.Nk ? exp2f(fmaf(s[nt][e], p.scale_log2, -lse2[e >> 1])) : 0.f;
      }
    }
    // dS = P * (dP - delta), dP = dO V^T
    float dpm[kBlock / 8][4];
    mma_a_tileT<D, kStride>(dpm, df, sV[st], g, tig);
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dpm[nt][e] - dl[e >> 1];
    }
    // dQ += dS K (scaled by D^-0.5 at the store)
    mma_acc_tile<D, kStride>(acc, s, sK[st], lane);
    __syncthreads();
  }

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, q0 + r0, p.Nq, tig, p.scale);
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid_dkv((p.Nk + kBlock - 1) / kBlock, B * p.H);
  flash_attn_bwd_dkv_kernel<D><<<grid_dkv, kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((p.Nq + kBlock - 1) / kBlock, B * p.H);
  flash_attn_bwd_dq_kernel<D><<<grid_dq, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long do_sb,
    long long do_sn, long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh,
    long long dk_sb, long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,
    long long dv_sh, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_sn = do_sn; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
