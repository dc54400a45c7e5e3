// K1's tensor-core flash-attention forward (flash_attn_fwd.cu, head_dim
// 16/32/64): O = softmax(Q K^T / sqrt(D)) V, non-causal, bf16 operands, f32
// accumulation, optional natural-log LSE.
//
// Design: one CTA of 4 warps per (b*h, 64-row Q tile); each warp owns 16 query
// rows and keeps its O accumulator and running max/sum in registers, so S and
// P never leave the SM. K/V tiles of 64 keys are double-buffered in dynamic
// shared memory with cp.async (rows padded by 16 bytes so fragment loads are
// free of bank conflicts). QK^T and PV run on tensor cores with mma.sync
// m16n8k16 bf16 -> f32; the S accumulator fragments are re-packed in
// registers as the A operand of PV; V's B fragments come from
// ldmatrix.trans. The softmax runs in the log2 domain with scale*log2(e)
// folded into the exponent. Keys past Nk are zero-filled by cp.async and
// masked to -inf in-kernel, so the host never pads. Operands are addressed
// through element strides for (b, n, h), so (B, N, H, D) tensors straight
// from the qkv projection go in without a transpose; O is written with its
// own strides.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace videogpa {
namespace flash_fwd {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per CTA
constexpr int kBlockN = 64;           // keys per K/V tile
constexpr int kTileRows = 64;         // rows moved by load_tile
static_assert(kBlockM == kTileRows && kBlockN == kTileRows, "tile loader shape");
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B, H, Nq) or nullptr
  int H, Nq, Nk;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
};

template <int D>
constexpr int smem_bytes() {
  // sQ[kBlockM] + sK[2][kBlockN] + sV[2][kBlockN] rows of D + 8 bf16
  return (kBlockM + 4 * kBlockN) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) kernel(const Params p) {
  constexpr int kStride = D + 8;  // +16 bytes per row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem[];
  auto sQ = reinterpret_cast<__nv_bfloat16(*)[kStride]>(smem);
  auto sK = reinterpret_cast<__nv_bfloat16(*)[kBlockN][kStride]>(
      smem + kBlockM * kStride * 2);
  auto sV = reinterpret_cast<__nv_bfloat16(*)[kBlockN][kStride]>(
      smem + (kBlockM + 2 * kBlockN) * kStride * 2);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int n_kv = (p.Nk + kBlockN - 1) / kBlockN;

  load_tile<D, kStride, kTileRows, kThreads>(sQ, q, p.q_sn, q0, p.Nq);
  load_tile<D, kStride, kTileRows, kThreads>(sK[0], k, p.k_sn, 0, p.Nk);
  load_tile<D, kStride, kTileRows, kThreads>(sV[0], v, p.v_sn, 0, p.Nk);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D, kStride, kTileRows, kThreads>(sK[st ^ 1], k, p.k_sn, (j + 1) * kBlockN, p.Nk);
      load_tile<D, kStride, kTileRows, kThreads>(sV[st ^ 1], v, p.v_sn, (j + 1) * kBlockN, p.Nk);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        qf[kk][0] = lds32(&sQ[r0][c]);
        qf[kk][1] = lds32(&sQ[r0 + 8][c]);
        qf[kk][2] = lds32(&sQ[r0][c + 8]);
        qf[kk][3] = lds32(&sQ[r0 + 8][c + 8]);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        const uint32_t b0 = lds32(&sK[st][nt * 8 + g][c]);
        const uint32_t b1 = lds32(&sK[st][nt * 8 + g][c + 8]);
        mma_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // online softmax; elements 0,1 belong to row r0, elements 2,3 to row r0 + 8
    const int key0 = j * kBlockN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + tig * 2 + (e & 1);
        const float t = key < p.Nk ? s[nt][e] * p.scale_log2 : -INFINITY;
        s[nt][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key0 < Nk, so every row has a finite max in this tile
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk; ldmatrix.trans turns row-major V into B fragments.
    const int mi = lane / 8;
    const int mr = lane % 8;
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sV[st][kk * 16 + mr + 8 * (mi & 1)][dp * 16 + 8 * (mi >> 1)]);
        mma_16816(acc[2 * dp], a, bv[0], bv[1]);
        mma_16816(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // buffer st is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Nq) continue;
    __nv_bfloat16* orow = o + rows[i] * p.o_sn;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][2 * i] * inv[i], acc[dt][2 * i + 1] * inv[i]);
    }
    if (p.lse != nullptr && tig == 0) {
      p.lse[static_cast<long long>(bh) * p.Nq + rows[i]] = (m_run[i] + log2f(l_run[i])) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static_assert(bytes <= 48 * 1024, "dynamic shared memory above 48 KB needs an opt-in");
  const dim3 grid((p.Nq + kBlockM - 1) / kBlockM, B * p.H);
  kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Fill Params from the C entry points' flat argument list.
inline Params make_params(const void* q, const void* k, const void* v, void* o, void* lse,
                          int H, int Nq, int Nk, const long long* strides, float scale_log2) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = strides[0]; p.q_sn = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_sn = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_sn = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_sh = strides[11];
  p.scale_log2 = scale_log2;
  return p;
}

}  // namespace flash_fwd
}  // namespace videogpa
