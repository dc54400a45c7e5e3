// Flash-attention backward at head_dim 128 for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T / sqrt(D)) V, non-causal, bf16 operands, f32 accumulation.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py `_dq_kernel`
// and `_dkv_kernel` (the head_dim >= 128 backward of `_flash_bwd`, which the
// Wan DiT's 24 x 128 heads train through). Same function, recomputed from the
// forward's natural-log LSE and delta = rowsum(O * dO), which the caller
// computes:
//   P  = exp(S - LSE),  S = Q K^T / sqrt(D)
//   dV = P^T dO
//   dS = P * (dO V^T - delta)
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// Keys >= Nk and queries >= Nq get P = 0, so they contribute nothing and their
// gradient rows are never stored. P and dS are rounded to bf16 before their
// products, as the TPU kernels round them.
//
// Bound: tensor-core operations. Five Nq x Nk x D products per head,
// 10*B*H*Nq*Nk*D FLOPs; at the Wan2.2-TI2V-5B self-attention shape
// (B=1, N=18,480, H=24, D=128) that is 10.49 TFLOP, 10.6 ms at the 989 TFLOP/s
// bf16 dense peak, against ~0.9 GB of operands and gradients (0.27 ms at
// 3.35 TB/s); at the cross-attention shape (Nq=18,480, Nk=512) 0.29 TFLOP,
// 0.29 ms.
//
// Design: the two-kernel, atomics-free scheme of flash_attn_bwd.cu (so the
// result is deterministic), re-budgeted for D = 128, where that kernel's
// layout does not fit: its static shared tiles would need 68 KB and its dK/dV
// warp would hold 128 accumulator + 64 fragment + 64 score registers.
//  - Tiles live in dynamic shared memory (103 KB a CTA, two CTAs an SM): the
//    CTA's own pair of 64-row tiles (K and V in the dK/dV kernel, Q and dO in
//    the dQ kernel) stays resident there instead of in registers, and the
//    streamed pair is double-buffered with cp.async. A fragments of the own
//    tiles are read from shared memory at each use.
//  - The dK/dV kernel (one CTA per (b*h, 64-key tile), each warp 16 keys,
//    looping over 64-query tiles) walks each query tile in two halves of 32,
//    so the live S^T and dP^T fragments take 32 registers beside the 128
//    accumulators of dK and dV.
//  - The dQ kernel (one CTA per (b*h, 64-query tile), looping over 64-key
//    tiles) keeps 64 accumulators and full-width S and dP fragments.
// Both recompute S and dP (7 products instead of 5). Products run on mma.sync
// m16n8k16 bf16 -> f32; accumulators are re-packed in registers as the A
// operand of the next product; row-major tiles become B fragments through
// ldmatrix.trans. The softmax is recomputed in the log2 domain with
// D^-0.5*log2(e) folded into the exponent and the LSE converted to base 2 on
// load. Operands are addressed through element strides for (b, n, h), so
// (B, N, H, D) and (B, H, N, D) views go in without a copy, and Nq may differ
// from Nk (cross-attention).
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace videogpa;

constexpr int kD = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlock = 16 * kWarps;  // rows of every tile: queries or keys
constexpr int kHalf = kBlock / 2;    // queries per pass of the dK/dV kernel
constexpr int kStride = kD + 8;      // +16 bytes per row: conflict-free fragment loads
constexpr int kTileBytes = kBlock * kStride * 2;
// own pair + double-buffered streamed pair, then LSE and delta of two stages
constexpr int kSmemBytes = 6 * kTileBytes + 4 * kBlock * 4;
static_assert(kThreads == 2 * kBlock, "load_row_stats gives one thread per row and stat");
constexpr float kLog2e = 1.4426950408889634f;

using Tile = __nv_bfloat16 (*)[kStride];

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

__device__ __forceinline__ Tile tile_at(unsigned char* smem, int i) {
  return reinterpret_cast<Tile>(smem + i * kTileBytes);
}

__device__ __forceinline__ void load(Tile dst, const __nv_bfloat16* base, long long row_stride,
                                     int row0, int n_rows) {
  load_tile<kD, kStride, kBlock, kThreads>(dst, base, row_stride, row0, n_rows);
}

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

// acc (16 x 8*NT) = own[r0, r0 + 8 ; :] * tile[c0 .. c0 + 8*NT ; :]^T, both
// operands read from shared memory; r0 is this thread's first row.
template <int NT>
__device__ __forceinline__ void mma_rows_tileT(float (&acc)[NT][4], Tile own, Tile tile, int c0,
                                               int r0, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    uint32_t a[4];
    a[0] = lds32(&own[r0][c]);
    a[1] = lds32(&own[r0 + 8][c]);
    a[2] = lds32(&own[r0][c + 8]);
    a[3] = lds32(&own[r0 + 8][c + 8]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t b0 = lds32(&tile[c0 + nt * 8 + g][c]);
      const uint32_t b1 = lds32(&tile[c0 + nt * 8 + g][c + 8]);
      mma_16816(acc[nt], a, b0, b1);
    }
  }
}

// out (16 x D) += bf16(x) (16 x 8*NT, accumulator layout) * tile[c0 .. c0 + 8*NT ; :].
template <int NT>
__device__ __forceinline__ void mma_acc_tile(float (&out)[kD / 8][4], const float (&x)[NT][4],
                                             Tile tile, int c0, int lane) {
  const int mi = lane / 8;
  const int mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, &tile[c0 + kk * 16 + mr + 8 * (mi & 1)][dp * 16 + 8 * (mi >> 1)]);
      mma_16816(out[2 * dp], a, bt[0], bt[1]);
      mma_16816(out[2 * dp + 1], a, bt[2], bt[3]);
    }
  }
}

// Rows `row` and `row + 8` of a 16 x D accumulator, times `mul`, as bf16.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (&acc)[kD / 8][4], int row, int n_rows,
                                           int tig, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n_rows) continue;
    __nv_bfloat16* out = base + r * row_stride;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][2 * i] * mul, acc[dt][2 * i + 1] * mul);
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_attn_bwd_d128_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile sK = tile_at(smem, 0);
  const Tile sV = tile_at(smem, 1);
  // stage st of the streamed pair: Q at tile 2 + st, dO at tile 4 + st; its
  // LSE at stats + st * kBlock, its delta at stats + (2 + st) * kBlock
  float* stats = reinterpret_cast<float*>(smem + 6 * kTileBytes);

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

  load(sK, k, p.k_sn, k0, p.Nk);
  load(sV, v, p.v_sn, k0, p.Nk);
  load(tile_at(smem, 2), q, p.q_sn, 0, p.Nq);
  load(tile_at(smem, 4), dout, p.do_sn, 0, p.Nq);
  cp_async_commit();
  load_row_stats(stats, stats + 2 * kBlock, lse, delta, 0, p.Nq);

  float dk[kD / 8][4];
  float dv[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const bool key_ok[2] = {k0 + r0 < p.Nk, k0 + r0 + 8 < p.Nk};

  for (int i = 0; i < n_q; ++i) {
    const int st = i & 1;
    if (i + 1 < n_q) {
      const int nx = st ^ 1;
      load(tile_at(smem, 2 + nx), q, p.q_sn, (i + 1) * kBlock, p.Nq);
      load(tile_at(smem, 4 + nx), dout, p.do_sn, (i + 1) * kBlock, p.Nq);
      load_row_stats(stats + nx * kBlock, stats + (2 + nx) * kBlock, lse, delta,
                     (i + 1) * kBlock, p.Nq);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    const Tile sQ = tile_at(smem, 2 + st);
    const Tile sdO = tile_at(smem, 4 + st);
    const float* sLse2 = stats + st * kBlock;
    const float* sDelta = stats + (2 + st) * kBlock;

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kHalf) {
      // P^T = exp2(S^T * scale * log2(e) - LSE2), S^T = K Q^T: 16 keys x 32 queries
      float s[kHalf / 8][4];
      mma_rows_tileT<kHalf / 8>(s, sK, sQ, c0, r0, g, tig);
      const int qbase = i * kBlock + c0;
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);
          const bool ok = key_ok[e >> 1] && qbase + col < p.Nq;
          s[nt][e] = ok ? exp2f(fmaf(s[nt][e], p.scale_log2, -sLse2[c0 + col])) : 0.f;
        }
      }
      // dV += P^T dO
      mma_acc_tile<kHalf / 8>(dv, s, sdO, c0, lane);
      // dS^T = P^T * (dP^T - delta), dP^T = V dO^T
      float dpt[kHalf / 8][4];
      mma_rows_tileT<kHalf / 8>(dpt, sV, sdO, c0, r0, g, tig);
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] *= dpt[nt][e] - sDelta[c0 + nt * 8 + tig * 2 + (e & 1)];
        }
      }
      // dK += dS^T Q (scaled by D^-0.5 at the store)
      mma_acc_tile<kHalf / 8>(dk, s, sQ, c0, lane);
    }
    __syncthreads();  // buffer st is refilled by the next iteration's prefetch
  }

  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, k0 + r0, p.Nk, tig, p.scale);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, k0 + r0, p.Nk, tig, 1.f);
}

__global__ void __launch_bounds__(kThreads) flash_attn_bwd_d128_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile sQ = tile_at(smem, 0);
  const Tile sdO = tile_at(smem, 1);
  // stage st of the streamed pair: K at tile 2 + st, V at tile 4 + st

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

  load(sQ, q, p.q_sn, q0, p.Nq);
  load(sdO, dout, p.do_sn, q0, p.Nq);
  load(tile_at(smem, 2), k, p.k_sn, 0, p.Nk);
  load(tile_at(smem, 4), v, p.v_sn, 0, p.Nk);
  cp_async_commit();

  float lse2[2];
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    lse2[i] = row < p.Nq ? lse[row] * kLog2e : 0.f;
    dl[i] = row < p.Nq ? delta[row] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load(tile_at(smem, 2 + (st ^ 1)), k, p.k_sn, (j + 1) * kBlock, p.Nk);
      load(tile_at(smem, 4 + (st ^ 1)), v, p.v_sn, (j + 1) * kBlock, p.Nk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Tile sK = tile_at(smem, 2 + st);
    const Tile sV = tile_at(smem, 4 + st);

    // P = exp2(S * scale * log2(e) - LSE2), S = Q K^T: 16 queries x 64 keys
    float s[kBlock / 8][4];
    mma_rows_tileT<kBlock / 8>(s, sQ, sK, 0, r0, g, tig);
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
    mma_rows_tileT<kBlock / 8>(dpm, sdO, sV, 0, r0, g, tig);
#pragma unroll
    for (int nt = 0; nt < kBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dpm[nt][e] - dl[e >> 1];
    }
    // dQ += dS K (scaled by D^-0.5 at the store)
    mma_acc_tile<kBlock / 8>(acc, s, sK, 0, lane);
    __syncthreads();
  }

  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, acc, q0 + r0, p.Nq, tig, p.scale);
}

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_d128_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_d128_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((p.Nk + kBlock - 1) / kBlock, B * p.H);
  flash_attn_bwd_d128_dkv_kernel<<<grid_dkv, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((p.Nq + kBlock - 1) / kBlock, B * p.H);
  flash_attn_bwd_d128_dq_kernel<<<grid_dq, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_bwd_d128(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long do_sb,
    long long do_sn, long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh,
    long long dk_sb, long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,
    long long dv_sh, float scale, void* stream) {
  if (D != kD) return cudaErrorInvalidValue;
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
  return launch(p, B, static_cast<cudaStream_t>(stream));
}
