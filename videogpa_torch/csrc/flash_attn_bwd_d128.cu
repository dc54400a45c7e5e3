// Flash-attention backward at head_dim 128 for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T / sqrt(D)) V, non-causal, bf16 operands, f32 accumulation.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py `_dq_kernel`
// and `_dkv_kernel` (:883, :908, called at :1110, :1131 from `_flash_bwd`
// :1089, the head_dim >= 128 backward that the Wan DiT's 24 x 128 heads train
// through). Same function, recomputed from the forward's natural-log LSE:
//   P  = exp(S - LSE),  S = Q K^T / sqrt(D)
//   dV = P^T dO
//   dS = P * (dO V^T - delta),  delta = rowsum(O * dO)
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D)
// P and dS are rounded to bf16 before their products, as the TPU kernels
// round them. Nq may differ from Nk (cross-attention).
//
// Bound: tensor-core operations. Five Nq x Nk x D products per head,
// 10*B*H*Nq*Nk*D FLOPs; at the Wan2.2-TI2V-5B self-attention shape
// (B=1, N=18,480, H=24, D=128) that is 10.49 TFLOP, 10.6 ms at the 989 TFLOP/s
// bf16 dense peak, against ~0.9 GB of operands and gradients (0.27 ms at
// 3.35 TB/s); at the cross-attention shape (Nq=18,480, Nk=512) 0.29 TFLOP,
// 0.29 ms.
//
// Design (the FlashAttention-3 backward: five products, each on wgmma):
//  - Prologue kernel: delta = rowsum(O * dO) in f32 and the base-2 LSE into
//    (B*H, Nq padded to 64) buffers (padded rows: LSE2 = +inf, so P = 0
//    there), and zeroes the f32 dQ accumulator.
//  - Main kernel, one CTA per (128-key tile, b*h, query split) on a flat
//    grid (key tile fastest, so any B*H fits) with one producer warpgroup
//    and two consumer warpgroups; setmaxnreg gives the consumers 232
//    registers and the producer 40. The producer loads the
//    key tile's K and V once by TMA (they stay in shared memory) and keeps a
//    2-stage mbarrier ring of 64-query tiles of Q and dO (TMA) with their
//    LSE2 and delta (bulk copies). Consumer warpgroup w owns keys
//    [64w, 64w + 64) of the tile; for each query tile:
//      S^T = K Q^T and dP^T = V dO^T                 wgmma SS, K-major
//      P^T = exp2(S^T * D^-0.5 log2 e - LSE2), dS^T = P^T (dP^T - delta)
//      dV += P^T dO, dK += dS^T Q                    wgmma RS: P^T and dS^T
//                                                    repacked to bf16 in
//                                                    registers, 128 f32
//                                                    accumulators a thread
//      dS^T to shared memory (bf16, 128-byte swizzle); named barrier
//      dQ[:, 64w:64w+64] = dS K[:, 64w:64w+64]       wgmma SS, MN-major
//      staged in shared memory (f32, in accumulator-fragment order) and
//      added into the f32 dQ accumulator by one bulk reduce-add
//      (cp.reduce.async.bulk .add.f32) of 16 KB; the accumulator holds each
//      (head, query tile, 64-column half) as such a contiguous block, and
//      per-thread float2 atomics cost a quarter of the kernel's time here.
//    Keys >= Nk (rows TMA zero-fills) get P = 0 by a mask; queries >= Nq get
//    P = 0 through their LSE2 = +inf.
//  - Epilogue: dQ from f32 to bf16 with D^-0.5 applied, through the
//    wrapper's strides. dK and dV are stored by the main kernel (scaled,
//    bf16) when there is one query split; with several (the cross shape, Nk
//    = 512: 4 key tiles x 24 heads = 96 CTAs < 132 SMs, so the query range
//    is split until the grid has >= 2 x 132 CTAs), each split writes f32
//    partials and the epilogue sums them in split order, so dK and dV stay
//    deterministic.
//  - dQ is not deterministic: the bulk reduce-adds sum the key tiles'
//    partials in the order the CTAs reach them, so its last bits vary from
//    run to run.
//    The TPU kernels and this kernel's earlier two-kernel design (seven
//    products: S and dP recomputed) were deterministic.
//  - Shared memory, 1,024-byte aligned: K 32 KB + V 32 KB (two 64-column
//    halves each, 128-byte swizzle) + Q and dO 2 x 2 x 16 KB + dS^T 2 x 16 KB
//    (double-buffered, so one named barrier a tile suffices) + dQ staging
//    2 x 16 KB + LSE2 / delta = 193 KB: one CTA an SM.
// Operands are addressed through rank-4 tensor maps over (D, N, H, B) with
// element strides, so (B, N, H, D) and (B, H, N, D) views go in without a
// copy.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace videogpa::sm90;

constexpr int kD = 128;
constexpr int kBlockN = 128;  // keys per CTA, 64 per consumer warpgroup
constexpr int kBlockM = 64;   // queries per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout (bytes from the 1,024-aligned base)
constexpr int kHalfK = kBlockN * 128;  // one 64-column half of K or V: 16 KB
constexpr int kHalfQ = kBlockM * 128;  // one 64-column half of Q or dO: 8 KB
constexpr int kTileQ = 2 * kHalfQ;
constexpr int kTileDS = kBlockN * kBlockM * 2;  // dS^T, [key][query]: 16 KB
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + 2 * kHalfK;
constexpr int kOffQ = kOffV + 2 * kHalfK;
constexpr int kOffDO = kOffQ + kStages * kTileQ;
constexpr int kOffDS = kOffDO + kStages * kTileQ;
constexpr int kTileDQ = kBlockM * 64 * 4;  // one warpgroup's dQ block, f32: 16 KB
constexpr int kOffDQ = kOffDS + 2 * kTileDS;
constexpr int kOffLse = kOffDQ + 2 * kTileDQ;
constexpr int kOffDelta = kOffLse + kStages * kBlockM * 4;
constexpr int kOffBar = kOffDelta + kStages * kBlockM * 4;
// barriers: K/V full, Q/dO full[kStages], Q/dO empty[kStages]
constexpr int kSmemBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
constexpr uint32_t kTxKV = 4 * kHalfK;
constexpr uint32_t kTxQ = 2 * kTileQ + 2 * kBlockM * 4;

struct Params {
  const float* lse2;   // (B*H, Nq_pad) base-2 LSE, +inf on padded rows
  const float* delta;  // (B*H, Nq_pad)
  float* dq_acc;       // (B*H, Nq_pad / 64, 2, 64 * 64) f32 blocks in fragment
                       // order (dq_block_offset), zeroed by the prologue
  float* dk_part;      // (splits, B*H, Nk_pad, D) f32 when splits > 1
  float* dv_part;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, BH, Nq, Nk, Nq_pad, Nk_pad, n_kt, splits, tiles_per_split;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 * log2(e)
};

// K-major 128-byte-swizzled operand (rows of 64 bf16): 8-row atoms 1 KB apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 1024, kSwizzle128);
}
// MN-major 128-byte-swizzled operand: 8 reduction rows a 1 KB group, the
// 64-column halves `lbo` bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 1024, kSwizzle128);
}

// Offset (floats) of element (row, col) within one 64 x 64 dQ block: the
// order in which a warpgroup's threads hold the accumulator, so that each
// thread stages float2s at consecutive addresses (j: 8-column group, w: warp,
// r: row half, lane).
__host__ __device__ __forceinline__ int dq_block_offset(int row, int col) {
  const int w = row / 16, r = (row % 16) / 8, g = row % 8;
  const int j = col / 8, t = (col % 8) / 2, e = col % 2;
  return ((((j * 4 + w) * 2 + r) * 32 + 4 * g + t) * 2) + e;
}

// ---- prologue: delta, LSE2, dQ accumulator ----
__global__ void __launch_bounds__(256) flash_attn_bwd_d128_prologue(
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, float* lse2,
    float* delta, float* dq_acc, int H, int Nq, int Nq_pad, long long o_sb, long long o_sn,
    long long o_sh, long long do_sb, long long do_sn, long long do_sh) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int bh = static_cast<int>(row / Nq_pad);
  const int q = static_cast<int>(row % Nq_pad);
  const int b = bh / H;
  const int h = bh % H;
  float d = 0.f;
  if (q < Nq) {
    const uint2 ov = *reinterpret_cast<const uint2*>(o + b * o_sb + q * o_sn + h * o_sh + 4 * lane);
    const uint2 dv =
        *reinterpret_cast<const uint2*>(dout + b * do_sb + q * do_sn + h * do_sh + 4 * lane);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 c = __bfloat1622float2(d2[i]);
      d = fmaf(a.x, c.x, d);
      d = fmaf(a.y, c.y, d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  if (lane == 0) {
    lse2[row] = q < Nq ? lse[static_cast<long long>(bh) * Nq + q] * kLog2e : INFINITY;
    delta[row] = d;
  }
  reinterpret_cast<float4*>(dq_acc + row * kD)[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- main kernel ----
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_d128_main(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // flattened grid: key tile fastest, then b*h, then the query split
  const int k_tile = static_cast<int>(blockIdx.x % p.n_kt);
  const int rest = static_cast<int>(blockIdx.x / p.n_kt);
  const int bh = rest % p.BH;
  const int split = rest / p.BH;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = k_tile * kBlockN;
  const int n_qt = p.Nq_pad / kBlockM;
  const int qt_begin = split * p.tiles_per_split;
  const int qt_end = min(n_qt, qt_begin + p.tiles_per_split);
  const int n_it = max(0, qt_end - qt_begin);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy ----
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&tdo);
      mbar_arrive_expect_tx(kv_full, kTxKV);
      for (int half = 0; half < 2; ++half) {
        tma_load_4d(smem + kOffK + half * kHalfK, &tk, kv_full, 64 * half, k0, h, b);
        tma_load_4d(smem + kOffV + half * kHalfK, &tv, kv_full, 64 * half, k0, h, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (qt_begin + it) * kBlockM;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], kTxQ);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(smem + kOffQ + s * kTileQ + half * kHalfQ, &tq, &full[s], 64 * half, q0, h,
                      b);
          tma_load_4d(smem + kOffDO + s * kTileQ + half * kHalfQ, &tdo, &full[s], 64 * half, q0,
                      h, b);
        }
        const long long stat = static_cast<long long>(bh) * p.Nq_pad + q0;
        bulk_load(smem + kOffLse + s * kBlockM * 4, p.lse2 + stat, kBlockM * 4, &full[s]);
        bulk_load(smem + kOffDelta + s * kBlockM * 4, p.delta + stat, kBlockM * 4, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  reg_alloc<232>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;  // rows row, row + 8 of this warpgroup's 64
  const int col = 2 * (lane % 4);        // columns col, col + 1 of every 8
  const int key_lo = 64 * wg + row;      // this thread's keys in the tile: key_lo, key_lo + 8
  const bool key_ok[2] = {k0 + key_lo < p.Nk, k0 + key_lo + 8 < p.Nk};

  const uint32_t k_addr = smem_u32(smem + kOffK);
  const uint32_t v_addr = smem_u32(smem + kOffV);

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const uint32_t q_addr = smem_u32(smem + kOffQ + s * kTileQ);
    const uint32_t do_addr = smem_u32(smem + kOffDO + s * kTileQ);
    const float* s_lse2 = reinterpret_cast<const float*>(smem + kOffLse + s * kBlockM * 4);
    const float* s_delta = reinterpret_cast<const float*>(smem + kOffDelta + s * kBlockM * 4);

    // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
    float st[kBlockM / 2], dpt[kBlockM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalfK + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kHalfQ + (kk % 4) * 32;
      wgmma_ss<kBlockM, 0, 0>(st, desc_k(k_addr + off), desc_k(q_addr + qoff), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kHalfK + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kHalfQ + (kk % 4) * 32;
      wgmma_ss<kBlockM, 0, 0>(dpt, desc_k(v_addr + off), desc_k(do_addr + qoff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T and dS^T; columns are queries of the tile
#pragma unroll
    for (int i = 0; i < kBlockM / 2; ++i) {
      const int c = 8 * (i / 4) + col + (i & 1);
      const float pe =
          key_ok[(i >> 1) & 1] ? exp2f(fmaf(st[i], p.scale_log2, -s_lse2[c])) : 0.f;
      st[i] = pe;
      dpt[i] = pe * (dpt[i] - s_delta[c]);
    }
    uint32_t pa[kBlockM / 16][4], dsa[kBlockM / 16][4];
    acc_to_a<kBlockM>(pa, st);
    acc_to_a<kBlockM>(dsa, dpt);

    // dV += P^T dO, dK += dS^T Q: B operands MN-major, d halves 8 KB apart
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      wgmma_rs<kD, 1>(dv, pa[kk], desc_mn(do_addr + kk * 16 * 128, kHalfQ), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      wgmma_rs<kD, 1>(dk, dsa[kk], desc_mn(q_addr + kk * 16 * 128, kHalfQ), 1);
    }
    wgmma_commit();

    // dS^T (bf16) into shared memory as [key][query], 128-byte swizzled
    uint8_t* ds_tile = smem + kOffDS + (it & 1) * kTileDS;
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_lo + 8 * r;
        const int chunk = j ^ (key & 7);
        *reinterpret_cast<uint32_t*>(ds_tile + key * 128 + chunk * 16 + col * 2) =
            dsa[j / 2][(j & 1) * 2 + r];
      }
    }
    fence_proxy_async();
    named_barrier_sync<kConsumers>(1);

    // dQ[:, 64 wg : 64 wg + 64] = dS K[:, 64 wg : 64 wg + 64]: A = dS (queries x
    // keys) read MN-major from dS^T, B = this half of K read MN-major
    float dq[kBlockM / 2];
    const uint32_t ds_addr = smem_u32(ds_tile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_ss<64, 1, 1>(dq, desc_mn(ds_addr + kk * 16 * 128, kTileDS),
                         desc_mn(k_addr + wg * kHalfK + kk * 16 * 128, kHalfK), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(&empty[s]);  // Q, dO, LSE2 and delta of this stage are read

    // stage dQ (f32) and add it into this (query tile, half) block of the
    // accumulator with one bulk reduce-add
    float* stage = reinterpret_cast<float*>(smem + kOffDQ + wg * kTileDQ);
    if (threadIdx.x % 128 == 0) bulk_wait_all<true>();  // the last reduce read the stage
    named_barrier_sync<128>(2 + wg);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(stage + dq_block_offset(row + 8 * r, 8 * j + col)) =
            make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync<128>(2 + wg);
    if (threadIdx.x % 128 == 0) {
      const long long block =
          (static_cast<long long>(bh) * (p.Nq_pad / kBlockM) + qt_begin + it) * 2 + wg;
      bulk_reduce_add_f32(p.dq_acc + block * (kBlockM * 64), stage, kTileDQ);
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait_all<false>();

  // dK (scaled) and dV: bf16 through the strides, or f32 partials of this split
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + key_lo + 8 * r;
    if (key >= p.Nk) continue;
    if (p.splits == 1) {
      __nv_bfloat16* dkr = p.dk + b * p.dk_sb + key * p.dk_sn + h * p.dk_sh;
      __nv_bfloat16* dvr = p.dv + b * p.dv_sb + key * p.dv_sn + h * p.dv_sh;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * j + col) =
            pack_bf16(dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + 8 * j + col) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    } else {
      const long long off =
          ((static_cast<long long>(split) * p.BH + bh) * p.Nk_pad + key) * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<float2*>(p.dk_part + off + 8 * j + col) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(p.dv_part + off + 8 * j + col) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---- epilogue: one warp a row, four columns a lane ----
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x, float mul) {
  uint2 v;
  v.x = pack_bf16(x.x * mul, x.y * mul);
  v.y = pack_bf16(x.z * mul, x.w * mul);
  *reinterpret_cast<uint2*>(dst) = v;
}

__global__ void __launch_bounds__(256)
    flash_attn_bwd_d128_dq(const float* dq_acc, __nv_bfloat16* dq, int H, int Nq, int Nq_pad,
                           long long rows, long long sb, long long sn, long long sh, float scale) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = static_cast<int>(row / Nq);
  const int q = static_cast<int>(row % Nq);
  const int half = lane / 16;
  const long long block =
      (static_cast<long long>(bh) * (Nq_pad / kBlockM) + q / kBlockM) * 2 + half;
  // columns 4*lane .. 4*lane + 3 are four consecutive floats of the block
  const float4 x = *reinterpret_cast<const float4*>(
      dq_acc + block * (kBlockM * 64) + dq_block_offset(q % kBlockM, 4 * (lane % 16)));
  store4(dq + (bh / H) * sb + q * sn + (bh % H) * sh + 4 * lane, x, scale);
}

__global__ void __launch_bounds__(256) flash_attn_bwd_d128_dkv_sum(
    const float* dk_part, const float* dv_part, __nv_bfloat16* dk, __nv_bfloat16* dv, int H,
    int Nk, int Nk_pad, int splits, long long rows, long long dk_sb, long long dk_sn,
    long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh, float scale) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = static_cast<int>(row / Nk);
  const int key = static_cast<int>(row % Nk);
  const long long split_stride = rows / Nk * Nk_pad * kD;
  const long long off = (static_cast<long long>(bh) * Nk_pad + key) * kD + 4 * lane;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int z = 0; z < splits; ++z) {  // fixed order: deterministic
    const float4 a = *reinterpret_cast<const float4*>(dk_part + z * split_stride + off);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + z * split_stride + off);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  const int b = bh / H;
  const int h = bh % H;
  store4(dk + b * dk_sb + key * dk_sn + h * dk_sh + 4 * lane, sk, scale);
  store4(dv + b * dv_sb + key * dv_sn + h * dv_sh + 4 * lane, sv, 1.f);
}

unsigned int blocks_for(long long rows) { return static_cast<unsigned int>((rows + 7) / 8); }

}  // namespace

extern "C" int videogpa_flash_attn_bwd_d128(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* lse2, void* delta, void* dq_acc,
    void* dk_part, void* dv_part, int B, int H, int Nq, int Nk, int D, int splits,
    int tiles_per_split, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, long long do_sb, long long do_sn,
    long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb,
    long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh,
    float scale, void* stream) {
  if (D != kD || splits < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  const int n_qt = (Nq + kBlockM - 1) / kBlockM;
  const int n_kt = (Nk + kBlockN - 1) / kBlockN;
  if (static_cast<long long>(splits - 1) * tiles_per_split >= n_qt ||
      static_cast<long long>(splits) * tiles_per_split < n_qt) {
    return cudaErrorInvalidValue;  // every split non-empty, every query tile covered
  }

  Params p;
  p.lse2 = static_cast<const float*>(lse2);
  p.delta = static_cast<const float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dk_part = static_cast<float*>(dk_part);
  p.dv_part = static_cast<float*>(dv_part);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.BH = BH;
  p.Nq = Nq;
  p.Nk = Nk;
  p.Nq_pad = n_qt * kBlockM;
  p.Nk_pad = n_kt * kBlockN;
  p.n_kt = n_kt;
  p.splits = splits;
  p.tiles_per_split = tiles_per_split;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;

  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = make_tensor_map(&tq, q, kD, Nq, H, B, q_sn, q_sh, q_sb, 64, kBlockM, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tdo, dout, kD, Nq, H, B, do_sn, do_sh, do_sb, 64, kBlockM, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, kD, Nk, H, B, k_sn, k_sh, k_sb, 64, kBlockN, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, kD, Nk, H, B, v_sn, v_sh, v_sb, 64, kBlockN, swz);
  if (err != cudaSuccess) return err;

  const long long pro_rows = static_cast<long long>(BH) * p.Nq_pad;
  flash_attn_bwd_d128_prologue<<<blocks_for(pro_rows), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2), static_cast<float*>(delta),
      p.dq_acc, H, Nq, p.Nq_pad, o_sb, o_sn, o_sh, do_sb, do_sn, do_sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_attn_bwd_d128_main,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(n_kt) * BH * splits;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_bwd_d128_main<<<static_cast<unsigned int>(ctas), kThreads, kSmemBytes, st>>>(
      tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long dq_rows = static_cast<long long>(BH) * Nq;
  flash_attn_bwd_d128_dq<<<blocks_for(dq_rows), 256, 0, st>>>(
      p.dq_acc, static_cast<__nv_bfloat16*>(dq), H, Nq, p.Nq_pad, dq_rows, dq_sb, dq_sn, dq_sh,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  const long long kv_rows = static_cast<long long>(BH) * Nk;
  flash_attn_bwd_d128_dkv_sum<<<blocks_for(kv_rows), 256, 0, st>>>(
      p.dk_part, p.dv_part, p.dk, p.dv, H, Nk, p.Nk_pad, splits, kv_rows, dk_sb, dk_sn, dk_sh,
      dv_sb, dv_sn, dv_sh, scale);
  return cudaGetLastError();
}

// The main kernel's registers a thread at launch (ptxas; setmaxnreg then
// moves the consumers to 232) and its dynamic shared memory a CTA, for
// reports.
extern "C" int videogpa_flash_attn_bwd_d128_attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_attn_bwd_d128_main);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = kSmemBytes;
  }
  return err;
}
