// Flash-attention forward where K1 does not apply (sm_90a):
// O = softmax(Q K^T / sqrt(D)) V, non-causal, optional natural-log LSE.
//
// Replaces the TPU Pallas kernel videogpa_tpu/ops/attention.py `_fwd_kernel`
// (:65, the classic online-softmax forward that the JAX package runs at
// head_dim >= 128; calls at :175 with LSE and :186 without, from `_flash_fwd`
// :126). Two entry points:
//
// 1. bf16, head_dim 128 (the Wan DiT's 24 x 128 heads: self-attention over
//    18,480 tokens and cross-attention to 512 text keys). Bound: tensor-core
//    operations, 4*B*H*Nq*Nk*D; at (1, 18,480, 24, 128) that is 4.20 TFLOP,
//    4.24 ms at the 989 TFLOP/s bf16 dense peak; at the cross shape (Nk 512)
//    0.116 TFLOP, 0.118 ms, against 19 MB of operands (5.6 us at 3.35 TB/s).
//    Design (the FlashAttention-3 forward without its ping-pong):
//     - A persistent grid of one CTA an SM walks the work items (128-query
//       tile, b*h) in order item = b*h * n_q_tiles + query tile, CTA c taking
//       items c, c + grid, ...: the SMs work on neighbouring query tiles of
//       one head at a time, so that head's K and V stay in L2, and any B*H
//       fits the grid.
//     - One producer warpgroup (setmaxnreg: 40 registers; one thread issues
//       every TMA copy) and two consumer warpgroups of 64 query rows each
//       (232 registers). The producer loads each item's Q tile once into one
//       of two Q buffers (so the next item's Q arrives while this item's last
//       tiles and its epilogue run) and streams 128-key tiles of K and V
//       through a 2-stage ring under full / empty mbarriers, continuing
//       across items. Head_dim 128 rows are 256 bytes: every tile is two
//       64-column boxes with a 128-byte swizzle.
//     - Each consumer warpgroup computes S = Q K^T on wgmma (both operands
//       K-major in shared memory, N = 128 keys), keeps its row max, row sum
//       and the 64 x 128 O accumulator in registers, runs an exact online
//       softmax in the log2 domain (D^-0.5 log2 e folded into one multiply,
//       exp2 as one flush-to-zero SFU instruction),
//       and O += P V on wgmma with P repacked to bf16 from the S accumulator
//       registers (A from registers) and V read MN-major, its two 64-column
//       halves an LBO apart. The two warpgroups run unsynchronised, so one's
//       softmax overlaps the other's products.
//     - Keys >= Nk are TMA's zero rows, masked to -inf (last tile only);
//       queries >= Nq are computed on TMA's zero rows and not stored. The
//       base-2 LSE (max + log2 of the row sum) is stored as the natural-log
//       LSE that K7 consumes, in the (B*H, Nq) layout.
//     - Shared memory: Q 2 x 32 KB + K 2 x 32 KB + V 2 x 32 KB = 193 KB with
//       the barriers: one CTA an SM.
//    Operands are addressed through rank-4 tensor maps over (D, N, H, B)
//    with element strides, so the (B, N, H, D) and (B, H, N, D) views of the
//    DiT's projections go in without a copy; O through its own strides.
//
// 2. float32, head_dim 16/32/64/128: the VGGT camera head's trunk
//    (dim 2048, 16 heads of 128) runs in f32, and so does the scorer's
//    reference-exact f32 mode, so the operands are never rounded to bf16 or
//    TF32. CUDA cores only: one warp per query row, each lane holding
//    ceil(D/32) strided elements of q, the O accumulator and the running
//    max/sum; for each key the warp reduces q.k with shuffles and updates an
//    exact online softmax in the log2 domain. At the camera head's shape
//    (B=4, 10 tokens, 16 heads, 128) a call moves 0.33 MB and does 1.3 MFLOP:
//    bound by bytes (0.1 us at 3.35 TB/s) and in practice by the launch.
//    The per-key warp reduction makes it slow for long rows: it is the
//    kernel for short f32 rows, not for the bf16 DiTs.
//
// Plain C interface (ctypes). Each entry returns cudaGetLastError() after
// its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace videogpa::sm90;

// ---- bf16, head_dim 128: wgmma + TMA ----
constexpr int kD = 128;
constexpr int kBlockM = 128;  // queries per work item, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kHalf = 128 * 128;  // one 64-column half of a 128-row tile: 16 KB
constexpr int kTile = 2 * kHalf;
constexpr int kOffQ = 0;  // two Q buffers
constexpr int kOffK = kOffQ + 2 * kTile;
constexpr int kOffV = kOffK + kStages * kTile;
constexpr int kOffBar = kOffV + kStages * kTile;
// barriers: Q full[2], Q empty[2], K full[kStages], V full[kStages], K/V empty[kStages]
constexpr int kSmemBytes = kOffBar + 8 * (4 + 3 * kStages) + 1024;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;  // (B*H, Nq) or nullptr
  int H, Nq, Nk, n_qt, n_kt, n_items;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
};

// K-major 128-byte-swizzled operand (rows of 64 bf16): 8-row atoms 1 KB apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 1024, kSwizzle128);
}
// V read MN-major: 8 keys a 1 KB group, the 64-column halves kHalf apart
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return make_desc(addr, kHalf, 1024, kSwizzle128);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_d128_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers);
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
      int t = 0;  // key tiles issued, over all items
      int it = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int bh = item / p.n_qt;
        const int q0 = (item % p.n_qt) * kBlockM;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const int qs = it & 1;
        if (it >= 2) mbar_wait(&q_empty[qs], ((it >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qs], kTile);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(smem + kOffQ + qs * kTile + half * kHalf, &tq, &q_full[qs], 64 * half, q0,
                      h, b);
        }
        for (int j = 0; j < p.n_kt; ++j, ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
          mbar_arrive_expect_tx(&k_full[s], kTile);
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(smem + kOffK + s * kTile + half * kHalf, &tk, &k_full[s], 64 * half,
                        j * kBlockN, h, b);
          }
          mbar_arrive_expect_tx(&v_full[s], kTile);
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(smem + kOffV + s * kTile + half * kHalf, &tv, &v_full[s], 64 * half,
                        j * kBlockN, h, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  reg_alloc<232>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;  // this thread's rows: row, row + 8 of the warpgroup
  const int col = 2 * (lane % 4);        // and columns col, col + 1 of every 8

  int t = 0;
  int it = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
    const int bh = item / p.n_qt;
    const int q0 = (item % p.n_qt) * kBlockM;
    const int qs = it & 1;
    const uint32_t q_addr = smem_u32(smem + kOffQ + qs * kTile) + wg * 64 * 128;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(&q_full[qs], (it >> 1) & 1);
    for (int j = 0; j < p.n_kt; ++j, ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + kOffK + s * kTile);
      const uint32_t v_addr = smem_u32(smem + kOffV + s * kTile);

      // S = Q K^T: 64 queries x 128 keys, both operands K-major, two halves of D
      float sc[kBlockN / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        wgmma_ss<kBlockN, 0, 0>(sc, desc_k(q_addr + off), desc_k(k_addr + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (j == p.n_kt - 1) mbar_arrive(&q_empty[qs]);  // this item's Q is read

      // scale to the log2 domain; keys >= Nk (last tile only) at -inf
      const int key0 = j * kBlockN;
      if (key0 + kBlockN > p.Nk) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int key = key0 + 8 * (i / 4) + col + (i & 1);
          sc[i] = key < p.Nk ? sc[i] * p.scale_log2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= p.scale_log2;
      }

      // online softmax: new row max, rescale of O and of the row sums
      float mnew[2] = {mx[0], mx[1]};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        mnew[(i >> 1) & 1] = fmaxf(mnew[(i >> 1) & 1], sc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 1));
        mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 2));
      }
      const float alpha[2] = {exp2_ftz(mx[0] - mnew[0]), exp2_ftz(mx[1] - mnew[1])};
      mx[0] = mnew[0];
      mx[1] = mnew[1];
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        sc[i] = exp2_ftz(sc[i] - mnew[(i >> 1) & 1]);
        l[(i >> 1) & 1] += sc[i];
      }

      // O += P V: P from registers (bf16), V MN-major (rows are keys)
      uint32_t pa[kBlockN / 16][4];
      acc_to_a<kBlockN>(pa, sc);
      mbar_wait(&v_full[s], phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<kD, 1>(o, pa[kk], desc_v(v_addr + kk * 16 * 128), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&kv_empty[s]);
    }

    // epilogue: O / l through the strides, and the natural-log LSE
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int b = bh / p.H;
    const int h = bh % p.H;
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * wg + row + 8 * r;
      if (q >= p.Nq) continue;
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = out + q * p.o_sn;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
      if (p.lse != nullptr && col == 0) {
        p.lse[static_cast<long long>(bh) * p.Nq + q] = (mx[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// ---- float32, head_dim 16-128: CUDA cores ----
constexpr int kWarpsF32 = 4;  // query rows per CTA in the f32 kernel

struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Nq) or nullptr
  int H, Nq, Nk;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kWarpsF32 * 32) attn_f32_kernel(const ParamsF32 p) {
  constexpr int E = (D + 31) / 32;  // elements of the head dim per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsF32 + warp;
  if (row >= p.Nq) return;  // the whole warp leaves together
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh + row * p.q_sn;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;

  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    qv[e] = d < D ? q[d] * p.scale_log2 : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max, log2 domain
  float l = 0.f;        // running sum
  for (int j = 0; j < p.Nk; ++j) {
    const float* kr = k + j * p.k_sn;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      if (d < D) s = fmaf(qv[e], kr[d], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new);  // 0 on the first key
    const float pe = exp2f(s - m_new);
    l = l * alpha + pe;
    m = m_new;
    const float* vr = v + j * p.v_sn;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      acc[e] = acc[e] * alpha + (d < D ? pe * vr[d] : 0.f);
    }
  }
  const float inv = 1.f / l;
  float* o = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < D) o[d] = acc[e] * inv;
  }
  if (p.lse != nullptr && lane == 0) {
    p.lse[static_cast<long long>(bh) * p.Nq + row] = (m + log2f(l)) * kLn2;
  }
}

template <int D>
cudaError_t launch_f32(const ParamsF32& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Nq + kWarpsF32 - 1) / kWarpsF32, B * p.H);
  attn_f32_kernel<D><<<grid, kWarpsF32 * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_fwd_d128_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  if (D != kD || B < 1 || H < 1 || Nq < 1 || Nk < 1) return cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.n_qt = (Nq + kBlockM - 1) / kBlockM;
  p.n_kt = (Nk + kBlockN - 1) / kBlockN;
  const long long items = static_cast<long long>(B) * H * p.n_qt;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.n_items = static_cast<int>(items);
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;

  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = make_tensor_map(&tq, q, kD, Nq, H, B, q_sn, q_sh, q_sb, 64, kBlockM, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, kD, Nk, H, B, k_sn, k_sh, k_sb, 64, kBlockN, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, kD, Nk, H, B, v_sn, v_sh, v_sb, 64, kBlockN, swz);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_fwd_d128_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  flash_attn_fwd_d128_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

extern "C" int videogpa_flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_f32<16>(p, B, s);
    case 32: return launch_f32<32>(p, B, s);
    case 64: return launch_f32<64>(p, B, s);
    case 128: return launch_f32<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 kernel's registers a thread at launch (ptxas; setmaxnreg then
// moves the consumers to 232) and its dynamic shared memory a CTA, for
// reports.
extern "C" int videogpa_flash_attn_fwd_d128_attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_attn_fwd_d128_kernel);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = kSmemBytes;
  }
  return err;
}
