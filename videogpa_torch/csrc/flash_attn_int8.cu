// int8-QK flash-attention forward for Hopper (sm_90a), inference only:
//   S = int32(q8 k8^T) * sq[row] * sk[col]   (already in the base-2 log domain)
//   O = softmax2(S) V,  P cast to bf16 before PV, f32 accumulation
// q8, k8: int8 rows with one f32 scale per row (sq, sk); V and O: bf16.
// The caller (ops/attention.py::quantize_qk_int8) centres K on its mean over
// the keys, prescales q by log2(e) / sqrt(D) and quantises both per row.
//
// Replaces the TPU Pallas kernels of videogpa_tpu/ops/attention.py:
//   K8 `_fwd_kernel_T8` (:640, head_dim < 128; entry videogpa_flash_attn_int8,
//       head_dim 16, 32 or 64) and
//   K9 `_fwd_kernel_i8` (:766, head_dim 128; entry
//       videogpa_flash_attn_int8_d128).
// Both are one template. This kernel is a plain online softmax with no clamp
// on the running max, so it is exact for any range of the quantised scores
// (given sq > 0, which quantize_qk_int8 guarantees; see the design below):
// the TPU kernel's lagged max, its 2^110 clamp, the `jumps` output and the
// switch to the exact bf16 kernel have no counterpart here, nor have the
// transposed (D, N) accumulators, the ones-row denominator and the 8-lane
// broadcast of the scales.
//
// Bound: tensor-core operations. QK^T is 2*B*H*Nq*Nk*D integer operations
// (dense int8 peak 1,979 TOP/s) and PV as many in bf16 (989 TFLOP/s): at the
// CogVideoX-5B DiT shape (B=2, N=17,776, H=48, D=64) 1.96 + 3.93 = 5.89 ms,
// against ~0.2 ms for its ~0.65 GB of operands and output at 3.35 TB/s. Per
// score the CUDA cores also convert the s32 sum, scale it, and take one exp2
// on the special-function unit (16 a clock an SM, as K1's).
//
// Design (K1's schedule, flash_attn_fwd.cu, at head_dim 16-64 and K6's,
// flash_attn_fwd_d128.cu, at 128, as one template over D):
//  - A persistent grid of one CTA an SM walks the work items (query tile of
//    64 rows a consumer warpgroup, b*h) in order item = b*h * n_q_tiles +
//    query tile, CTA c taking items c, c + grid, ...: neighbouring query
//    tiles of one head run together, so that head's K and V stay in L2, and
//    any B*H fits the grid.
//  - One producer warpgroup (setmaxnreg down) and kConsumerWGs consumer
//    warpgroups (two at head_dim 128). One producer thread issues every TMA
//    copy: each item's Q8 tile into one of two Q buffers, and 128-key tiles
//    of K8 and V through a kStages ring under full / empty mbarriers,
//    continuing across items. The producer's first warp also copies each K
//    tile's 128 key scales into the stage with 4-byte cp.async copies that
//    arrive on the K tile's full barrier: sk may have any key stride (the
//    bnhd scales are (B, N, H), a key stride of H), which a TMA box cannot
//    take.
//  - An int8 row of D is byte for byte a bf16 row of D/2: Q8 and K8 rows of
//    32, 64 and 128 bytes are one TMA box with the matching swizzle and are
//    read K-major by `wgmma ... m64n128k32.s32.s8.s8`, one k32 step per 32
//    bytes, as K1 and K6 read bf16 rows. At head_dim 16 the box is 32 bytes
//    wide over the 16-byte rows: TMA fills the upper half with zeros, which
//    add nothing to the s32 sums.
//  - Each consumer warpgroup computes S = Q8 K8^T (64 queries x 128 keys,
//    s32, the f32 accumulator's layout) and dequantises it in registers:
//    t = float(s) * sk[col], one I2F a score (exact: |s| <= D * 127^2 <
//    2^24). The integer-add trick (the float 1.5 * 2^23 + s has the bits
//    0x4B400000 + s, exact for |s| < 2^22) keeps the conversion off the
//    unit that runs exp2, but costs two instructions a score and measured
//    slower (kernel_ab.py variant int8_magic). The row scale enters the
//    exponent: p = exp2(t * sq - sq * max t) as one FMA. That needs sq > 0:
//    at sq = 0 a masked key's -inf * 0 is NaN, and a negative sq turns the
//    max into a min. Keys >= Nk are TMA's zero rows, masked to -inf on the
//    last tile only. O += P V on wgmma with P repacked to bf16 from the S
//    registers and V read MN-major, as in K1 / K6; O / (row sum) at the end.
//    Queries >= Nq are computed on TMA's zero rows and not stored.
// Operands are addressed through rank-4 tensor maps over (D, N, H, B) with
// element strides, in either layout, Nq may differ from Nk, and nothing is
// padded on the host.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace videogpa::sm90;

constexpr int kConsumerWGs = 3;  // at head_dim <= 64; two at 128
constexpr int kBlockN = 128;     // keys per tile

template <int D>
struct Layout {
  static constexpr int kWGs = D == 128 ? 2 : kConsumerWGs;
  static constexpr int kStages = D == 128 ? 2 : 4;  // K / V ring depth
  static constexpr int kBlockM = 64 * kWGs;
  static constexpr int kConsumers = 128 * kWGs;
  static constexpr int kThreads = kConsumers + 128;
  // setmaxnreg: the consumers take what the producer gives up (65,536 a CTA)
  static constexpr int kProducerRegs = kWGs == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 232;
  // Q8 / K8: rows of D bytes, 32 at head_dim 16 (the TMA box's zero half)
  static constexpr int kRow8 = D < 32 ? 32 : D;
  static constexpr int kAtom8 = 8 * kRow8;
  static constexpr int kSwizzle8 =
      kRow8 == 128 ? kSwizzle128 : kRow8 == 64 ? kSwizzle64 : kSwizzle32;
  // V: bf16 rows of D, in 64-column (128-byte) halves at head_dim 128
  static constexpr int kRowV = D == 128 ? 128 : 2 * D;
  static constexpr int kAtomV = 8 * kRowV;
  static constexpr int kSwizzleV =
      kRowV == 128 ? kSwizzle128 : kRowV == 64 ? kSwizzle64 : kSwizzle32;
  static constexpr int kHalfV = kBlockN * kRowV;  // one 64-column half at head_dim 128
  static constexpr int kTileQ = kBlockM * kRow8;
  static constexpr int kTileK = kBlockN * kRow8;
  static constexpr int kTileV = kBlockN * D * 2;
  static constexpr int kQ = 0;  // two Q buffers
  static constexpr int kK = kQ + 2 * kTileQ;
  static constexpr int kV = kK + kStages * kTileK;
  static constexpr int kSk = kV + kStages * kTileV;  // kStages x 128 key scales
  static constexpr int kBar = kSk + kStages * kBlockN * 4;
  // barriers: Q full[2], Q empty[2], K full[kStages], V full[kStages], K/V empty[kStages]
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;
};

struct Params {
  const float* sq;
  const float* sk;
  __nv_bfloat16* o;
  int H, Nq, Nk, n_qt, n_kt, n_items;
  long long sq_sb, sq_sn, sq_sh;
  long long sk_sb, sk_sn, sk_sh;
  long long o_sb, o_sn, o_sh;
};

// Q8 or K8 read K-major; V read MN-major (8-key groups kAtomV bytes apart,
// the 64-column halves kHalfV apart at head_dim 128)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, Layout<D>::kAtom8, Layout<D>::kSwizzle8);
}
template <int D>
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  using L = Layout<D>;
  return make_desc(addr, D == 128 ? L::kHalfV : L::kAtomV, L::kAtomV, L::kSwizzleV);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_attn_int8_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;
  float* sk_smem = reinterpret_cast<float*>(smem + L::kSk);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], L::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1 + 32);  // the TMA thread's expect-tx + the scale copies of one warp
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // ---- producer warpgroup: its first warp works, one thread issues TMA ----
    reg_dealloc<L::kProducerRegs>();
    const int lane = threadIdx.x - L::kConsumers;
    if (lane < 32) {
      if (lane == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
        tma_prefetch(&tv);
      }
      int t = 0;  // key tiles issued, over all items
      int it = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int bh = item / p.n_qt;
        const int q0 = (item % p.n_qt) * L::kBlockM;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const float* sk = p.sk + b * p.sk_sb + h * p.sk_sh;
        const int qs = it & 1;
        if (lane == 0) {
          if (it >= 2) mbar_wait(&q_empty[qs], ((it >> 1) - 1) & 1);
          mbar_arrive_expect_tx(&q_full[qs], L::kTileQ);
          tma_load_4d(smem + L::kQ + qs * L::kTileQ, &tq, &q_full[qs], 0, q0, h, b);
        }
        for (int j = 0; j < p.n_kt; ++j, ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&k_full[s], L::kTileK);
            tma_load_4d(smem + L::kK + s * L::kTileK, &tk, &k_full[s], 0, j * kBlockN, h, b);
            mbar_arrive_expect_tx(&v_full[s], L::kTileV);
            if constexpr (D == 128) {
              for (int half = 0; half < 2; ++half) {
                tma_load_4d(smem + L::kV + s * L::kTileV + half * L::kHalfV, &tv, &v_full[s],
                            64 * half, j * kBlockN, h, b);
              }
            } else {
              tma_load_4d(smem + L::kV + s * L::kTileV, &tv, &v_full[s], 0, j * kBlockN, h, b);
            }
          }
          // the tile's key scales; keys >= Nk read as 0 (their scores are masked)
#pragma unroll
          for (int u = 0; u < kBlockN / 32; ++u) {
            const int key = j * kBlockN + 32 * u + lane;
            const bool valid = key < p.Nk;
            cp_async_4(sk_smem + s * kBlockN + 32 * u + lane, sk + (valid ? key * p.sk_sn : 0),
                       valid);
          }
          cp_async_mbar_arrive(&k_full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  reg_alloc<L::kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;  // this thread's rows: row, row + 8 of the warpgroup
  const int col = 2 * (lane % 4);        // and columns col, col + 1 of every 8

  int t = 0;
  int it = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
    const int bh = item / p.n_qt;
    const int q0 = (item % p.n_qt) * L::kBlockM;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int qs = it & 1;
    const uint32_t q_addr = smem_u32(smem + L::kQ + qs * L::kTileQ) + wg * 64 * L::kRow8;
    // this thread's two query scales (1 on rows past Nq, which are not stored)
    float sq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * wg + row + 8 * r;
      sq[r] = q < p.Nq ? p.sq[b * p.sq_sb + q * p.sq_sn + h * p.sq_sh] : 1.f;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY};  // running max of S = t * sq (log2 domain)
    float l[2] = {0.f, 0.f};               // this thread's share of the row sums

    mbar_wait(&q_full[qs], (it >> 1) & 1);
    for (int j = 0; j < p.n_kt; ++j, ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTileK);
      const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kTileV);

      // S = Q8 K8^T: 64 queries x 128 keys in s32, both operands K-major
      int si[kBlockN / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::kRow8 / 32; ++kk) {
        wgmma_ss_s8_n128(si, desc_k<D>(q_addr + kk * 32), desc_k<D>(k_addr + kk * 32), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(si);
      if (j == p.n_kt - 1) mbar_arrive(&q_empty[qs]);  // this item's Q is read

      // t = float(s) * sk[col]; keys >= Nk (last tile only) at -inf
      const float* skt = sk_smem + s * kBlockN;
      float sc[kBlockN / 2];
#pragma unroll
      for (int c = 0; c < kBlockN / 8; ++c) {
        const float2 skv = *reinterpret_cast<const float2*>(skt + 8 * c + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * c + e] = static_cast<float>(si[4 * c + e]) * ((e & 1) ? skv.y : skv.x);
        }
      }
      const int key0 = j * kBlockN;
      if (key0 + kBlockN > p.Nk) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int key = key0 + 8 * (i / 4) + col + (i & 1);
          if (key >= p.Nk) sc[i] = -INFINITY;
        }
      }

      // online softmax of S = t * sq: new row max, rescale of O and of the row sums
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
      }
      float mnew[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        mnew[r] = fmaxf(mx[r], tmax[r] * sq[r]);  // finite: key0 < Nk
      }
      const float alpha[2] = {exp2_ftz(mx[0] - mnew[0]), exp2_ftz(mx[1] - mnew[1])};
      mx[0] = mnew[0];
      mx[1] = mnew[1];
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2_ftz(fmaf(sc[i], sq[r], -mnew[r]));
        l[r] += sc[i];
      }

      // O += P V: P from registers (bf16), V MN-major (rows are keys)
      uint32_t pa[kBlockN / 16][4];
      acc_to_a<kBlockN>(pa, sc);
      mbar_wait(&v_full[s], phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<D, 1>(o, pa[kk], desc_v<D>(v_addr + kk * 16 * L::kRowV), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&kv_empty[s]);
    }

    // epilogue: O / l through the strides
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * wg + row + 8 * r;
      if (q >= p.Nq) continue;
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = out + q * p.o_sn;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int D>
cudaError_t launch(const void* q8, const void* k8, const void* v, Params p, int B,
                   const long long* st, cudaStream_t stream) {
  using L = Layout<D>;
  p.n_qt = (p.Nq + L::kBlockM - 1) / L::kBlockM;
  p.n_kt = (p.Nk + kBlockN - 1) / kBlockN;
  const long long items = static_cast<long long>(B) * p.H * p.n_qt;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.n_items = static_cast<int>(items);
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_tensor_map(&tq, q8, D, p.Nq, p.H, B, st[1], st[2], st[0], L::kRow8,
                                    L::kBlockM, swizzle_for(L::kRow8), true);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k8, D, p.Nk, p.H, B, st[7], st[8], st[6], L::kRow8, kBlockN,
                          swizzle_for(L::kRow8), true);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, D, p.Nk, p.H, B, st[13], st[14], st[12], L::kRowV / 2, kBlockN,
                          swizzle_for(L::kRowV));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_int8_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  flash_attn_int8_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// strides: (b, n, h) of q8, sq, k8, sk, v, o in that order
cudaError_t dispatch(const void* q8, const void* sq, const void* k8, const void* sk,
                     const void* v, void* o, int B, int H, int Nq, int Nk, int D,
                     const long long* st, cudaStream_t stream, bool d128) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || (D == 128) != d128) return cudaErrorInvalidValue;
  Params p;
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.sq_sb = st[3]; p.sq_sn = st[4]; p.sq_sh = st[5];
  p.sk_sb = st[9]; p.sk_sn = st[10]; p.sk_sh = st[11];
  p.o_sb = st[15]; p.o_sn = st[16]; p.o_sh = st[17];
  switch (D) {
    case 16: return launch<16>(q8, k8, v, p, B, st, stream);
    case 32: return launch<32>(q8, k8, v, p, B, st, stream);
    case 64: return launch<64>(q8, k8, v, p, B, st, stream);
    case 128: return launch<128>(q8, k8, v, p, B, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#define VIDEOGPA_INT8_ARGS                                                                      \
  const void *q8, const void *sq, const void *k8, const void *sk, const void *v, void *o,      \
      int B, int H, int Nq, int Nk, int D, long long q_sb, long long q_sn, long long q_sh,     \
      long long sq_sb, long long sq_sn, long long sq_sh, long long k_sb, long long k_sn,       \
      long long k_sh, long long sk_sb, long long sk_sn, long long sk_sh, long long v_sb,       \
      long long v_sn, long long v_sh, long long o_sb, long long o_sn, long long o_sh,          \
      void *stream

#define VIDEOGPA_INT8_STRIDES                                                                   \
  const long long strides[18] = {q_sb,  q_sn,  q_sh,  sq_sb, sq_sn, sq_sh, k_sb, k_sn, k_sh,   \
                                 sk_sb, sk_sn, sk_sh, v_sb,  v_sn,  v_sh,  o_sb, o_sn, o_sh}

// K8: head_dim 16, 32 or 64.
extern "C" int videogpa_flash_attn_int8(VIDEOGPA_INT8_ARGS) {
  VIDEOGPA_INT8_STRIDES;
  return dispatch(q8, sq, k8, sk, v, o, B, H, Nq, Nk, D, strides,
                  static_cast<cudaStream_t>(stream), false);
}

// K9: head_dim 128.
extern "C" int videogpa_flash_attn_int8_d128(VIDEOGPA_INT8_ARGS) {
  VIDEOGPA_INT8_STRIDES;
  return dispatch(q8, sq, k8, sk, v, o, B, H, Nq, Nk, D, strides,
                  static_cast<cudaStream_t>(stream), true);
}

// The kernel's registers a thread at launch (ptxas; setmaxnreg then moves
// the consumers to kConsumerRegs) and its dynamic shared memory a CTA at
// head_dim D, for reports.
extern "C" int videogpa_flash_attn_int8_attrs(int D, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 16:
      err = cudaFuncGetAttributes(&a, flash_attn_int8_kernel<16>);
      *smem_bytes = Layout<16>::kBytes;
      break;
    case 32:
      err = cudaFuncGetAttributes(&a, flash_attn_int8_kernel<32>);
      *smem_bytes = Layout<32>::kBytes;
      break;
    case 64:
      err = cudaFuncGetAttributes(&a, flash_attn_int8_kernel<64>);
      *smem_bytes = Layout<64>::kBytes;
      break;
    case 128:
      err = cudaFuncGetAttributes(&a, flash_attn_int8_kernel<128>);
      *smem_bytes = Layout<128>::kBytes;
      break;
    default: break;
  }
  if (err == cudaSuccess) *regs = a.numRegs;
  return err;
}
