// Flash-attention forward for Hopper (sm_90a) at head_dim 16, 32 and 64:
// O = softmax(Q K^T / sqrt(D)) V, non-causal, bf16 operands, f32
// accumulation, optional natural-log LSE. Nq may differ from Nk.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py
// `_fwd_kernel_T` (:221, called at :344 from `_flash_fwd_T_pre`, the lagged-max
// forward at D < 128) and `_fwd_kernel_T_stall` (:392, its clamp-free
// exactness fallback, :474, :494). This kernel is an exact online softmax
// with no clamp, so it covers both.
//
// Bound: tensor-core operations, 4*B*H*Nq*Nk*D; at the CogVideoX-5B DiT
// shape (B=2, N=17,776, H=48, D=64) 7.77 TFLOP, 7.85 ms at the 989 TFLOP/s
// bf16 dense peak, against 0.87 GB of operands and output (0.26 ms at 3.35
// TB/s). At D = 64 a second bound sits at the same height: each score costs
// one exp2 on the special-function unit (16 a clock an SM) and 4*D = 256
// tensor-core flops (4,096 a clock an SM), 1/16 clock each. So the kernel
// reaches its bound only if one warpgroup's exp2s run while another
// warpgroup's products are in flight.
//
// Design (the schedule of K6's bf16 entry, flash_attn_fwd_d128.cu, as one
// template over D, with kConsumerWGs consumer warpgroups):
//  - A persistent grid of one CTA an SM walks the work items (query tile of
//    64 * kConsumerWGs rows, b*h) in order item = b*h * n_q_tiles + query
//    tile, CTA c taking items c, c + grid, ...: the SMs work on neighbouring
//    query tiles of one head at a time, so that head's K and V stay in L2,
//    and any B*H fits the grid.
//  - One producer warpgroup (setmaxnreg down; one thread issues every TMA
//    copy) and kConsumerWGs consumer warpgroups of 64 query rows each. The
//    producer loads each item's Q tile once into one of two Q buffers (so
//    the next item's Q arrives while this item's last tiles and its epilogue
//    run) and streams 128-key tiles of K and V through a kStages ring under
//    full / empty mbarriers, continuing across items. A bf16 row of D is 32,
//    64 or 128 bytes: each tile is one TMA box with the matching swizzle.
//  - Each consumer warpgroup computes S = Q K^T on wgmma (both operands
//    K-major, N = 128 keys), keeps its row max, row sum and the 64 x D O
//    accumulator in registers, runs an exact online softmax in the log2
//    domain (D^-0.5 log2 e folded into one multiply, exp2 as one
//    flush-to-zero SFU instruction), and O += P V on wgmma with P repacked
//    to bf16 from the S accumulator registers and V read MN-major (N = D is
//    one swizzle atom wide: no LBO). The warpgroups run unsynchronised, so
//    one's softmax overlaps the others' products.
//  - Keys >= Nk are TMA's zero rows, masked to -inf (last tile only);
//    queries >= Nq are computed on TMA's zero rows and not stored. The
//    base-2 LSE (max + log2 of the row sum) is stored as the natural-log LSE
//    that K3 consumes, in the (B*H, Nq) layout.
//  - Shared memory at D = 64 with three consumer warpgroups and four stages:
//    Q 2 x 24 KB + K 4 x 16 KB + V 4 x 16 KB = 177 KB with the barriers: one
//    CTA an SM.
// Operands are addressed through rank-4 tensor maps over (D, N, H, B) with
// element strides, so the (B, N, H, D) and (B, H, N, D) views of the DiT's
// projections go in without a copy; O through its own strides.
//
// Plain C interface (ctypes), the same as K6's. Returns cudaGetLastError()
// after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace videogpa::sm90;

constexpr int kConsumerWGs = 3;  // 64 query rows each
constexpr int kStages = 4;       // K / V ring depth
constexpr int kBlockM = 64 * kConsumerWGs;
constexpr int kBlockN = 128;  // keys per tile
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;
// setmaxnreg: the consumers take what the producer gives up (65,536 a CTA)
constexpr int kProducerRegs = kConsumerWGs == 3 ? 32 : 40;
constexpr int kConsumerRegs = kConsumerWGs == 3 ? 160 : 232;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int kRow = D * 2;      // bytes of one row of Q, K or V
  static constexpr int kAtom = 8 * kRow;  // 8 rows: SBO
  static constexpr int kSwizzle = D == 64 ? kSwizzle128 : D == 32 ? kSwizzle64 : kSwizzle32;
  static constexpr int kTileQ = kBlockM * kRow;
  static constexpr int kTileK = kBlockN * kRow;
  static constexpr int kQ = 0;  // two Q buffers
  static constexpr int kK = kQ + 2 * kTileQ;
  static constexpr int kV = kK + kStages * kTileK;
  static constexpr int kBar = kV + kStages * kTileK;
  // barriers: Q full[2], Q empty[2], K full[kStages], V full[kStages], K/V empty[kStages]
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;  // (B*H, Nq) or nullptr
  int H, Nq, Nk, n_qt, n_kt, n_items;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
};

// Q or K (rows of D bf16, swizzled to the row width) read K-major, and V
// read MN-major; 8-row atoms kAtom bytes apart
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, Layout<D>::kAtom, Layout<D>::kSwizzle);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return make_desc(addr, Layout<D>::kAtom, Layout<D>::kAtom, Layout<D>::kSwizzle);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
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
    reg_dealloc<kProducerRegs>();
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
        mbar_arrive_expect_tx(&q_full[qs], L::kTileQ);
        tma_load_4d(smem + L::kQ + qs * L::kTileQ, &tq, &q_full[qs], 0, q0, h, b);
        for (int j = 0; j < p.n_kt; ++j, ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
          mbar_arrive_expect_tx(&k_full[s], L::kTileK);
          tma_load_4d(smem + L::kK + s * L::kTileK, &tk, &k_full[s], 0, j * kBlockN, h, b);
          mbar_arrive_expect_tx(&v_full[s], L::kTileK);
          tma_load_4d(smem + L::kV + s * L::kTileK, &tv, &v_full[s], 0, j * kBlockN, h, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  reg_alloc<kConsumerRegs>();
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
    const uint32_t q_addr = smem_u32(smem + L::kQ + qs * L::kTileQ) + wg * 64 * L::kRow;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(&q_full[qs], (it >> 1) & 1);
    for (int j = 0; j < p.n_kt; ++j, ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTileK);
      const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kTileK);

      // S = Q K^T: 64 queries x 128 keys, both operands K-major
      float sc[kBlockN / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<kBlockN, 0, 0>(sc, desc_k<D>(q_addr + kk * 32), desc_k<D>(k_addr + kk * 32),
                                kk > 0);
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
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
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
        wgmma_rs<D, 1>(o, pa[kk], desc_mn<D>(v_addr + kk * 16 * L::kRow), 1);
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
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
      if (p.lse != nullptr && col == 0) {
        p.lse[static_cast<long long>(bh) * p.Nq + q] = (mx[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const Params& p, int B,
                   long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                   long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                   long long v_sh, cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapSwizzle swz = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_tensor_map(&tq, q, D, p.Nq, p.H, B, q_sn, q_sh, q_sb, D, kBlockM, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, D, p.Nk, p.H, B, k_sn, k_sh, k_sb, D, kBlockN, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, D, p.Nk, p.H, B, v_sn, v_sh, v_sb, D, kBlockN, swz);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attn_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  flash_attn_fwd_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1) return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIDEOGPA_FWD_LAUNCH(DIM) \
  launch<DIM>(q, k, v, p, B, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, s)
  switch (D) {
    case 16: return VIDEOGPA_FWD_LAUNCH(16);
    case 32: return VIDEOGPA_FWD_LAUNCH(32);
    case 64: return VIDEOGPA_FWD_LAUNCH(64);
    default: return cudaErrorInvalidValue;
  }
#undef VIDEOGPA_FWD_LAUNCH
}

// The kernel's registers a thread at launch (ptxas; setmaxnreg then moves
// the consumers to kConsumerRegs) and its dynamic shared memory a CTA at
// head_dim D, for reports.
extern "C" int videogpa_flash_attn_fwd_attrs(int D, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 16:
      err = cudaFuncGetAttributes(&a, flash_attn_fwd_kernel<16>);
      *smem_bytes = Layout<16>::kBytes;
      break;
    case 32:
      err = cudaFuncGetAttributes(&a, flash_attn_fwd_kernel<32>);
      *smem_bytes = Layout<32>::kBytes;
      break;
    case 64:
      err = cudaFuncGetAttributes(&a, flash_attn_fwd_kernel<64>);
      *smem_bytes = Layout<64>::kBytes;
      break;
    default: break;
  }
  if (err == cudaSuccess) *regs = a.numRegs;
  return err;
}
