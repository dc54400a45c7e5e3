// Short-row attention for Hopper (sm_90a): O = softmax(Q K^T / sqrt(D)) V
// over key rows of at most 2,048, bf16 operands in the (B, N, H, D)
// projection layout, f32 accumulation, no LSE (inference only), keys at
// index >= n_valid masked; head_dim 16, 32 or 64.
//
// Replaces the TPU Pallas kernel videogpa_tpu/ops/attention.py `_flash_short`
// (call :589): VGGT's frame attention and DINOv2, (K*10 frames, 1,374
// tokens, 16 heads, 64). That kernel holds one query block, the whole key
// row and all heads in VMEM and takes an exact one-shot softmax. The row does
// not fit a Hopper SM's shared memory (one head's K and V at 1,408 padded
// keys x 64 x 2 B are 360 KB against 227 KB), so the softmax here is online:
// one pass over 128-key tiles with a running row max and a rescaled
// accumulator, exact to float rounding, so the one-shot softmax's answer at
// any logit range (the extreme-logit case q x 1e3 pins this).
//
// Masking follows the JAX kernel: keys >= n_valid score -inf and their V
// rows count as zero. The key and value tensor maps end at n_valid, so TMA
// zero-fills rows >= n_valid and never reads them: NaN or Inf there cannot
// reach O.
//
// Bound at (40, 1,374, 16, 64): tensor-core operations, 4*B*H*N^2*D =
// 0.309 TFLOP -> 0.31 ms at the 989 TFLOP/s bf16 dense peak (its 0.45 GB of
// operands and output need 0.13 ms at 3.35 TB/s). The two-pass softmax this
// kernel had before did 1.5x those operations (bound 0.47 ms).
//
// Design: one CTA per (128-query tile, b*h) on a flat grid: two consumer warpgroups of 64
// query rows each and one producer warp. The producer loads the CTA's Q tile
// once and streams 128-key tiles of K and V through a 2-stage ring of
// shared-memory buffers with TMA (rank-4 tensor maps over (D, N, H, B) with
// the operands' element strides, so slices of the packed qkv projection need
// no copy), under full / empty mbarriers. Each consumer warpgroup computes
// S = Q K^T on wgmma with both operands in shared memory (K-major), keeps
// its row max, row sum and O accumulator in registers, and runs P V on
// wgmma with P repacked to bf16 from the S accumulator registers and V
// read MN-major from shared memory. Tiles are 32-, 64- or 128-byte swizzled
// to match the row width. 80 KB of shared memory at head_dim 64: two CTAs
// an SM.
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

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kBlockM = 128;                 // queries per CTA, 64 per warpgroup
constexpr int kBlockN = 128;                 // keys per tile
constexpr int kStages = 2;

struct Params {
  __nv_bfloat16* o;
  int H, Nq, n_valid, n_qt;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
};

template <int D>
struct Layout {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;  // 8 rows: SBO
  static constexpr int kSwizzle = D == 64 ? kSwizzle128 : D == 32 ? kSwizzle64 : kSwizzle32;
  static constexpr int kTileQ = kBlockM * kRowBytes;
  static constexpr int kTileKV = kBlockN * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileQ;
  static constexpr int kV = kK + kStages * kTileKV;
  static constexpr int kBar = kV + kStages * kTileKV;
  // barriers: Q full, K/V full[kStages], K/V empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_short_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // flat grid, query tile fastest: the tiles of one head are neighbours, so
  // its K and V rows stay in L2, and any B*H fits
  const int bh = static_cast<int>(blockIdx.x / p.n_qt);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = static_cast<int>(blockIdx.x % p.n_qt) * kBlockM;
  const int n_kv = (p.n_valid + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: one thread issues every copy ----
    if (threadIdx.x == kConsumers) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_arrive_expect_tx(q_full, L::kTileQ);
      tma_load_4d(smem + L::kQ, &tq, q_full, 0, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTileKV);
        tma_load_4d(smem + L::kK + s * L::kTileKV, &tk, &full[s], 0, j * kBlockN, h, b);
        tma_load_4d(smem + L::kV + s * L::kTileKV, &tv, &full[s], 0, j * kBlockN, h, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;  // this thread's rows: row, row + 8 of the warpgroup
  const int col = 2 * (lane % 4);        // and columns col, col + 1 of every 8

  const uint32_t q_addr = smem_u32(smem + L::kQ) + wg * 64 * L::kRowBytes;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTileKV);
    const uint32_t v_addr = smem_u32(smem + L::kV + s * L::kTileKV);

    // S = Q K^T: 64 queries x 128 keys, both operands K-major
    float sc[kBlockN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<kBlockN, 0, 0>(sc, make_desc(q_addr + kk * 32, 16, L::kAtomBytes, L::kSwizzle),
                              make_desc(k_addr + kk * 32, 16, L::kAtomBytes, L::kSwizzle),
                              kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale to the log2 domain; keys >= n_valid (last tile only) at -inf
    const int key0 = j * kBlockN;
    if (key0 + kBlockN > p.n_valid) {
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int key = key0 + 8 * (i / 4) + col + (i & 1);
        sc[i] = key < p.n_valid ? sc[i] * p.scale_log2 : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= p.scale_log2;
    }

    // online softmax: new row max, rescale of O and of the row sums
    float mnew[2] = {mx[0], mx[1]};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) mnew[(i >> 1) & 1] = fmaxf(mnew[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 1));
      mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 2));
    }
    const float alpha[2] = {exp2f(mx[0] - mnew[0]), exp2f(mx[1] - mnew[1])};
    mx[0] = mnew[0];
    mx[1] = mnew[1];
    l[0] *= alpha[0];
    l[1] *= alpha[1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      sc[i] = exp2f(sc[i] - mnew[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }

    // O += P V: P from registers (bf16), V MN-major (rows are keys)
    uint32_t pa[kBlockN / 16][4];
    acc_to_a<kBlockN>(pa, sc);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs<D, 1>(o, pa[kk],
                     make_desc(v_addr + kk * 16 * L::kRowBytes, L::kAtomBytes, L::kAtomBytes,
                               L::kSwizzle),
                     1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + 64 * wg + row + 8 * r;
    if (q >= p.Nq) continue;
    __nv_bfloat16* orow = out + q * p.o_sn;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, const void* q, const void* k, const void* v, int B,
                   long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                   long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
                   cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapSwizzle swz = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_tensor_map(&tq, q, D, p.Nq, p.H, B, q_sn, q_sh, q_sb, D, kBlockM, swz);
  if (err != cudaSuccess) return err;
  // K and V end at n_valid: rows past it are zero-filled, never read
  err = make_tensor_map(&tk, k, D, p.n_valid, p.H, B, k_sn, k_sh, k_sb, D, kBlockN, swz);
  if (err != cudaSuccess) return err;
  err = make_tensor_map(&tv, v, D, p.n_valid, p.H, B, v_sn, v_sh, v_sb, D, kBlockN, swz);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_short_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(p.n_qt) * B * p.H;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_short_kernel<D><<<static_cast<unsigned int>(ctas), kThreads, L::kBytes, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_short(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int n_valid,
    int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long o_sb,
    long long o_sn, long long o_sh, float scale_log2, void* stream) {
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.n_valid = n_valid;
  p.n_qt = (Nq + kBlockM - 1) / kBlockM;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(p, q, k, v, B, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, s);
    case 32:
      return launch<32>(p, q, k, v, B, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, s);
    case 64:
      return launch<64>(p, q, k, v, B, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The kernel's registers a thread (ptxas) and dynamic shared memory a CTA at
// head_dim D, for reports.
extern "C" int videogpa_flash_attn_short_attrs(int D, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 16:
      err = cudaFuncGetAttributes(&a, flash_attn_short_kernel<16>);
      *smem_bytes = Layout<16>::kBytes;
      break;
    case 32:
      err = cudaFuncGetAttributes(&a, flash_attn_short_kernel<32>);
      *smem_bytes = Layout<32>::kBytes;
      break;
    case 64:
      err = cudaFuncGetAttributes(&a, flash_attn_short_kernel<64>);
      *smem_bytes = Layout<64>::kBytes;
      break;
    default: break;
  }
  if (err == cudaSuccess) *regs = a.numRegs;
  return err;
}
