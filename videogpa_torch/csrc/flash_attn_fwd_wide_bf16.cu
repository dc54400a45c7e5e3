// Flash-attention forward at head_dim > 128 in bf16 for Hopper (sm_90a):
// O = softmax(Q K^T * scale) V, non-causal, optional natural-log LSE.
//
// Replaces the TPU Pallas kernel videogpa_tpu/ops/attention.py `_fwd_kernel`
// (:65, calls at :175 with LSE and :186 without, from `_flash_fwd` :126),
// which the JAX package runs at every head_dim >= 128 (at D % 128 != 0 with
// its ones-column, :138-144). The port's K6 (flash_attn_fwd_d128.cu) ends at
// D = 128; `attention()` zero-pads any other D > 128 to the next multiple of
// 64 and passes D's scale. S = Q K^T * scale in the log2 domain, an exact
// online softmax, P rounded to bf16 before P V (`p.astype(v_ref.dtype)`,
// :107-110), the row sum of the unrounded P, O rounded once.
//
// Bound: tensor-core operations, 4*B*H*Nq*Nk*D; at (1, 4,096, 16, 256) that
// is 0.275 TFLOP, 0.278 ms at the 989 TFLOP/s bf16 dense peak, against 134 MB
// of operands (0.040 ms at 3.35 TB/s). Above 256 columns O is cut into
// slices, each recomputing S: 2*B*H*Nq*Nk*D*(1 + n_slices) operations (S
// twice at D = 512).
//
// Design (K6's scheme, generic in D):
//  - A persistent grid of one CTA an SM walks the work items (128-query
//    tile, slice of O, b*h) in order item = (b*h * n_slices + slice) *
//    n_q_tiles + query tile, CTA c taking items c, c + grid, ...: neighbouring
//    SMs work on neighbouring query tiles of one head, whose K and V stay in
//    L2, and any B*H fits the grid.
//  - A slice of O is at most 256 columns (four 64-column chunks): a consumer
//    warpgroup's 64 x 256 f32 accumulator is 128 registers a thread. D <= 256
//    is one slice; above, D's nc chunks are cut into n_slices = ceil(nc / 4)
//    slices of NCS = ceil(nc / n_slices) chunks (three or four), the last one
//    possibly narrower (its missing chunks are neither loaded nor stored).
//  - One producer warpgroup (setmaxnreg 40; one thread issues every TMA
//    copy) and two consumer warpgroups of 64 query rows each (232
//    registers). Every row of Q, K and V is read as 64-column boxes of 128
//    bytes, 128-byte swizzled, from rank-4 tensor maps over (D, N, H, B)
//    with element strides, so the (B, N, H, D) and (B, H, N, D) layouts and
//    strided views go in without a copy.
//  - At D <= 256 the item's Q tile stays in shared memory (one buffer, up to
//    four 16 KB boxes, loaded once an item) and the producer streams 64-key
//    K tiles in 64-column chunks through an 8-stage ring (8 KB a stage) and
//    the slice's V tiles through a 2-stage ring. Above 256 columns Q does not
//    fit beside them: each stage of the 5-stage ring carries the K chunk and
//    the Q chunk of the same columns (24 KB), so Q is read again from L2 for
//    every key tile.
//  - Each consumer warpgroup computes S = Q K^T (64 queries x 64 keys, 32
//    registers a thread) on SS-wgmma, one commit group a chunk, releasing a
//    chunk's stage as soon as the next chunk's products are issued and its
//    own are done; keys >= Nk (the last tile's TMA zero rows) are masked to
//    -inf; the online softmax runs in the log2 domain (scale * log2 e folded
//    into one multiply, exp2 as one flush-to-zero SFU instruction); O += P V
//    runs on RS-wgmma with P repacked to bf16 from the S registers, one
//    m64n64 product a 64-column chunk of the slice (V read MN-major).
//  - Queries >= Nq are computed on TMA's zero rows and not stored. Slice 0
//    stores the natural-log LSE (max + log2 of the row sum, times ln 2) in
//    the (B*H, Nq) layout that the backward reads.
//  - Shared memory, 1,024-byte aligned: D <= 256, Q 4 x 16 KB + K 8 x 8 KB + V
//    2 x 32 KB = 192 KB; above, 5 x 24 KB + 2 x 32 KB = 184 KB; with the
//    barriers: one CTA an SM (`videogpa_flash_attn_fwd_wide_bf16_attrs`).
//
// Plain C interface (ctypes), the interface of flash_attn_fwd.cu. Returns
// cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace videogpa::sm90;

constexpr int kBlockM = 128;  // queries an item, 64 a consumer warpgroup
constexpr int kBlockN = 64;   // keys a tile
constexpr int kChunk = 64;    // columns a box
constexpr int kMaxSlice = 4;  // chunks a slice of O holds at most (256 columns)
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kQBox = kBlockM * 128;  // 128 rows x 64 bf16 columns: 16 KB
constexpr int kKBox = kBlockN * 128;  // 64 rows x 64 bf16 columns: 8 KB
constexpr float kLn2 = 0.6931471805599453f;

// kQRes: Q stays in shared memory (D <= 256); NCS: chunks a slice of O
template <bool kQRes, int NCS>
struct Layout {
  static constexpr int kQKStages = kQRes ? 8 : 5;
  static constexpr int kQKStage = kQRes ? kKBox : kKBox + kQBox;  // K chunk (+ Q chunk)
  static constexpr int kVStages = 2;
  static constexpr int kVStage = NCS * kKBox;
  static constexpr int kOffQ = 0;
  static constexpr int kOffQK = kQRes ? NCS * kQBox : 0;
  static constexpr int kOffV = kOffQK + kQKStages * kQKStage;
  static constexpr int kOffBar = kOffV + kVStages * kVStage;
  // barriers: Q full, Q empty, QK full / empty, V full / empty
  static constexpr int kBars = 2 + 2 * kQKStages + 2 * kVStages;
  static constexpr int kBytes = kOffBar + 8 * kBars + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;  // (B*H, Nq) or nullptr
  int H, Nq, Nk, nc, n_slices, n_qt, n_kt, n_items;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // scale * log2(e)
};

// K-major 128-byte-swizzled operand (rows of 64 bf16): 8-row atoms 1 KB apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 1024, kSwizzle128);
}
// V read MN-major: 8 keys a 1 KB group, one 64-column box
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return make_desc(addr, kKBox, 1024, kSwizzle128);
}

template <bool kQRes, int NCS>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<kQRes, NCS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* qk_full = q_empty + 1;
  uint64_t* qk_empty = qk_full + L::kQKStages;
  uint64_t* v_full = qk_empty + L::kQKStages;
  uint64_t* v_empty = v_full + L::kVStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < L::kQKStages; ++s) {
      mbar_init(&qk_full[s], 1);
      mbar_init(&qk_empty[s], kConsumers);
    }
    for (int s = 0; s < L::kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumers);
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
      int t = 0, tv_n = 0, it = 0;  // QK stages, V stages and items issued
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int q0 = (item % p.n_qt) * kBlockM;
        const int grp = item / p.n_qt;
        const int c0 = (grp % p.n_slices) * NCS;
        const int bh = grp / p.n_slices;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const int live = min(NCS, p.nc - c0);
        if constexpr (kQRes) {
          if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
          mbar_arrive_expect_tx(q_full, p.nc * kQBox);
          for (int c = 0; c < p.nc; ++c) {
            tma_load_4d(smem + L::kOffQ + c * kQBox, &tq, q_full, kChunk * c, q0, h, b);
          }
        }
        for (int j = 0; j < p.n_kt; ++j) {
          for (int c = 0; c < p.nc; ++c, ++t) {
            const int s = t % L::kQKStages;
            if (t >= L::kQKStages) mbar_wait(&qk_empty[s], (t / L::kQKStages - 1) & 1);
            uint8_t* stage = smem + L::kOffQK + s * L::kQKStage;
            mbar_arrive_expect_tx(&qk_full[s], L::kQKStage);
            tma_load_4d(stage, &tk, &qk_full[s], kChunk * c, j * kBlockN, h, b);
            if constexpr (!kQRes) {
              tma_load_4d(stage + kKBox, &tq, &qk_full[s], kChunk * c, q0, h, b);
            }
          }
          const int sv = tv_n % L::kVStages;
          if (tv_n >= L::kVStages) mbar_wait(&v_empty[sv], (tv_n / L::kVStages - 1) & 1);
          mbar_arrive_expect_tx(&v_full[sv], live * kKBox);
          for (int c = 0; c < live; ++c) {
            tma_load_4d(smem + L::kOffV + sv * L::kVStage + c * kKBox, &tv, &v_full[sv],
                        kChunk * (c0 + c), j * kBlockN, h, b);
          }
          ++tv_n;
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

  int t = 0, tv_n = 0, it = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
    const int q0 = (item % p.n_qt) * kBlockM;
    const int grp = item / p.n_qt;
    const int slice = grp % p.n_slices;
    const int c0 = slice * NCS;
    const int bh = grp / p.n_slices;
    const int live = min(NCS, p.nc - c0);
    float o[NCS][kChunk / 2];
#pragma unroll
    for (int ch = 0; ch < NCS; ++ch) {
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) o[ch][i] = 0.f;
    }
    float mx[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    if constexpr (kQRes) mbar_wait(q_full, it & 1);
    for (int j = 0; j < p.n_kt; ++j) {
      // S = Q K^T: 64 queries x 64 keys, one commit group a 64-column chunk
      float sc[kBlockN / 2];
      for (int c = 0; c < p.nc; ++c, ++t) {
        const int s = t % L::kQKStages;
        mbar_wait(&qk_full[s], (t / L::kQKStages) & 1);
        const uint32_t k_addr = smem_u32(smem + L::kOffQK + s * L::kQKStage);
        const uint32_t q_addr =
            (kQRes ? smem_u32(smem + L::kOffQ + c * kQBox) : k_addr + kKBox) + wg * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          wgmma_ss<kBlockN, 0, 0>(sc, desc_k(q_addr + kk * 32), desc_k(k_addr + kk * 32),
                                  c + kk > 0 ? 1 : 0);
        }
        wgmma_commit();
        if (c > 0) {  // the previous chunk's products are done: free its stage
          wgmma_wait<1>();
          mbar_arrive(&qk_empty[(t - 1) % L::kQKStages]);
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&qk_empty[(t - 1) % L::kQKStages]);
      if (kQRes && j == p.n_kt - 1) mbar_arrive(q_empty);  // this item's Q is read

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
      for (int ch = 0; ch < NCS; ++ch) {
#pragma unroll
        for (int i = 0; i < kChunk / 2; ++i) o[ch][i] *= alpha[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        sc[i] = exp2_ftz(sc[i] - mnew[(i >> 1) & 1]);
        l[(i >> 1) & 1] += sc[i];
      }

      // O += P V: P from registers (bf16), each 64-column chunk of V MN-major
      uint32_t pa[kBlockN / 16][4];
      acc_to_a<kBlockN>(pa, sc);
      const int sv = tv_n % L::kVStages;
      mbar_wait(&v_full[sv], (tv_n / L::kVStages) & 1);
      const uint32_t v_addr = smem_u32(smem + L::kOffV + sv * L::kVStage);
#pragma unroll
      for (int ch = 0; ch < NCS; ++ch) fence_regs(o[ch]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
        for (int ch = 0; ch < NCS; ++ch) {
          wgmma_rs<kChunk, 1>(o[ch], pa[kk], desc_v(v_addr + ch * kKBox + kk * 16 * 128), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < NCS; ++ch) fence_regs(o[ch]);
      mbar_arrive(&v_empty[sv]);
      ++tv_n;
    }

    // epilogue: O / l through the strides (the slice's live chunks), the LSE
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int b = bh / p.H;
    const int h = bh % p.H;
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh + kChunk * c0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * wg + row + 8 * r;
      if (q >= p.Nq) continue;
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = out + q * p.o_sn;
#pragma unroll
      for (int ch = 0; ch < NCS; ++ch) {
        if (ch >= live) break;
#pragma unroll
        for (int jj = 0; jj < kChunk / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(orow + kChunk * ch + 8 * jj + col) =
              pack_bf16(o[ch][4 * jj + 2 * r] * inv, o[ch][4 * jj + 2 * r + 1] * inv);
        }
      }
      if (p.lse != nullptr && slice == 0 && col == 0) {
        p.lse[static_cast<long long>(bh) * p.Nq + q] = (mx[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

template <bool kQRes, int NCS>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, cudaStream_t stream) {
  using L = Layout<kQRes, NCS>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fwd_wide_kernel<kQRes, NCS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  }
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  fwd_wide_kernel<kQRes, NCS><<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The slice geometry at head_dim D: chunks, slices and chunks a slice.
void slices_of(int D, int* nc, int* n_slices, int* ncs) {
  *nc = D / kChunk;
  *n_slices = (*nc + kMaxSlice - 1) / kMaxSlice;
  *ncs = (*nc + *n_slices - 1) / *n_slices;
}

template <bool kQRes, int NCS>
cudaError_t attrs_of(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fwd_wide_kernel<kQRes, NCS>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = Layout<kQRes, NCS>::kBytes;
  }
  return err;
}

}  // namespace

extern "C" int videogpa_flash_attn_fwd_wide_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D <= 128 || D % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
  int ncs = 0;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  slices_of(D, &p.nc, &p.n_slices, &ncs);
  p.n_qt = (Nq + kBlockM - 1) / kBlockM;
  p.n_kt = (Nk + kBlockN - 1) / kBlockN;
  const long long items = static_cast<long long>(B) * H * p.n_slices * p.n_qt;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.n_items = static_cast<int>(items);
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;

  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = make_tensor_map(&tq, q, D, Nq, H, B, q_sn, q_sh, q_sb, kChunk, kBlockM, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, D, Nk, H, B, k_sn, k_sh, k_sb, kChunk, kBlockN, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, D, Nk, H, B, v_sn, v_sh, v_sb, kChunk, kBlockN, swz);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q_res = p.nc <= kMaxSlice;  // one slice: nc == ncs
  if (q_res) return ncs == 3 ? launch<true, 3>(tq, tk, tv, p, st) : launch<true, 4>(tq, tk, tv, p, st);
  return ncs == 3 ? launch<false, 3>(tq, tk, tv, p, st) : launch<false, 4>(tq, tk, tv, p, st);
}

// The kernel's registers a thread at launch (ptxas; setmaxnreg then moves the
// consumers to 232) and its dynamic shared memory a CTA at head_dim D, for
// reports.
extern "C" int videogpa_flash_attn_fwd_wide_bf16_attrs(int D, int* regs, int* smem_bytes) {
  if (D <= 128 || D % kChunk != 0) return cudaErrorInvalidValue;
  int nc = 0, n_slices = 0, ncs = 0;
  slices_of(D, &nc, &n_slices, &ncs);
  if (nc <= kMaxSlice) return ncs == 3 ? attrs_of<true, 3>(regs, smem_bytes)
                                       : attrs_of<true, 4>(regs, smem_bytes);
  return ncs == 3 ? attrs_of<false, 3>(regs, smem_bytes) : attrs_of<false, 4>(regs, smem_bytes);
}
