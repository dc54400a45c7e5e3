// Flash-attention backward at head_dim > 128 in bf16 for Hopper (sm_90a):
// dQ, dK, dV of O = softmax(Q K^T * scale) V, non-causal, f32 accumulation.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py `_dq_kernel`
// and `_dkv_kernel` (:883, :908, called at :1110, :1131 from `_flash_bwd`
// :1089), which the JAX package runs at every head_dim >= 128. Same function
// and the same split, recomputed from the forward's natural-log LSE:
//   P  = exp(S - LSE),  S = Q K^T * scale
//   dV = P^T dO                        (P rounded to bf16, :919-923)
//   dS = P * (dO V^T - delta),  delta = rowsum(O * dO)
//   dQ = dS K * scale,  dK = dS^T Q * scale   (dS rounded to bf16, :894-899,
//                                              :929-934)
// Nq may differ from Nk.
//
// Bound: tensor-core operations. The two-kernel split computes seven Nq x Nk
// x D products a head (S and dP in both kernels), 14*B*H*Nq*Nk*D; at (1,
// 4,096, 16, 256) that is 0.962 TFLOP, 0.97 ms at the 989 TFLOP/s bf16 dense
// peak (the five-product function's own bound is 0.695 ms).
//
// Design: a prologue and two kernels of one template on one stream. Neither
// kernel sums across CTAs, so dQ, dK and dV are the same bits on every run
// (K7's one-kernel design adds dQ by bulk reduce-adds, which is not
// deterministic).
//  1. The prologue writes delta = rowsum(O * dO) in f32 and the base-2 LSE
//     into (B*H, Nq padded to 64) buffers, one warp a row; padded rows get
//     LSE2 = +inf, so P = 0 there.
//  2. Both kernels hold a fixed 64-row tile and stream 64-row tiles of the
//     other side: the dK/dV kernel fixes a key tile (X = K, Y = V) and
//     streams the query tiles (U = Q, W = dO); the dQ kernel fixes a query
//     tile (X = Q, Y = dO) and streams the key tiles (U = K, W = V). For each
//     streamed tile:
//       A1 = X U^T, A2 = Y W^T                      SS-wgmma over all of D
//       P = exp2(A1 * scale log2 e - LSE2), dS = P (A2 - delta)
//       dV += P dO and dK += dS Q (dK/dV), or dQ += dS K (dQ)   SS-wgmma
//     (in the dK/dV kernel A1 = S^T, P = P^T, dS = dS^T, rows are keys).
//     Each consumer warpgroup computes A1 and A2 for 32 of the streamed
//     tile's 64 rows (N = 32), so S and dP are computed once a tile with no
//     exchange of f32 values; it writes its half of P and dS to shared memory
//     as bf16 [fixed row][streamed row] tiles (128-byte swizzled, double
//     buffered so one named barrier a tile suffices), and the gradient
//     products read them as K-major A operands with the streamed tile's
//     chunks as MN-major B operands.
//  3. One CTA a (fixed tile, slice, b*h) on a flat grid (any B*H), one
//     producer warpgroup (setmaxnreg 40; one thread issues every copy) and
//     two consumer warpgroups (232 registers). A slice is at most 256
//     columns of the gradients (four 64-column chunks: D <= 256 is one
//     slice); the consumer warpgroups own alternate chunks, so a warpgroup
//     holds at most 2 x 64 x 64 f32 of each gradient, 128 registers a thread
//     for dK and dV. Above 256 columns, the nc chunks are cut into
//     ceil(nc / 4) slices, each recomputing A1 and A2.
//  4. Operands move by TMA in 64 x 64 boxes (128 bytes a row, 128-byte
//     swizzle) from rank-4 tensor maps over (D, N, H, B) with element
//     strides, so both layouts and strided views go in without a copy.
//     Each ring stage holds one 64-column chunk of U and W (16 KB) or, above
//     256 columns, of U, W, X and Y (32 KB); at D <= 256 the fixed tile's X
//     and Y stay in shared memory, loaded once. A streamed tile's chunks come
//     in the order: the other slices' chunks first, then the slice's own.
//     The others' stages are freed as soon as their products are done; the
//     slice's stay for the gradient products and are freed after them, so
//     the ring (one stage more than a slice's chunks) never waits on a stage
//     that its consumer still holds for a later chunk. The dK/dV kernel's
//     stages carry the query tile's LSE2 and delta (bulk copies on the last
//     chunk's barrier); the dQ kernel loads its fixed tile's once.
//  5. Keys >= Nk (TMA's zero rows) get P = 0 by a mask; queries >= Nq get
//     P = 0 through their LSE2 = +inf. Nothing past Nq or Nk is stored.
//  Shared memory, 1,024-byte aligned: dK/dV at D <= 256, X and Y 64 KB +
//  6 x 16 KB ring + P and dS 2 x 16 KB + statistics 3 KB = 195 KB; above,
//  5 x 32 KB + 32 KB + 2.5 KB = 194.5 KB; the dQ kernel 16 KB less (no P
//  tile): one CTA an SM (`videogpa_flash_attn_bwd_wide_bf16_attrs`).
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

constexpr int kBlock = 64;     // rows of a fixed and of a streamed tile
constexpr int kChunk = 64;     // columns a box
constexpr int kMaxSlice = 4;   // chunks a slice of the gradients holds at most
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kBox = kBlock * 128;  // 64 rows x 64 bf16 columns: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// kDkv: the dK/dV kernel (else dQ); kRes: the fixed tile stays in shared
// memory (D <= 256)
template <bool kDkv, bool kRes>
struct Layout {
  static constexpr int kStages = kRes ? 6 : 5;
  static constexpr int kOffU = 0, kOffW = kBox, kOffX = 2 * kBox, kOffY = 3 * kBox;
  static constexpr int kStage = (kRes ? 2 : 4) * kBox;
  static constexpr int kOffFixed = 0;  // X: kMaxSlice boxes, then Y
  static constexpr int kOffRing = kRes ? 2 * kMaxSlice * kBox : 0;
  static constexpr int kTiles = kDkv ? 2 : 1;  // bf16 tiles a buffer: dS (and P)
  static constexpr int kOffE = kOffRing + kStages * kStage;
  static constexpr int kOffStats = kOffE + 2 * kTiles * kBox;
  // LSE2 and delta (64 floats each): a set a stage (dK/dV), one set (dQ)
  static constexpr int kStatSets = kDkv ? kStages : 1;
  static constexpr int kOffBar = kOffStats + kStatSets * 2 * kBlock * 4;
  // barriers: fixed full, full[kStages], empty[kStages]
  static constexpr int kBytes = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

struct Params {
  const float* lse2;   // (B*H, Nq_pad) base-2 LSE, +inf on padded rows
  const float* delta;  // (B*H, Nq_pad)
  __nv_bfloat16* g1;   // dV (dK/dV kernel)
  __nv_bfloat16* g2;   // dK (dK/dV kernel) or dQ
  long long g1_sb, g1_sn, g1_sh;
  long long g2_sb, g2_sn, g2_sh;
  int H, Nk, Nq_pad, nc, n_slices, ncs, n_fixed, n_stream, fixed_rows;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e)
};

// K-major 128-byte-swizzled operand (rows of 64 bf16): 8-row atoms 1 KB apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 1024, kSwizzle128);
}
// MN-major 128-byte-swizzled operand: 8 reduction rows a 1 KB group, one
// 64-column box
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return make_desc(addr, kBox, 1024, kSwizzle128);
}

// The chunk at position k of a streamed tile of nc chunks: the other slices'
// chunks first in increasing order, then the slice's own [c0, c0 + live).
__device__ __forceinline__ int chunk_at(int k, int nc, int c0, int live) {
  const int others = nc - live;
  return k < others ? (k < c0 ? k : k + live) : c0 + k - others;
}

// ---- prologue: delta and LSE2, one warp a row ----
__global__ void __launch_bounds__(256) bwd_wide_prologue(
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse, float* lse2,
    float* delta, int H, int Nq, int Nq_pad, int D, long long rows, long long o_sb, long long o_sn,
    long long o_sh, long long do_sb, long long do_sn, long long do_sh) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = static_cast<int>(row / Nq_pad);
  const int q = static_cast<int>(row % Nq_pad);
  const int b = bh / H;
  const int h = bh % H;
  float d = 0.f;
  if (q < Nq) {
    const __nv_bfloat16* orow = o + b * o_sb + q * o_sn + h * o_sh;
    const __nv_bfloat16* drow = dout + b * do_sb + q * do_sn + h * do_sh;
    for (int e = 8 * lane; e < D; e += 256) {  // 16-byte loads: eight bf16 a lane
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + e);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + e);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 c = __bfloat1622float2(d2[i]);
        d = fmaf(a.x, c.x, d);
        d = fmaf(a.y, c.y, d);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  if (lane == 0) {
    lse2[row] = q < Nq ? lse[static_cast<long long>(bh) * Nq + q] * kLog2e : INFINITY;
    delta[row] = d;
  }
}

// ---- the dK/dV and dQ kernels ----
template <bool kDkv, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_wide_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
                    const Params p) {
  using L = Layout<kDkv, kRes>;
  constexpr bool kFixedLoad = kRes || !kDkv;  // the fixed tile's operands or statistics
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* fixed_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* full = fixed_full + 1;
  uint64_t* empty = full + L::kStages;
  float* stats = reinterpret_cast<float*>(smem + L::kOffStats);

  // flat grid: fixed tile fastest, then the slice, then b*h
  const int f_tile = static_cast<int>(blockIdx.x % p.n_fixed);
  const int grp = static_cast<int>(blockIdx.x / p.n_fixed);
  const int c0 = (grp % p.n_slices) * p.ncs;
  const int bh = grp / p.n_slices;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int f0 = f_tile * kBlock;
  const int live = min(p.ncs, p.nc - c0);

  if (threadIdx.x == 0) {
    mbar_init(fixed_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
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
      tma_prefetch(&tu);
      tma_prefetch(&tw);
      tma_prefetch(&tx);
      tma_prefetch(&ty);
      if constexpr (kFixedLoad) {
        const uint32_t bytes = (kRes ? 2 * p.nc * kBox : 0) + (kDkv ? 0 : 2 * kBlock * 4);
        mbar_arrive_expect_tx(fixed_full, bytes);
        if constexpr (kRes) {
          for (int c = 0; c < p.nc; ++c) {
            tma_load_4d(smem + L::kOffFixed + c * kBox, &tx, fixed_full, kChunk * c, f0, h, b);
            tma_load_4d(smem + L::kOffFixed + (kMaxSlice + c) * kBox, &ty, fixed_full,
                        kChunk * c, f0, h, b);
          }
        }
        if constexpr (!kDkv) {
          const long long at = static_cast<long long>(bh) * p.Nq_pad + f0;
          bulk_load(stats, p.lse2 + at, kBlock * 4, fixed_full);
          bulk_load(stats + kBlock, p.delta + at, kBlock * 4, fixed_full);
        }
      }
      int t = 0;
      for (int st = 0; st < p.n_stream; ++st) {
        for (int k = 0; k < p.nc; ++k, ++t) {
          const int c = chunk_at(k, p.nc, c0, live);
          const int s = t % L::kStages;
          if (t >= L::kStages) mbar_wait(&empty[s], (t / L::kStages - 1) & 1);
          uint8_t* stage = smem + L::kOffRing + s * L::kStage;
          const bool with_stats = kDkv && k == p.nc - 1;
          mbar_arrive_expect_tx(&full[s], L::kStage + (with_stats ? 2 * kBlock * 4 : 0));
          tma_load_4d(stage + L::kOffU, &tu, &full[s], kChunk * c, st * kBlock, h, b);
          tma_load_4d(stage + L::kOffW, &tw, &full[s], kChunk * c, st * kBlock, h, b);
          if constexpr (!kRes) {
            tma_load_4d(stage + L::kOffX, &tx, &full[s], kChunk * c, f0, h, b);
            tma_load_4d(stage + L::kOffY, &ty, &full[s], kChunk * c, f0, h, b);
          }
          if (with_stats) {
            const long long at = static_cast<long long>(bh) * p.Nq_pad + st * kBlock;
            float* set = stats + s * 2 * kBlock;
            bulk_load(set, p.lse2 + at, kBlock * 4, &full[s]);
            bulk_load(set + kBlock, p.delta + at, kBlock * 4, &full[s]);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  reg_alloc<232>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;  // fixed rows row, row + 8 of the tile
  const int col = 2 * (lane % 4);        // columns col, col + 1 of every 8
  const uint32_t ring = smem_u32(smem + L::kOffRing);
  const uint32_t fixed = smem_u32(smem + L::kOffFixed);

  // the gradients of this warpgroup's chunks c0 + wg, c0 + wg + 2: g1 = dV
  // (dK/dV only), g2 = dK or dQ
  float g1[2][kChunk / 2], g2[2][kChunk / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) g1[m][i] = g2[m][i] = 0.f;
  }
  bool key_ok[2] = {true, true};  // dK/dV: the fixed rows are keys
  float row_lse2[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};  // dQ: the fixed rows' statistics
  if constexpr (kFixedLoad) mbar_wait(fixed_full, 0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kDkv) {
      key_ok[r] = f0 + row + 8 * r < p.Nk;
    } else {
      row_lse2[r] = stats[row + 8 * r];
      row_delta[r] = stats[kBlock + row + 8 * r];
    }
  }

  int t = 0;
  for (int st = 0; st < p.n_stream; ++st) {
    const int t0 = t;
    // A1 = X U^T and A2 = Y W^T: 64 fixed rows x this warpgroup's 32 streamed rows
    const int others = p.nc - live;  // the slice's chunks come last, at k >= others
    float a1[16], a2[16];
    for (int k = 0; k < p.nc; ++k, ++t) {
      const int s = t % L::kStages;
      mbar_wait(&full[s], (t / L::kStages) & 1);
      const int c = chunk_at(k, p.nc, c0, live);
      const uint32_t stage = ring + s * L::kStage;
      const uint32_t x_addr = kRes ? fixed + c * kBox : stage + L::kOffX;
      const uint32_t y_addr = kRes ? fixed + (kMaxSlice + c) * kBox : stage + L::kOffY;
      const uint32_t u_addr = stage + L::kOffU + wg * 32 * 128;
      const uint32_t w_addr = stage + L::kOffW + wg * 32 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wgmma_ss<32, 0, 0>(a1, desc_k(x_addr + kk * 32), desc_k(u_addr + kk * 32),
                           k + kk > 0 ? 1 : 0);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        wgmma_ss<32, 0, 0>(a2, desc_k(y_addr + kk * 32), desc_k(w_addr + kk * 32),
                           k + kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      if (k < others) {  // another slice's chunk: free its stage once its products are done
        wgmma_wait<0>();
        mbar_arrive(&empty[s]);
      }
    }
    wgmma_wait<0>();
    fence_regs(a1);
    fence_regs(a2);

    // P and dS; the streamed rows of this warpgroup are 32 wg + 8 (i / 4) + col + (i & 1)
    const float* set = stats + (kDkv ? ((t0 + p.nc - 1) % L::kStages) * 2 * kBlock : 0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const int sr = 32 * wg + 8 * (i / 4) + col + (i & 1);
      bool ok;
      float l2, dl;
      if constexpr (kDkv) {
        ok = key_ok[r];
        l2 = set[sr];
        dl = set[kBlock + sr];
      } else {
        ok = st * kBlock + sr < p.Nk;
        l2 = row_lse2[r];
        dl = row_delta[r];
      }
      const float pe = ok ? exp2_ftz(fmaf(a1[i], p.scale_log2, -l2)) : 0.f;
      a1[i] = pe;
      a2[i] = pe * (a2[i] - dl);
    }
    // bf16 dS (and P) as [fixed row][streamed row], 128-byte swizzled
    uint8_t* e_ds = smem + L::kOffE + ((st & 1) * L::kTiles + L::kTiles - 1) * kBox;
    uint8_t* e_p = smem + L::kOffE + (st & 1) * L::kTiles * kBox;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int fr = row + 8 * r;
        const int off = fr * 128 + (((4 * wg + jj) ^ (fr & 7)) * 16) + col * 2;
        *reinterpret_cast<uint32_t*>(e_ds + off) = pack_bf16(a2[4 * jj + 2 * r], a2[4 * jj + 2 * r + 1]);
        if constexpr (kDkv) {
          *reinterpret_cast<uint32_t*>(e_p + off) = pack_bf16(a1[4 * jj + 2 * r], a1[4 * jj + 2 * r + 1]);
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync<kConsumers>(1);

    // the gradient products of this warpgroup's chunks: g2 += dS U, g1 += P W
    const uint32_t ds_addr = smem_u32(e_ds);
    const uint32_t p_addr = smem_u32(e_p);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = wg + 2 * m;  // the slice's chunk c0 + i, at position others + i
      if (i < live) {
        const uint32_t stage = ring + ((t0 + others + i) % L::kStages) * L::kStage;
        fence_regs(g2[m]);
        if constexpr (kDkv) fence_regs(g1[m]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk) {
          wgmma_ss<kChunk, 0, 1>(g2[m], desc_k(ds_addr + kk * 32),
                                 desc_mn(stage + L::kOffU + kk * 16 * 128), 1);
        }
        if constexpr (kDkv) {
#pragma unroll
          for (int kk = 0; kk < kBlock / 16; ++kk) {
            wgmma_ss<kChunk, 0, 1>(g1[m], desc_k(p_addr + kk * 32),
                                   desc_mn(stage + L::kOffW + kk * 16 * 128), 1);
          }
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      fence_regs(g2[m]);
      if constexpr (kDkv) fence_regs(g1[m]);
    }
    for (int k = others; k < p.nc; ++k) mbar_arrive(&empty[(t0 + k) % L::kStages]);
  }

  // epilogue: dK * scale and dV, or dQ * scale, bf16 through the strides
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int i = wg + 2 * m;
    if (i >= live) continue;
    const int c = kChunk * (c0 + i);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int fr = f0 + row + 8 * r;
      if (fr >= p.fixed_rows) continue;
      __nv_bfloat16* r2 = p.g2 + b * p.g2_sb + fr * p.g2_sn + h * p.g2_sh + c;
#pragma unroll
      for (int jj = 0; jj < kChunk / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(r2 + 8 * jj + col) =
            pack_bf16(g2[m][4 * jj + 2 * r] * p.scale, g2[m][4 * jj + 2 * r + 1] * p.scale);
      }
      if constexpr (kDkv) {
        __nv_bfloat16* r1 = p.g1 + b * p.g1_sb + fr * p.g1_sn + h * p.g1_sh + c;
#pragma unroll
        for (int jj = 0; jj < kChunk / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(r1 + 8 * jj + col) =
              pack_bf16(g1[m][4 * jj + 2 * r], g1[m][4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

template <bool kDkv, bool kRes>
cudaError_t launch(const CUtensorMap& tu, const CUtensorMap& tw, const CUtensorMap& tx,
                   const CUtensorMap& ty, const Params& p, long long ctas, cudaStream_t stream) {
  constexpr int bytes = Layout<kDkv, kRes>::kBytes;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_wide_kernel<kDkv, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  bwd_wide_kernel<kDkv, kRes><<<static_cast<unsigned int>(ctas), kThreads, bytes, stream>>>(
      tu, tw, tx, ty, p);
  return cudaGetLastError();
}

template <bool kDkv, bool kRes>
cudaError_t attrs_of(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, bwd_wide_kernel<kDkv, kRes>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = Layout<kDkv, kRes>::kBytes;
  }
  return err;
}

}  // namespace

extern "C" int videogpa_flash_attn_bwd_wide_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* scratch, int B, int H, int Nq, int Nk,
    int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long o_sb,
    long long o_sn, long long o_sh, long long do_sb, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sn,
    long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh, float scale,
    void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D <= 128 || D % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BH = static_cast<long long>(B) * H;
  const int n_qt = (Nq + kBlock - 1) / kBlock;
  const int n_kt = (Nk + kBlock - 1) / kBlock;
  Params p;
  p.H = H;
  p.Nk = Nk;
  p.Nq_pad = n_qt * kBlock;
  p.nc = D / kChunk;
  p.n_slices = (p.nc + kMaxSlice - 1) / kMaxSlice;
  p.ncs = (p.nc + p.n_slices - 1) / p.n_slices;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + BH * p.Nq_pad;
  p.lse2 = lse2;
  p.delta = delta;

  CUtensorMap tq, tk, tv, tdo;
  const CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = make_tensor_map(&tq, q, D, Nq, H, B, q_sn, q_sh, q_sb, kChunk, kBlock, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tdo, dout, D, Nq, H, B, do_sn, do_sh, do_sb, kChunk, kBlock, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k, D, Nk, H, B, k_sn, k_sh, k_sb, kChunk, kBlock, swz);
  if (err == cudaSuccess)
    err = make_tensor_map(&tv, v, D, Nk, H, B, v_sn, v_sh, v_sb, kChunk, kBlock, swz);
  if (err != cudaSuccess) return err;

  const long long rows = BH * p.Nq_pad;
  if ((rows + 7) / 8 > 0x7fffffffLL) return cudaErrorInvalidValue;
  bwd_wide_prologue<<<static_cast<unsigned int>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), lse2, delta, H, Nq, p.Nq_pad, D, rows, o_sb, o_sn, o_sh,
      do_sb, do_sn, do_sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool res = p.nc <= kMaxSlice;
  // dK/dV: fixed key tiles, streamed query tiles (U = Q, W = dO, X = K, Y = V)
  Params pk = p;
  pk.g1 = static_cast<__nv_bfloat16*>(dv);
  pk.g2 = static_cast<__nv_bfloat16*>(dk);
  pk.g1_sb = dv_sb; pk.g1_sn = dv_sn; pk.g1_sh = dv_sh;
  pk.g2_sb = dk_sb; pk.g2_sn = dk_sn; pk.g2_sh = dk_sh;
  pk.n_fixed = n_kt;
  pk.n_stream = n_qt;
  pk.fixed_rows = Nk;
  const long long kv_ctas = BH * p.n_slices * n_kt;
  err = res ? launch<true, true>(tq, tdo, tk, tv, pk, kv_ctas, st)
            : launch<true, false>(tq, tdo, tk, tv, pk, kv_ctas, st);
  if (err != cudaSuccess) return err;

  // dQ: fixed query tiles, streamed key tiles (U = K, W = V, X = Q, Y = dO)
  Params pq = p;
  pq.g1 = nullptr;
  pq.g2 = static_cast<__nv_bfloat16*>(dq);
  pq.g1_sb = pq.g1_sn = pq.g1_sh = 0;
  pq.g2_sb = dq_sb; pq.g2_sn = dq_sn; pq.g2_sh = dq_sh;
  pq.n_fixed = n_qt;
  pq.n_stream = n_kt;
  pq.fixed_rows = Nq;
  const long long q_ctas = BH * p.n_slices * n_qt;
  return res ? launch<false, true>(tk, tv, tq, tdo, pq, q_ctas, st)
             : launch<false, false>(tk, tv, tq, tdo, pq, q_ctas, st);
}

// Registers a thread at launch (ptxas; setmaxnreg then moves the consumers to
// 232) and dynamic shared memory a CTA of the dK/dV kernel (dkv = 1) or the dQ
// kernel (dkv = 0) at head_dim D, for reports.
extern "C" int videogpa_flash_attn_bwd_wide_bf16_attrs(int D, int dkv, int* regs,
                                                        int* smem_bytes) {
  if (D <= 128 || D % kChunk != 0) return cudaErrorInvalidValue;
  const bool res = D / kChunk <= kMaxSlice;
  if (dkv) return res ? attrs_of<true, true>(regs, smem_bytes) : attrs_of<true, false>(regs, smem_bytes);
  return res ? attrs_of<false, true>(regs, smem_bytes) : attrs_of<false, false>(regs, smem_bytes);
}
