// int8-QK flash-attention forward with a float32 V for Hopper (sm_90a),
// inference only:
//   S = int32(q8 k8^T) * sq[row] * sk[col]   (already in the base-2 log domain)
//   O = softmax2(S) V,  P and P V in f32
// q8, k8: int8 rows with one f32 scale per row (sq, sk, from
// ops/attention.py::quantize_qk_int8); V and O: float32.
//
// Replaces K8 `_fwd_kernel_T8` (videogpa_tpu/ops/attention.py:640, call at
// :732) on float32 operands: that kernel casts P to V's dtype, so with an f32
// V it keeps P and P V in f32, which the bf16 wgmma kernels of
// flash_attn_int8.cu cannot. `attention(impl="flash_int8")` runs it for
// float32 operands at head_dim 16, 32, 64 and 128 (65-127 zero-padded to 128).
//
// Bound: 2*B*H*Nq*Nk*D int8 operations over the 1,979 TOP/s int8 peak plus
// 2*B*H*Nq*Nk*D f32 operations over the 67 TFLOP/s f32 peak: P V in f32 on
// the CUDA cores is nearly all of it (at (4, 13,740, 16, 64) 23.09 of 23.86
// ms).
//
// Design: S on the int8 tensor cores, P V on the CUDA cores.
//  - A persistent grid of one CTA an SM walks the work items (kWGs x 128
//    query rows, b*h) in order item = b*h * n_q_tiles + query tile, CTA c
//    taking items c, c + grid, ... A producer warpgroup (its first warp
//    works, setmaxnreg down) and kWGs consumer warpgroups of 128 queries
//    each: three at head_dim <= 64, two at 128.
//  - The producer's first thread issues the TMA copies of each item's Q8
//    tile (one box of 128 rows a warpgroup; two buffers) and of 64-key K8
//    tiles, as flash_attn_int8.cu does (an int8 row of D is byte for byte a
//    bf16 row of D / 2; at head_dim 16 a 32-byte box whose upper half TMA
//    fills with zeros); its warp copies the tile's key scales (4-byte
//    cp.async) and the f32 V tile (16-byte cp.async where every row starts
//    on 16 bytes, else 4-byte; keys >= Nk filled with zeros) into a
//    two-stage ring, arriving on mbarriers.
//  - Each consumer warpgroup computes S = Q8 K8^T, 64 queries x 64 keys at a
//    time, with `wgmma ... m64n64k32.s32.s8.s8`: integer sums are exact, so
//    the scores are those of the CUDA-core __dp4a kernel this one replaced,
//    bit for bit. It converts them (float(s) * sq) * sk (one I2F a score),
//    runs the exact base-2 online softmax in the accumulator layout (row
//    max over the four lanes of a row; 2^x as one flush-to-zero ex2, which
//    differs from exp2f only below 2^-126), and writes P^T [key][query] and
//    each row's rescale to shared memory (one buffer a warpgroup, written
//    between two warpgroup barriers: once the previous tile's P V has read
//    it, and before this tile's P V reads it).
//  - P V: each thread holds 8 queries x kTC columns of O (8 x 8 at head_dim
//    64, 8 x 16 at 128) and, for each key, loads two float4 of P^T and kTC
//    / 4 float4 of V: 64 FMAs per 16 floats at 8 x 8, the 4 FMAs per float
//    that shared memory's 128 bytes a clock need to keep the FMA pipes busy
//    (the kernel this one replaced used a 4 x 4 tile: 2 FMAs per float).
//    Lanes of a warp read one V row, 16 bytes apart, and P^T rows padded by
//    16 bytes: no bank conflict. O / l at the end, l summed in the
//    accumulator layout and handed over through shared memory.
//  Measured on an H100 80GB HBM3 at 700 W at (4, 13,740, 16, 64), each
//  design against the one before it in one call (kernel_ab.py --int8-f32;
//  the reverted choices are kernel_ab.py variants where they are one edit
//  of this source): two consumer warpgroups with double-buffered P^T, 46.3
//  ms (the kernel it replaced: 67.2); the two taking turns at P V, so that
//  one's softmax runs under the other's P V, 46.3 against 45.8; 8 x 16 tiles
//  at 256 queries a warpgroup (three quarters of shared memory's rate),
//  48.2 against 46.0; three warpgroups (this design) 43.8 against 45.5-46.4
//  for two (variant int8_f32_two_consumer_wgs; 17.7 against 22.1 at head_dim
//  16); the integer-add conversion instead of I2F, 44.0 against 43.9
//  (int8_f32_magic); a three-stage ring, 43.7 against 43.8
//  (int8_f32_three_stages). The times at head_dim 16, 32 and 64 (17.7,
//  25.9, 43.8) put about 10 ms outside P V (the scores, the softmax and
//  their barriers) and P V at about two thirds of the f32 peak.
//  Queries >= Nq are computed on TMA's zero rows and not stored; keys >= Nk
//  are masked to -inf on the last tile. Operands are addressed through
//  rank-4 tensor maps (q8, k8) and (b, n, h) element strides (sq, sk, V, O),
//  in either layout; nothing is padded on the host.
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

constexpr int kBlockN = 64;  // keys a tile

// Three consumer warpgroups of 128 queries at head_dim <= 64 (8 x D / 8
// tiles: 8 x 8 at 64), two at 128 (8 x 16 tiles; three do not leave the
// registers for them); the producer warpgroup after them. setmaxnreg: the
// consumers take what the producer gives up (65,536 a CTA).
template <int D>
struct Layout {
  static constexpr int kWGs = D == 128 ? 2 : 3;     // consumer warpgroups
  static constexpr int kStages = 2;                 // K8 / V ring depth
  static constexpr int kConsumers = 128 * kWGs;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = kWGs == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 232;
  static constexpr int kQW = 128;                   // queries a consumer warpgroup
  static constexpr int kBlockM = kWGs * kQW;        // queries an item
  static constexpr int kMBlocks = kQW / 64;         // m64 S products a warpgroup a tile
  static constexpr int kNCG = 8;                    // column groups of P V
  static constexpr int kTC = D / kNCG;              // O columns a thread: 2, 4, 8, 16
  static constexpr int kPS = kQW + 4;               // floats a row of P^T
  // Q8 / K8: rows of D bytes, 32 at head_dim 16 (the TMA box's zero half)
  static constexpr int kRow8 = D < 32 ? 32 : D;
  static constexpr int kAtom8 = 8 * kRow8;
  static constexpr int kSwizzle8 =
      kRow8 == 128 ? kSwizzle128 : kRow8 == 64 ? kSwizzle64 : kSwizzle32;
  static constexpr int kTileQ = kBlockM * kRow8;
  static constexpr int kTileK = kBlockN * kRow8;
  static constexpr int kTileV = kBlockN * D * 4;
  static constexpr int kPT = kBlockN * kPS * 4;  // the P^T buffer of a warpgroup
  static constexpr int kQ = 0;                   // two Q8 buffers
  static constexpr int kK = kQ + 2 * kTileQ;
  static constexpr int kV = kK + kStages * kTileK;
  static constexpr int kP = kV + kStages * kTileV;      // P^T of each warpgroup
  static constexpr int kAlpha = kP + kWGs * kPT;        // the rescales of each warpgroup
  static constexpr int kL = kAlpha + kWGs * kQW * 4;    // the row sums of each warpgroup
  static constexpr int kSk = kL + kWGs * kQW * 4;       // kStages x 64 key scales
  static constexpr int kBar = kSk + kStages * kBlockN * 4;
  // barriers: Q full[2], Q empty[2], K full[kStages], V full[kStages], K/V empty[kStages]
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;
  static_assert((kTC == 2 || kTC % 4 == 0) && kNCG * kQW / 8 == 128, "P V: 8 x kTC a thread");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
  static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "registers");
};

struct Params {
  const float* sq;
  const float* sk;
  const float* v;
  float* o;
  int H, Nq, Nk, n_qt, n_kt, n_items, vec;
  long long sq_sb, sq_sn, sq_sh;
  long long sk_sb, sk_sn, sk_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
};

// Q8 or K8 read K-major (flash_attn_int8.cu's descriptor)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, Layout<D>::kAtom8, Layout<D>::kSwizzle8);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    int8_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const Params p) {
  using L = Layout<D>;
  constexpr int kQBufs = 2;
  constexpr int kStages = L::kStages;
  constexpr int kConsumers = L::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* k_full = q_empty + kQBufs;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;
  float* sk_smem = reinterpret_cast<float*>(smem + L::kSk);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1 + 32);  // the TMA thread's expect-tx + the scale copies of one warp
      mbar_init(&v_full[s], 32);      // the V copies of one warp
      mbar_init(&kv_empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first warp copies, one thread issues TMA ----
    reg_dealloc<L::kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (lane < 32) {
      if (lane == 0) {
        tma_prefetch(&tq);
        tma_prefetch(&tk);
      }
      const bool vec = p.vec != 0;
      int t = 0;  // key tiles issued, over all items
      int it = 0;
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
        const int bh = item / p.n_qt;
        const int q0 = (item % p.n_qt) * L::kBlockM;
        const int b = bh / p.H;
        const int h = bh % p.H;
        const float* sk = p.sk + b * p.sk_sb + h * p.sk_sh;
        const float* v = p.v + b * p.v_sb + h * p.v_sh;
        const int qs = it % kQBufs;
        if (lane == 0) {
          if (it >= kQBufs) mbar_wait(&q_empty[qs], (it / kQBufs - 1) & 1);
          mbar_arrive_expect_tx(&q_full[qs], L::kTileQ);
          for (int r = 0; r < L::kBlockM; r += L::kQW) {  // a box of 128 rows a warpgroup
            tma_load_4d(smem + L::kQ + qs * L::kTileQ + r * L::kRow8, &tq, &q_full[qs], 0,
                        q0 + r, h, b);
          }
        }
        for (int j = 0; j < p.n_kt; ++j, ++t) {
          const int s = t % kStages;
          const int key0 = j * kBlockN;
          if (t >= kStages) mbar_wait(&kv_empty[s], (t / kStages - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(&k_full[s], L::kTileK);
            tma_load_4d(smem + L::kK + s * L::kTileK, &tk, &k_full[s], 0, key0, h, b);
          }
          // the tile's key scales; keys >= Nk read as 0 (their scores are masked)
#pragma unroll
          for (int u = 0; u < kBlockN / 32; ++u) {
            const int key = key0 + 32 * u + lane;
            const bool valid = key < p.Nk;
            cp_async_4(sk_smem + s * kBlockN + 32 * u + lane, sk + (valid ? key * p.sk_sn : 0),
                       valid);
          }
          cp_async_mbar_arrive(&k_full[s]);
          // the V tile, [key][D] floats; keys >= Nk as zeros
          float* vt = reinterpret_cast<float*>(smem + L::kV + s * L::kTileV);
          if (vec) {
            for (int c = lane; c < kBlockN * (D / 4); c += 32) {
              const int r = c / (D / 4);
              const int d = 4 * (c % (D / 4));
              const bool valid = key0 + r < p.Nk;
              cp_async_16(vt + r * D + d, v + (valid ? (key0 + r) * p.v_sn + d : 0), valid);
            }
          } else {
            for (int c = lane; c < kBlockN * D; c += 32) {
              const int r = c / D;
              const int d = c % D;
              const bool valid = key0 + r < p.Nk;
              cp_async_4(vt + r * D + d, v + (valid ? (key0 + r) * p.v_sn + d : 0), valid);
            }
          }
          cp_async_mbar_arrive(&v_full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: kQW query rows each ----
  reg_alloc<L::kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  // S, the accumulator layout: rows row, row + 8 of each 64-row block;
  // keys col, col + 1 of every 8
  const int row = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  // P V: queries 8 qg + 0..7 of the warpgroup's, columns 4 cg + 4 kNCG m +
  // 0..3 of O (m < kTC / 4)
  const int cg = tw % L::kNCG;
  const int qg = tw / L::kNCG;
  float* pt = reinterpret_cast<float*>(smem + L::kP + wg * L::kPT);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kAlpha) + wg * L::kQW;
  float* l_s = reinterpret_cast<float*>(smem + L::kL) + wg * L::kQW;
  const int bar_id = 1 + wg;  // this warpgroup's named barrier

  int t = 0;
  int it = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++it) {
    const int bh = item / p.n_qt;
    const int q0 = (item % p.n_qt) * L::kBlockM + wg * L::kQW;  // this warpgroup's first query
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int qs = it % kQBufs;
    const uint32_t q_addr = smem_u32(smem + L::kQ + qs * L::kTileQ) + wg * L::kQW * L::kRow8;
    // this thread's query scales in the accumulator layout (1 past Nq, not stored)
    float sq[L::kMBlocks][2];
#pragma unroll
    for (int mb = 0; mb < L::kMBlocks; ++mb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 64 * mb + row + 8 * r;
        sq[mb][r] = q < p.Nq ? p.sq[b * p.sq_sb + q * p.sq_sn + h * p.sq_sh] : 1.f;
      }
    }
    float o[8][L::kTC];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < L::kTC; ++e) o[i][e] = 0.f;
    }
    float mx[L::kMBlocks][2], l[L::kMBlocks][2];  // running max and this thread's row sums
#pragma unroll
    for (int mb = 0; mb < L::kMBlocks; ++mb) {
      mx[mb][0] = mx[mb][1] = -INFINITY;
      l[mb][0] = l[mb][1] = 0.f;
    }

    mbar_wait(&q_full[qs], (it / kQBufs) & 1);
    for (int j = 0; j < p.n_kt; ++j, ++t) {
      const int s = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_addr = smem_u32(smem + L::kK + s * L::kTileK);
      const float* skt = sk_smem + s * kBlockN;
      const int key0 = j * kBlockN;

      mbar_wait(&k_full[s], phase);
#pragma unroll
      for (int mb = 0; mb < L::kMBlocks; ++mb) {
        // S = Q8 K8^T: 64 queries x 64 keys in s32, both operands K-major
        int si[kBlockN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kRow8 / 32; ++kk) {
          wgmma_ss_s8_n64(si, desc_k<D>(q_addr + 64 * mb * L::kRow8 + kk * 32),
                          desc_k<D>(k_addr + kk * 32), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(si);

        // S = (s * sq) * sk; keys >= Nk (last tile only) at -inf
        float sc[kBlockN / 2];
#pragma unroll
        for (int c = 0; c < kBlockN / 8; ++c) {
          const float2 skv = *reinterpret_cast<const float2*>(skt + 8 * c + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * c + e] = static_cast<float>(si[4 * c + e]) * sq[mb][e >> 1] *
                            ((e & 1) ? skv.y : skv.x);
          }
        }
        if (key0 + kBlockN > p.Nk) {
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) {
            if (key0 + 8 * (i / 4) + col + (i & 1) >= p.Nk) sc[i] = -INFINITY;
          }
        }
        // the online softmax: new row max, rescale, P, this thread's row sums
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
        }
        float alpha[2], mnew[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          mnew[r] = fmaxf(mx[mb][r], tmax[r]);        // finite: key0 < Nk
          alpha[r] = exp2_ftz(mx[mb][r] - mnew[r]);  // 0 on the first tile
          mx[mb][r] = mnew[r];
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2_ftz(sc[i] - mnew[r]);
          rs[r] += sc[i];
        }
        // the previous tile's P V has read P^T and the rescales
        if (mb == 0) named_barrier_sync<128>(bar_id);
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          pt[(8 * (i / 4) + col + (i & 1)) * L::kPS + 64 * mb + row + 8 * ((i >> 1) & 1)] = sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[mb][r] = l[mb][r] * alpha[r] + rs[r];
          if ((lane & 3) == 0) alpha_s[64 * mb + row + 8 * r] = alpha[r];
        }
      }
      if (j == p.n_kt - 1) mbar_arrive(&q_empty[qs]);  // this item's Q8 is read
      named_barrier_sync<128>(bar_id);                 // P^T and the rescales are written

      // O = O * alpha + P V in f32: 8 queries x kTC columns a thread
      {
        const float4 a0 = ld4(alpha_s + 8 * qg);
        const float4 a1 = ld4(alpha_s + 8 * qg + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < L::kTC; ++e) o[i][e] *= a[i];
        }
      }
      mbar_wait(&v_full[s], phase);
      const float* vt = reinterpret_cast<const float*>(smem + L::kV + s * L::kTileV) +
                        (L::kTC == 2 ? 2 : 4) * cg;
      const float* pq = pt + 8 * qg;
#pragma unroll 4
      for (int key = 0; key < kBlockN; ++key) {
        const float4 p0 = ld4(pq + key * L::kPS);
        const float4 p1 = ld4(pq + key * L::kPS + 4);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float vv[L::kTC];
        if constexpr (L::kTC == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vt + key * D);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
#pragma unroll
          for (int m = 0; m < L::kTC / 4; ++m) {
            const float4 x = ld4(vt + key * D + 4 * L::kNCG * m);
            vv[4 * m] = x.x;
            vv[4 * m + 1] = x.y;
            vv[4 * m + 2] = x.z;
            vv[4 * m + 3] = x.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < L::kTC; ++e) o[i][e] = fmaf(pr[i], vv[e], o[i][e]);
        }
      }
      mbar_arrive(&kv_empty[s]);
    }

    // epilogue: the row sums over the four lanes of a row, handed over
    // through shared memory; O / l through the strides
#pragma unroll
    for (int mb = 0; mb < L::kMBlocks; ++mb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = l[mb][r];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if ((lane & 3) == 0) l_s[64 * mb + row + 8 * r] = x;
      }
    }
    named_barrier_sync<128>(bar_id);
    float* out = p.o + b * p.o_sb + h * p.o_sh + (L::kTC == 2 ? 2 : 4) * cg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = q0 + 8 * qg + i;
      if (q >= p.Nq) continue;
      const float inv = 1.f / l_s[8 * qg + i];
      float* orow = out + q * p.o_sn;
      if constexpr (L::kTC == 2) {
        *reinterpret_cast<float2*>(orow) = make_float2(o[i][0] * inv, o[i][1] * inv);
      } else {
#pragma unroll
        for (int m = 0; m < L::kTC / 4; ++m) {
          *reinterpret_cast<float4*>(orow + 4 * L::kNCG * m) =
              make_float4(o[i][4 * m] * inv, o[i][4 * m + 1] * inv, o[i][4 * m + 2] * inv,
                          o[i][4 * m + 3] * inv);
        }
      }
    }
  }
}

CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// strides: (b, n, h) of q8, sq, k8, sk, v, o in that order
template <int D>
cudaError_t launch(const void* q8, const void* k8, Params p, int B, const long long* st,
                   cudaStream_t stream) {
  using L = Layout<D>;
  p.n_qt = (p.Nq + L::kBlockM - 1) / L::kBlockM;
  p.n_kt = (p.Nk + kBlockN - 1) / kBlockN;
  const long long items = static_cast<long long>(B) * p.H * p.n_qt;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.n_items = static_cast<int>(items);
  CUtensorMap tq, tk;
  cudaError_t err = make_tensor_map(&tq, q8, D, p.Nq, p.H, B, st[1], st[2], st[0], L::kRow8,
                                    L::kQW, swizzle_for(L::kRow8), true);
  if (err == cudaSuccess)
    err = make_tensor_map(&tk, k8, D, p.Nk, p.H, B, st[7], st[8], st[6], L::kRow8, kBlockN,
                          swizzle_for(L::kRow8), true);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
  if (err != cudaSuccess) return err;
  const int grid = p.n_items < sms ? p.n_items : sms;
  int8_f32_kernel<D><<<grid, L::kThreads, L::kBytes, stream>>>(tq, tk, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, int8_f32_kernel<D>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = Layout<D>::kBytes;
  }
  return err;
}

}  // namespace

// K8's interface (flash_attn_int8.cu); strides: (b, n, h) of q8, sq, k8, sk,
// v, o in that order. q8 and k8 must meet TMA's rule (the wrapper checks).
extern "C" int videogpa_flash_attn_int8_f32(
    const void* q8, const void* sq, const void* k8, const void* sk, const void* v, void* o,
    int B, int H, int Nq, int Nk, int D, long long q_sb, long long q_sn, long long q_sh,
    long long sq_sb, long long sq_sn, long long sq_sh, long long k_sb, long long k_sn,
    long long k_sh, long long sk_sb, long long sk_sn, long long sk_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1) return cudaErrorInvalidValue;
  const long long st[18] = {q_sb,  q_sn,  q_sh,  sq_sb, sq_sn, sq_sh, k_sb, k_sn, k_sh,
                            sk_sb, sk_sn, sk_sh, v_sb,  v_sn,  v_sh,  o_sb, o_sn, o_sh};
  Params p;
  p.sq = static_cast<const float*>(sq);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.H = H; p.Nq = Nq; p.Nk = Nk;
  p.sq_sb = sq_sb; p.sq_sn = sq_sn; p.sq_sh = sq_sh;
  p.sk_sb = sk_sb; p.sk_sn = sk_sn; p.sk_sh = sk_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  // V by 16 bytes when every row starts on 16 bytes, else by 4; O is the
  // wrapper's new contiguous tensor
  bool vec = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long s : {v_sb, v_sn, v_sh}) vec = vec && s % 4 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q8, k8, p, B, st, s);
    case 32: return launch<32>(q8, k8, p, B, st, s);
    case 64: return launch<64>(q8, k8, p, B, st, s);
    case 128: return launch<128>(q8, k8, p, B, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// registers a thread at launch (ptxas; setmaxnreg then moves the consumers
// to kConsumerRegs) and dynamic shared memory a CTA at head_dim D, for reports
extern "C" int videogpa_flash_attn_int8_f32_attrs(int D, int* regs, int* smem_bytes) {
  switch (D) {
    case 16: return attrs<16>(regs, smem_bytes);
    case 32: return attrs<32>(regs, smem_bytes);
    case 64: return attrs<64>(regs, smem_bytes);
    case 128: return attrs<128>(regs, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}
