// Flash-attention backward on the CUDA cores (sm_90a): the float32 entry of
// K3 at head_dim 16, 32 and 64.
//
// Replaces, for float32 operands, the TPU Pallas backward kernels of
// videogpa_tpu/ops/attention.py `_dq_kernel_T` / `_dkv_kernel_T` (:951, :983;
// calls at :1050, :1064), which the JAX package runs at head_dim < 128. The
// port's wgmma kernels take bf16 only; float32 at head_dim 128 and above runs
// flash_attn_bwd_wide_f32.cu, this kernel's design at 64 columns a CTA with
// the CTAs of one key tile joined in a cluster. Given Q, K, V, O, the
// natural-log LSE of the forward and dO:
//
//   P = exp(S * scale - LSE), S = Q K^T;  delta = rowsum(O * dO)
//   dV = P^T dO;  dS = P * (dO V^T - delta);  dQ = dS K * scale;  dK = dS^T Q * scale
//
// Arithmetic is f32 FMA on the CUDA cores, never TF32: the numbers are the
// JAX package's f32 numbers. Bound: the five products, 10*B*H*Nq*Nk*D
// operations over the 67 TFLOP/s f32 peak; at short rows the bytes of the
// operands over 3.35 TB/s.
//
// Design: a prologue and one fused kernel on one stream.
//  1. The prologue writes delta (B*H, Nq), one thread a query row, and zeroes
//     the dQ turn counters and the work counter.
//  2. The main kernel runs a persistent grid of 128-thread CTAs, two an SM;
//     each CTA takes work items (64-key tile j, b*h) in increasing order from
//     an atomic counter, item = b*h * n_kt + j, keeps the key tile's K and V
//     in shared memory and walks the 64-query tiles of its key tile. Per
//     query tile:
//      - S^T and dP^T (64 keys x 64 queries each) on the CUDA cores: the
//        CTA's first two warps compute S^T, the other two dP^T, each thread
//        an 8-key x 8-query register micro-tile. Shared memory delivers 128
//        bytes a clock and a float4 load of a warp takes four of them however
//        many lanes share an address, so a thread must do 4 FMAs per float it
//        loads to keep the FMA pipes full: an 8 x 8 tile loads 16 float4s for
//        256 FMAs a 4-wide step, exactly that. (A 4 x 4 tile loads 8 for 64
//        and caps a kernel at half the f32 peak; an 8 x 4 tile, 12 for 128,
//        is ``kQueriesPerPass = 4``.) Rows are padded by 16 bytes and lanes
//        read consecutive rows, so no load has a bank conflict.
//      - The first half writes P = exp2(S^T * scale log2 e - LSE log2 e) (one
//        flush-to-zero SFU instruction) to shared memory as [query][key]; the
//        second reads it and writes dS = P (dP - delta) as [query][key].
//      - The first half accumulates dV += P^T dO, the second dK += dS^T Q,
//        8 keys x D/8 columns a thread in registers (8 x 8 at D = 64); then
//        the query tile's dQ partial dS K, 8 queries x D/8 columns a thread
//        and four keys a step, the first half over keys 0-31 and the second
//        over 32-63 (a 4 x 4 tile over all keys would load 1.5 float4s per 16
//        FMAs); the halves swap half of their rows and each adds the first
//        half's sum to the second's for its rows. The halves hand P, dS and
//        the reading of dO to each other by named barriers (one arrives, the
//        other waits), so the first half goes from dV to dQ while the second
//        still runs dK.
//      - Five products: dQ is summed across key tiles, in a fixed order. Each
//        (b*h, query tile) has a turn counter; the CTA of key tile j
//        waits until the counter equals its rank among the tile's
//        contributors, stores its partial into an f32 buffer (rank 0), adds
//        it (red.add) or, as the last contributor, adds the buffer and writes
//        dQ * scale itself; it publishes the next turn (fence, then a release
//        store) after its next tile's products, so the fence finds its adds
//        done. Every dQ element is summed in the same order on every run, so
//        two runs give the same bits, like dK and dV, which one thread sums.
//      - The order: CTA j visits query tile (t - j) mod n_qt at its step t,
//        and a tile's contributors add in the order of (step, j). CTAs that
//        start together never wait on each other: at each step they visit
//        different tiles. That order can make key tile j wait for a later
//        key tile of the same head (tile 0 at step 1 waits on tile n_qt - 1's
//        step 0), an item no CTA may have taken yet. Items are taken in
//        order, so that cannot hang while all of a head's key tiles fit the
//        grid and every CTA of the grid is resident at once: the diagonal
//        grid is started by a cooperative launch, which guarantees that or
//        refuses to start. Otherwise (n_kt > grid, or the cooperative launch
//        refused) the tiles are visited in order and added in order of j,
//        which only waits on items taken earlier, so holds on any residency.
//        On an H100 80GB HBM3 at 700 W the diagonal took 9.8 % less time
//        than the in-order walk at the scorer's frame rows, 18-21 % at a
//        4,096-key row and 14-17 % at head_dim 256 (kernel_ab.py --variant
//        f32_bwd_in_order).
//     The Q and dO tiles are copied by cp.async, in two stages at D <= 32; at
//     64 one stage leaves room for two CTAs an SM, and each covers the
//     other's copies, barriers and turns.
//     Rows past Nq or Nk are never loaded: P and dS are zero there (selects,
//     not products, so garbage in unloaded rows never reaches a sum), the
//     products stop at the tile's last live row, and nothing past them is
//     stored. Operands are addressed through (b, n, h) element strides, so
//     the (B, N, H, D) and (B, H, N, D) layouts and strided views go in
//     without a copy.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBlock = 64;             // keys a work item, queries a tile
constexpr int kThreads = 128;          // two halves of two warps; two CTAs an SM
constexpr int kPStride = kBlock + 4;   // floats a row of P or dS, [query][key]
constexpr int kQueriesPerPass = 8;     // S^T / dP^T micro-tile: 8 keys x this many queries a pass
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA: the key tile's K and V, the stages (Q, dO, the
// query tile's LSE and delta), P and dS. Two stages where two CTAs still fit
// an SM (head_dim <= 32), else one, so that two CTAs fit an SM: at head_dim
// 64 the next tile's copies start as soon as this tile's dV and dK have read
// Q and dO and run under the dQ product and turn.
template <int DC>
struct Cfg {
  static constexpr int kRS = DC + 4;  // floats a tile row (16-byte padded)
  static constexpr int kTileElems = kBlock * kRS;
  static constexpr int kTileBytes = kTileElems * 4;
  static constexpr int kResBytes = 2 * kTileBytes;
  static constexpr int kStageTiles = 2;
  static constexpr int kStages = DC <= 32 ? 2 : 1;
  static constexpr bool kEarly = kStages == 1;  // issue the next stage before dQ
  static constexpr int kStageBytes = kStageTiles * kTileBytes + 2 * kBlock * 4;
  static constexpr int kOffStage = kResBytes;
  static constexpr int kOffP = kOffStage + kStages * kStageBytes;
  static constexpr int kOffDS = kOffP + kBlock * kPStride * 4;
  static constexpr int kBytes = kOffDS + kBlock * kPStride * 4;
  static constexpr int kW = DC / 16;  // contiguous columns a thread holds, twice, DC / 2 apart
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;  // (B*H, Nq), natural log
  float* dq;
  float* dk;
  float* dv;
  float* delta;      // (B*H, Nq), written by the prologue
  float* dq_acc;     // (B*H, n_qt * 64, D): dQ partial sums (unused when n_kt == 1)
  int* turn;         // n_turn dQ turn counters, then the work counter
  int H, Nq, Nk, D, n_qt, n_kt, items, n_turn, diag, vec;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void red_add(float* p, float x) {
  asm volatile("red.relaxed.gpu.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(x) : "memory");
}
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a),
               "f"(b), "f"(c), "f"(d)
               : "memory");
}
// 2^x as one flush-to-zero SFU instruction (P below 2^-126 is zero)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// Named barriers between the CTA's halves (ID 0 is __syncthreads): the
// second half's own (64 threads), and three hand-offs where one half
// arrives and the other waits (128 threads): P written (first to second),
// dS written (second to first), dO read by dV (first to second).
constexpr int kBarSecondHalf = 1, kBarP = 2, kBarDS = 3, kBarDO = 4;
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// four consecutive elements of a shared-memory row
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// dQ's partial sums, W consecutive columns: stored by the first
// contributor, added by the others (one 16-byte operation at W = 4)
template <int W>
__device__ __forceinline__ void store_w(float* p, const float* x) {
  if constexpr (W == 4) {
    __stcg(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) __stcg(p + e, x[e]);
  }
}
template <int W>
__device__ __forceinline__ void red_w(float* p, const float* x) {
  if constexpr (W == 4) {
    red_add4(p, x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) red_add(p + e, x[e]);
  }
}
// W consecutive floats of shared memory, written and read back
template <int W>
__device__ __forceinline__ void sts_w(float* p, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = x[e];
  }
}

// W consecutive floats of a shared-memory row
template <int W>
__device__ __forceinline__ void ldw(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = ld4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) out[e] = p[e];
  }
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [row0, min(row0 + 64, n)) of an operand (row stride sn elements, DC
// contiguous floats from src) into shared-memory rows of kRS floats; rows
// past n are not written. 16-byte copies when every row starts on 16 bytes
// (vec), else 4-byte copies.
template <int DC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn, int row0,
                                          int n, bool vec, int lane0 = threadIdx.x,
                                          int lanes = kThreads) {
  constexpr int kRS = Cfg<DC>::kRS;
  constexpr int kV = 4;
  const int rows = min(kBlock, n - row0);
  src += static_cast<long long>(row0) * sn;
  if (vec) {
    for (int c = lane0; c < rows * (DC / kV); c += lanes) {
      const int r = c / (DC / kV);
      const int d = kV * (c % (DC / kV));
      cp_async_16(dst + r * kRS + d, src + r * sn + d);
    }
  } else {
    for (int c = lane0; c < rows * DC; c += lanes) {
      const int r = c / DC;
      const int d = c % DC;
      cp_async_4(dst + r * kRS + d, src + r * sn + d);
    }
  }
}

// delta = rowsum(O * dO) for every query row, and the counters zeroed
__global__ void __launch_bounds__(256) prologue_kernel(const Params p, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r <= p.n_turn) p.turn[r] = 0;
  if (r >= rows) return;
  const int bh = static_cast<int>(r / p.Nq);
  const int n = static_cast<int>(r % p.Nq);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* o = p.o + b * p.o_sb + h * p.o_sh + n * p.o_sn;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh + n * p.do_sn;
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < p.D; ++d) s = fmaf(o[d], g[d], s);
  p.delta[r] = s;
}

// The rank of key tile j among the contributors to dQ's query tile i, which
// it visits at its step t: the number of key tiles that add before it. In
// the diagonal order they add by (step, key tile), and key tile jj visits
// tile i at step (i + jj) mod n_qt. The steps before t hold the key tiles
// whose residues mod n_qt fill the cyclic interval [-i, t - i) mod n_qt:
// with n_kt = a n_qt + b, a each and one more for each residue below b; at
// step t, the j / n_qt key tiles of j's residue below j come first.
__device__ __forceinline__ int dq_rank(const Params& p, int i, int t, int j) {
  if (!p.diag) return j;
  const int a = p.n_kt / p.n_qt;
  const int b = p.n_kt % p.n_qt;
  const int s0 = (p.n_qt - i) % p.n_qt;
  const int below_b = s0 + t <= p.n_qt ? max(0, min(s0 + t, b) - s0)
                                        : max(0, b - s0) + min(b, s0 + t - p.n_qt);
  return a * t + below_b + j / p.n_qt;
}

template <int DC>
__global__ void __launch_bounds__(kThreads, 2) bwd_kernel(const Params p) {
  using C = Cfg<DC>;
  constexpr int kRS = C::kRS;
  constexpr int kW = C::kW;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half = warp >> 1;  // 0: S^T, P, dV; 1: dP^T, dS, dK
  const int wh = warp & 1;
  const int lr = lane >> 3;
  const int lc = lane & 7;
  // S^T / dP^T: keys kr + 4i (i < 8) x queries lc + 8c (c < 8)
  const int kr = wh * 32 + lr;
  // dV / dK: keys r3 + i (i < 8) x columns lc kW + e and DC / 2 + lc kW + e (e < kW)
  const int r3 = wh * 32 + 8 * lr;
  const int c3 = lc * kW;
  // dQ: queries rq + 4i (i < 8) x the columns of dV / dK; each half sums
  // half of the keys
  const int rq = wh * 32 + lr;
  float* sP = reinterpret_cast<float*>(smem + C::kOffP);
  float* sDS = reinterpret_cast<float*>(smem + C::kOffDS);
  float* resK = reinterpret_cast<float*>(smem);
  float* resV = resK + C::kTileElems;
  const bool vec = p.vec != 0;

  for (;;) {
    __syncthreads();  // the previous item is done with s_item and shared memory
    if (tid == 0) s_item = atomicAdd(p.turn + p.n_turn, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= p.items) return;
    const int j = item % p.n_kt;
    const int bh = item / p.n_kt;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const float* q = p.q + b * p.q_sb + h * p.q_sh;
    const float* k = p.k + b * p.k_sb + h * p.k_sh;
    const float* v = p.v + b * p.v_sb + h * p.v_sh;
    const float* g = p.dout + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + static_cast<long long>(bh) * p.Nq;
    const float* delta = p.delta + static_cast<long long>(bh) * p.Nq;
    const int k0 = j * kBlock;
    const int kn = min(kBlock, p.Nk - k0);  // live keys of this item
    const int n_stages = p.n_qt;  // one stage a query tile
    // the query tile of step t
    auto tile_of = [&](int t) { return p.diag ? ((t - j) % p.n_qt + p.n_qt) % p.n_qt : t; };
    // stage s: the query tile's Q and dO, LSE and delta
    auto issue = [&](int s, int lane0, int lanes) {
      unsigned char* st = smem + C::kOffStage + (s % kStages) * C::kStageBytes;
      float* sQ = reinterpret_cast<float*>(st);
      float* sG = sQ + C::kTileElems;
      float* sL = reinterpret_cast<float*>(st + C::kStageTiles * C::kTileBytes);
      const int q0 = tile_of(s) * kBlock;
      load_tile<DC>(sQ, q, p.q_sn, q0, p.Nq, vec, lane0, lanes);
      load_tile<DC>(sG, g, p.do_sn, q0, p.Nq, vec, lane0, lanes);
      const int qn = min(kBlock, p.Nq - q0);
      for (int r = lane0; r < 2 * kBlock; r += lanes) {  // LSE, then delta
        if (r % kBlock < qn) {
          cp_async_4(sL + r, (r < kBlock ? lse : delta) + q0 + r % kBlock);
        }
      }
    };

    load_tile<DC>(resK, k, p.k_sn, k0, p.Nk, vec);
    load_tile<DC>(resV, v, p.v_sn, k0, p.Nk, vec);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) issue(s, tid, kThreads);
      cp_async_commit();
    }

    float gacc[8][2 * kW];  // dV (first half) or dK (second half)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2 * kW; ++e) gacc[i][e] = 0.f;
    }
    float sacc[8][8];  // S^T (first half) or dP^T (second half)
    int pend = -1, pend_val = 0;  // the turn this CTA has yet to publish

    if constexpr (C::kEarly) {
      issue(0, tid, kThreads);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      if constexpr (!C::kEarly) {
        if (s + kStages - 1 < n_stages) issue(s + kStages - 1, tid, kThreads);
        cp_async_commit();
      }
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const unsigned char* st = smem + C::kOffStage + (s % kStages) * C::kStageBytes;
      const float* sQ = reinterpret_cast<const float*>(st);
      const float* sG = sQ + C::kTileElems;
      const float* sK = resK;
      const float* sV = resV;
      const float* sL = reinterpret_cast<const float*>(st + C::kStageTiles * C::kTileBytes);
      const int t = s;
      const int i_tile = tile_of(t);
      const int q0 = i_tile * kBlock;
      const int qn = min(kBlock, p.Nq - q0);  // live queries of this tile

#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) sacc[i][c] = 0.f;
      }
      // S^T = K Q^T (first half) or dP^T = V dO^T (second half), 8 keys x
      // kQueriesPerPass queries a pass; a warp whose 32 keys are all past Nk
      // has nothing to compute
      if (wh * 32 < kn) {
        const float* ka = (half ? sV : sK) + kr * kRS;
        const float* qa = (half ? sG : sQ) + lc * kRS;
#pragma unroll
        for (int pass = 0; pass < 8 / kQueriesPerPass; ++pass) {
#pragma unroll 1
          for (int d = 0; d < DC; d += 4) {
            float4 x[8], y[kQueriesPerPass];
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = ld4(ka + 4 * i * kRS + d);
#pragma unroll
            for (int c = 0; c < kQueriesPerPass; ++c) {
              y[c] = ld4(qa + 8 * (pass * kQueriesPerPass + c) * kRS + d);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int c = 0; c < kQueriesPerPass; ++c) {
                float& acc = sacc[i][pass * kQueriesPerPass + c];
                acc = dot4(x[i], y[c], acc);
              }
            }
          }
        }
      }

      {
        // publish the previous step's turn: the barrier at this step's top
        // ordered every thread's adds before thread 0's fence and release
        // (as a grid barrier does), and this tile's products gave them time
        if (pend >= 0) {
          if (tid == 0) {
            __threadfence();
            st_release(p.turn + pend, pend_val);
          }
          pend = -1;
        }
        const float scale_log2 = p.scale * kLog2e;
        if (half == 0) {  // P, zero where the key or the query is past its end
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qq = lc + 8 * c;
            const bool q_live = qq < qn;
            const float lq = q_live ? sL[qq] * kLog2e : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int key = kr + 4 * i;
              sP[qq * kPStride + key] =
                  q_live && key < kn ? exp2_ftz(fmaf(sacc[i][c], scale_log2, -lq)) : 0.f;
            }
          }
        }
        if (half == 0) {
          bar_arrive(kBarP, kThreads);
        } else {  // dS = P (dP - delta)
          bar_sync(kBarP, kThreads);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qq = lc + 8 * c;
            const bool q_live = qq < qn;
            const float dl = q_live ? sL[kBlock + qq] : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int key = kr + 4 * i;
              const float pv = sP[qq * kPStride + key];
              sDS[qq * kPStride + key] =
                  q_live && key < kn ? pv * (sacc[i][c] - dl) : 0.f;
            }
          }
          bar_sync(kBarSecondHalf, kThreads / 2);
          bar_arrive(kBarDS, kThreads);
        }
        {  // dV += P^T dO (first half) or dK += dS^T Q (second half)
          const float* coef = (half ? sDS : sP) + r3;
          const float* rhs = (half ? sQ : sG) + c3;
#pragma unroll 2
          for (int qq = 0; qq < qn; ++qq) {
            const float4 a0 = ld4(coef + qq * kPStride);
            const float4 a1 = ld4(coef + qq * kPStride + 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            float r[2 * kW];
            ldw<kW>(rhs + qq * kRS, r);
            ldw<kW>(rhs + qq * kRS + DC / 2, r + kW);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int e = 0; e < 2 * kW; ++e) gacc[i][e] = fmaf(a[i], r[e], gacc[i][e]);
            }
          }
        }
        // the first half waits for dS and lets the second know dO is read;
        // the second, once dO is read (its dK read Q), copies the next tile
        // in (with one stage) while both go on to dQ
        if (half == 0) {
          bar_arrive(kBarDO, kThreads);
          bar_sync(kBarDS, kThreads);
        } else {
          bar_sync(kBarDO, kThreads);
          if constexpr (C::kEarly) {
            if (s + 1 < n_stages) issue(s + 1, tid - kThreads / 2, kThreads / 2);
            cp_async_commit();
          }
        }

        // dQ's partial of this key tile, dS K: the first half sums keys 0-31,
        // the second 32-63, each thread 8 queries x 2 kW columns (8 x 8 at DC
        // = 64), four keys a step; the halves swap half of their rows through
        // P's buffer (read by dV by now), and each adds the two sums, the
        // first half's first, for its four rows
        float dq[8][2 * kW];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2 * kW; ++e) dq[i][e] = 0.f;
        }
        {
          const float* coef = sDS + rq * kPStride;
          const float* rhs = sK + c3;
          const int kb = half * 32;
          const int ke = min(kn, kb + 32);
          const int ke4 = kb + (max(ke - kb, 0) & ~3);
#pragma unroll 1
          for (int key = kb; key < ke4; key += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = ld4(coef + 4 * i * kPStride + key);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float r[2 * kW];
              ldw<kW>(rhs + (key + jj) * kRS, r);
              ldw<kW>(rhs + (key + jj) * kRS + DC / 2, r + kW);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float ai = jj == 0 ? a[i].x : jj == 1 ? a[i].y : jj == 2 ? a[i].z : a[i].w;
#pragma unroll
                for (int e = 0; e < 2 * kW; ++e) dq[i][e] = fmaf(ai, r[e], dq[i][e]);
              }
            }
          }
          for (int key = ke4; key < ke; ++key) {  // the ragged last keys
            float r[2 * kW];
            ldw<kW>(rhs + key * kRS, r);
            ldw<kW>(rhs + key * kRS + DC / 2, r + kW);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float ai = coef[4 * i * kPStride + key];
#pragma unroll
              for (int e = 0; e < 2 * kW; ++e) dq[i][e] = fmaf(ai, r[e], dq[i][e]);
            }
          }
        }
        // rows rq + 4i, columns c3 + e and DC / 2 + c3 + e; the first half
        // keeps rows i < 4 and hands over i >= 4, the second the other way
        float* part = sP + rq * kPStride + c3;
        const int mine = half * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i >> 2) != half) {
            sts_w<kW>(part + 4 * i * kPStride, dq[i]);
            sts_w<kW>(part + 4 * i * kPStride + DC / 2, dq[i] + kW);
          }
        }

        // wait for this tile's turn; the first contributor finds it open
        const int tix = bh * p.n_qt + i_tile;
        const int rank = dq_rank(p, i_tile, t, j);
        if (tid == 0 && rank > 0) {
          while (ld_acquire(p.turn + tix) != rank) __nanosleep(32);
        }
        __syncthreads();
        {
          float sum[4][2 * kW];  // the first half's partial plus the second's
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float other[2 * kW];
            ldw<kW>(part + 4 * (mine + i) * kPStride, other);
            ldw<kW>(part + 4 * (mine + i) * kPStride + DC / 2, other + kW);
#pragma unroll
            for (int e = 0; e < 2 * kW; ++e) {
              const float x = half == 0 ? dq[i][e] : dq[4 + i][e];
              sum[i][e] = half == 0 ? x + other[e] : other[e] + x;
            }
          }
          float* acc = p.dq_acc +
                       (static_cast<long long>(bh) * p.n_qt * kBlock + q0 + rq + 4 * mine) * p.D +
                       c3;
          if (rank == p.n_kt - 1) {  // the last contributor writes dQ
            float* out = p.dq + b * p.dq_sb + h * p.dq_sh + c3;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = q0 + rq + 4 * (mine + i);
              if (row >= p.Nq) continue;
#pragma unroll
              for (int e = 0; e < 2 * kW; ++e) {
                const int col = e < kW ? e : DC / 2 + e - kW;
                float x = sum[i][e];
                if (rank > 0) x = __ldcg(acc + 4 * i * p.D + col) + x;
                out[row * p.dq_sn + col] = x * p.scale;
              }
            }
          } else if (rank == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              store_w<kW>(acc + 4 * i * p.D, sum[i]);
              store_w<kW>(acc + 4 * i * p.D + DC / 2, sum[i] + kW);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              red_w<kW>(acc + 4 * i * p.D, sum[i]);
              red_w<kW>(acc + 4 * i * p.D + DC / 2, sum[i] + kW);
            }
          }
        }
        pend = tix;
        pend_val = rank + 1;
      }
      // this stage's buffers are rewritten by the next issue (with the early
      // issue they were read before it, and P and dS are rewritten only
      // after the next step's top barrier)
      if constexpr (!C::kEarly) __syncthreads();
    }
    __syncthreads();
    if (tid == 0 && pend >= 0) {
      __threadfence();
      st_release(p.turn + pend, pend_val);
    }

    // dV (first half) or dK * scale (second half) of the live keys
    float* dst = (half ? p.dk : p.dv) + b * (half ? p.dk_sb : p.dv_sb) +
                 h * (half ? p.dk_sh : p.dv_sh) + c3;
    const long long sn = half ? p.dk_sn : p.dv_sn;
    const float mul = half ? p.scale : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + r3 + i;
      if (key >= p.Nk) continue;
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        dst[key * sn + e] = gacc[i][e] * mul;
        dst[key * sn + DC / 2 + e] = gacc[i][kW + e] * mul;
      }
    }
  }
}

template <int DC>
cudaError_t launch(Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DC>;
  // the shared-memory opt-in and the occupancy once a device
  static int per_sm[64] = {}, sm_count[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int occ = device < 64 ? per_sm[device] : 0;
  int sms = device < 64 ? sm_count[device] : 0;
  if (occ == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_kernel<DC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, bwd_kernel<DC>, kThreads,
                                                          C::kBytes);
    }
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    if (device < 64) {
      per_sm[device] = occ;
      sm_count[device] = sms;
    }
  }
  const long long bh = static_cast<long long>(B) * p.H;
  const long long items = bh * p.n_kt;
  const long long n_turn = bh * p.n_qt;
  const long long rows = bh * p.Nq;
  const long long cover = rows > n_turn + 1 ? rows : n_turn + 1;
  if (items > INT_MAX || n_turn >= INT_MAX || (cover + 255) / 256 > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  p.items = static_cast<int>(items);
  p.n_turn = static_cast<int>(n_turn);
  const long long cap = static_cast<long long>(sms) * occ;
  const int grid = static_cast<int>(items < cap ? items : cap);
  p.diag = p.n_kt > 1 && p.n_kt <= grid ? 1 : 0;
  prologue_kernel<<<static_cast<unsigned int>((cover + 255) / 256), 256, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.diag) {
    // the diagonal walk needs the whole grid resident at once: a cooperative
    // launch starts it only so, or refuses it (fewer SMs than counted, as
    // under an MPS limit), and then the in-order walk runs instead
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_kernel<DC>),
                                      dim3(grid), dim3(kThreads), args, C::kBytes, stream);
    if (err != cudaErrorCooperativeLaunchTooLarge) return err;
    (void)cudaGetLastError();
    p.diag = 0;
  }
  bwd_kernel<DC><<<grid, kThreads, C::kBytes, stream>>>(p);
  return cudaGetLastError();
}

int entry(const void* q, const void* k, const void* v, const void* o, const void* dout,
          const void* lse, void* dq, void* dk, void* dv, void* delta, void* dq_acc, void* turn,
          int B, int H, int Nq, int Nk, int D, const long long* st, float scale, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.turn = static_cast<int*>(turn);
  p.H = H; p.Nq = Nq; p.Nk = Nk; p.D = D;
  p.n_qt = (Nq + kBlock - 1) / kBlock;
  p.n_kt = (Nk + kBlock - 1) / kBlock;
  p.q_sb = st[0]; p.q_sn = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sn = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sn = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_sn = st[10]; p.o_sh = st[11];
  p.do_sb = st[12]; p.do_sn = st[13]; p.do_sh = st[14];
  p.dq_sb = st[15]; p.dq_sn = st[16]; p.dq_sh = st[17];
  p.dk_sb = st[18]; p.dk_sn = st[19]; p.dk_sh = st[20];
  p.dv_sb = st[21]; p.dv_sn = st[22]; p.dv_sh = st[23];
  p.scale = scale;
  // 16-byte copies when every row of the four staged operands starts on 16 bytes
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (int i : {0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14}) vec = vec && st[i] % 4 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int DC>
cudaError_t attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, bwd_kernel<DC>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = Cfg<DC>::kBytes;
  }
  return err;
}

}  // namespace

#define VIDEOGPA_BWD_ARGS                                                                       \
  const void *q, const void *k, const void *v, const void *o, const void *dout,                \
      const void *lse, void *dq, void *dk, void *dv, void *delta, void *dq_acc, void *turn,    \
      int B, int H, int Nq, int Nk, int D, long long q_sb, long long q_sn, long long q_sh,     \
      long long k_sb, long long k_sn, long long k_sh, long long v_sb, long long v_sn,          \
      long long v_sh, long long o_sb, long long o_sn, long long o_sh, long long do_sb,         \
      long long do_sn, long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh,     \
      long long dk_sb, long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,     \
      long long dv_sh, float scale, void *stream
#define VIDEOGPA_BWD_STRIDES                                                                    \
  const long long st[24] = {q_sb,  q_sn,  q_sh,  k_sb,  k_sn,  k_sh,  v_sb,  v_sn,             \
                            v_sh,  o_sb,  o_sn,  o_sh,  do_sb, do_sn, do_sh, dq_sb,            \
                            dq_sn, dq_sh, dk_sb, dk_sn, dk_sh, dv_sb, dv_sn, dv_sh}

// float32 at head_dim 16, 32 or 64 (128 and above: flash_attn_bwd_wide_f32.cu)
extern "C" int videogpa_flash_attn_bwd_f32(VIDEOGPA_BWD_ARGS) {
  VIDEOGPA_BWD_STRIDES;
  return entry(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc, turn, B, H, Nq, Nk, D, st,
               scale, stream);
}

// The main kernel's registers a thread and dynamic shared memory a CTA at
// head_dim D, for reports.
extern "C" int videogpa_flash_attn_bwd_f32_attrs(int D, int* regs, int* smem_bytes) {
  switch (D) {
    case 16: return attrs<16>(regs, smem_bytes);
    case 32: return attrs<32>(regs, smem_bytes);
    case 64: return attrs<64>(regs, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}
