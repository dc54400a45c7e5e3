// Flash-attention backward on the CUDA cores at head_dim >= 128 in float32
// (sm_90a): dQ, dK, dV of O = softmax(Q K^T * scale) V, non-causal.
//
// Replaces, for float32 operands, the TPU Pallas kernels of
// videogpa_tpu/ops/attention.py `_dq_kernel` / `_dkv_kernel` (:883, :908;
// calls at :1110, :1131), which the JAX package runs at every D >= 128 (here
// any multiple of 64 from 128). bf16 operands above 128 run on the tensor
// cores (flash_attn_bwd_wide.cu); head_dim 16-64 in f32 runs
// flash_attn_bwd_f32.cu. Given Q, K, V, O, the natural-log LSE of the
// forward and dO:
//
//   P = exp(S * scale - LSE), S = Q K^T;  delta = rowsum(O * dO)
//   dV = P^T dO;  dS = P * (dO V^T - delta);  dQ = dS K * scale;  dK = dS^T Q * scale
//
// Arithmetic is f32 FMA on the CUDA cores, never TF32: the numbers are the
// JAX package's f32 numbers. Bound: the five products, 10*B*H*Nq*Nk*D
// operations over the 67 TFLOP/s f32 peak; at (1, 4,096, 16, 256) 10.26 ms.
//
// Design: flash_attn_bwd_f32.cu's fused kernel at head_dim 64, run for
// each 64-column chunk of D by a "slot" of 128 threads, two slots a CTA and
// the CTAs of one key tile joined in a thread block cluster. The f32
// gradients of a 64-key tile at D = 256 are 128 KB, half an SM's registers,
// so no slot can hold all of them; the kernel this one replaced cut them
// into 64-column slices, each slice's CTA computing S and dP again over all
// of D: 4 N^2 D operations a slice for S and dP, 22 N^2 D in all at D = 256,
// 38 at 512. Here the contraction is cut the same way as the gradients, so
// S and dP are computed once for each (key tile, query tile) pair over all
// of D, and the five products take 10 N^2 D operations at any D up to 1,024
// (the JAX package's two-kernel split takes 14):
//  1. A prologue writes delta (B*H, Nq), one thread a query row, and zeroes
//     the dQ turn counters and the work counter.
//  2. The main kernel runs a persistent grid of clusters of ceil(nc / 2)
//     CTAs of 256 threads (nc = D / 64 chunks; one CTA an SM; at most 8 a
//     cluster, the portable limit). Slot s of cluster CTA r owns chunk 2 r +
//     s of dQ, dK and dV (at D = 192 the last slot owns none and adds
//     nothing). A cluster takes work items (64-key tile j, b*h) in
//     increasing order from an atomic counter (its first CTA takes the item
//     and writes it into each CTA's shared memory), and walks the 64-query
//     tiles of its key tile. Per query tile:
//      - Each slot computes the partial S^T = K Q^T and dP^T = V dO^T over
//        its own 64 columns (flash_attn_bwd_f32.cu's 8-key x 8-query
//        register micro-tiles: 4 FMAs per float loaded); slot 1 hands its
//        partial to slot 0 through shared memory, which adds it to its own
//        and writes the CTA's sum to the exchange buffer (16 float4 a
//        thread, in its threads' order); the cluster synchronises, and slot
//        0 reads the sums of every CTA of the cluster (distributed shared
//        memory, 16-byte loads) and adds them in the order of the CTAs'
//        ranks, so every CTA has the same S^T and dP^T bits and every run
//        the same sums. The buffer is written again only after the next
//        step's cluster wait (arrive now, wait then), so one cluster barrier
//        a step suffices, and each CTA reads one sum for each two chunks:
//        the first design, one chunk a 128-thread CTA (two an SM) with the
//        exchange in P's and dS's buffers and two cluster barriers a step,
//        took 35.3 ms at (1, 4,096, 16, 256) (19.5 TFLOP/s), where the
//        head_dim-64 kernel runs at 32.7 (5.26 ms at (1, 4,096, 16, 64));
//        this one took 25.2 (H100 80GB HBM3, 700 W; kernel_ab.py --wide and
//        --f32-bwd).
//      - Slot 0 writes P and dS to shared memory; then each slot, as at
//        head_dim 64, accumulates dV += P^T dO and dK += dS^T Q and computes
//        the query tile's dQ partial dS K over its columns, and dQ is summed
//        across key tiles in a fixed order under per-(b*h, chunk, query
//        tile) turn counters, so two runs are bit-equal.
//     Above D = 1,024 the nc chunks are cut into g = ceil(nc / 16) groups,
//     and a work item is (key tile, group, b*h): slot s sums the
//     contraction over the chunks s, s + S, ... (S the cluster's slots;
//     streamed with K and V, the chunk whose gradients it owns last) and owns
//     chunk group * S + s if there is one. S and dP are then computed g
//     times: 4 g N^2 D + 6 N^2 D operations.
//     The walk: while a head's key tiles fit the grid the key tiles visit
//     the query tiles diagonally (key tile j visits query tile (t - j) mod
//     n_qt at its step t; a tile's contributors add in the order of (step,
//     j)), started by a cooperative launch, which guarantees that the whole
//     grid is resident or refuses to start; otherwise, or where the card
//     refuses a cooperative launch of clusters, the tiles are visited in
//     order and added in order of j, which waits only on items taken
//     earlier (flash_attn_bwd_f32.cu has the argument). Within a cluster
//     each slot's turn waits only on the same chunk of earlier items, and
//     the cluster barriers order all CTAs of a cluster by step, so the
//     argument holds for clusters as it does for CTAs. The card starts the
//     cooperative launch of clusters; at (1, 4,096, 16, 256) its 66
//     clusters hold a head's 64 key tiles, and the diagonal took 25.05 ms
//     against 25.42 in order (kernel_ab.py --variant f32_bwd_wide_in_order).
//  3. At D <= 1,024 a slot's K and V chunks stay in shared memory for the
//     item and the query tile's Q and dO chunks come by cp.async in one
//     stage, issued before the dQ product; above, each stage brings a chunk
//     of Q, dO, K and V.
//  Rows past Nq or Nk are never loaded: P and dS are zero there (selects,
//  not products), the products stop at the tile's last live row, and
//  nothing past them is stored. Operands are addressed through (b, n, h)
//  element strides, so both layouts and strided views go in without a copy.
//  Shared memory: 207,872 bytes a CTA.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBlock = 64;                    // keys a work item, queries a tile
constexpr int kSubThreads = 128;              // a slot: two halves of two warps
constexpr int kSlots = 2;                     // slots a CTA
constexpr int kThreads = kSlots * kSubThreads;  // one CTA an SM
constexpr int kChunk = 64;                    // columns a slot's share of D
constexpr int kMaxCluster = 8;                // CTAs a cluster at most (the portable limit)
constexpr int kPStride = kBlock + 4;  // floats a row of P or dS, [query][key]
constexpr int kRS = kChunk + 4;       // floats a row of a tile (16-byte padded)
constexpr int kTileElems = kBlock * kRS;
constexpr int kTileBytes = kTileElems * 4;
constexpr int kW = kChunk / 16;  // contiguous columns a thread holds, twice, 32 apart
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA: for each slot, kStream = false (D <= 1,024) the
// key tile's K and V chunks and one stage of the query tile's Q and dO
// chunks with its LSE and delta, kStream = true one stage of Q, dO, K and V
// chunks; then P and dS, which both slots read, and the exchange of the
// CTA's sum of the partial S^T and dP^T (128 threads x 64 floats).
template <bool kStream>
struct Cfg {
  static constexpr int kResBytes = kStream ? 0 : 2 * kTileBytes;
  static constexpr int kStageTiles = kStream ? 4 : 2;
  static constexpr int kStageBytes = kStageTiles * kTileBytes + 2 * kBlock * 4;
  static constexpr int kSubBytes = kResBytes + kStageBytes;
  static constexpr int kOffP = kSlots * kSubBytes;
  static constexpr int kOffDS = kOffP + kBlock * kPStride * 4;
  static constexpr int kOffX = kOffDS + kBlock * kPStride * 4;
  static constexpr int kBytes = kOffX + kSubThreads * 64 * 4;
  static_assert(kBytes <= 232448 - 1024, "shared memory of one CTA");
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
  int H, Nq, Nk, D, nc, n_groups, cluster, n_qt, n_kt, items, n_turn, diag, vec;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// Named barriers (ID 0 is __syncthreads): P written (slot 0's first half
// arrives, its second half waits), P and dS written, dO read by a slot's dV
// (3, 4: its first half arrives, its second waits), P and dS read, a slot's
// own (6, 7), slot 1's partial handed to slot 0.
constexpr int kBarP = 1, kBarReady = 2, kBarDO = 3, kBarSwap = 5, kBarSlot = 6, kBarLocal = 8;
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread block clusters ----
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// Every thread of every CTA of the cluster: the shared-memory writes before
// a thread's arrival (local and remote) are seen by the reads after any
// thread's wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The address of `p` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster(uint32_t a, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void ld4_to(const float* p, float* out) {
  const float4 x = ld4(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void st4_from(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [row0, min(row0 + 64, n)) of an operand (row stride sn elements, 64
// contiguous floats from src) into shared-memory rows of kRS floats; rows
// past n are not written. 16-byte copies when every row starts on 16 bytes
// (vec), else 4-byte copies.
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long sn, int row0,
                                          int n, bool vec, int lane0 = threadIdx.x,
                                          int lanes = kThreads) {
  const int rows = min(kBlock, n - row0);
  src += static_cast<long long>(row0) * sn;
  if (vec) {
    for (int c = lane0; c < rows * (kChunk / 4); c += lanes) {
      const int r = c / (kChunk / 4);
      const int d = 4 * (c % (kChunk / 4));
      cp_async_16(dst + r * kRS + d, src + r * sn + d);
    }
  } else {
    for (int c = lane0; c < rows * kChunk; c += lanes) {
      const int r = c / kChunk;
      const int d = c % kChunk;
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
// it visits at its step t (flash_attn_bwd_f32.cu's closed form): j in the
// in-order walk; in the diagonal one the number of key tiles that add
// before it by (step, key tile).
__device__ __forceinline__ int dq_rank(const Params& p, int i, int t, int j) {
  if (!p.diag) return j;
  const int a = p.n_kt / p.n_qt;
  const int b = p.n_kt % p.n_qt;
  const int s0 = (p.n_qt - i) % p.n_qt;
  const int below_b = s0 + t <= p.n_qt ? max(0, min(s0 + t, b) - s0)
                                        : max(0, b - s0) + min(b, s0 + t - p.n_qt);
  return a * t + below_b + j / p.n_qt;
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) bwd_wide_kernel(const Params p) {
  using C = Cfg<kStream>;
  constexpr bool kEarly = !kStream;  // issue the next stage before dQ
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int sub = tid / kSubThreads;  // this CTA's slot of the two
  const int st = tid % kSubThreads;   // the thread within its slot
  const int warp = st >> 5;
  const int lane = st & 31;
  const int half = warp >> 1;  // 0: S^T, P, dV; 1: dP^T, dS, dK
  const int wh = warp & 1;
  const int lr = lane >> 3;
  const int lc = lane & 7;
  // S^T / dP^T: keys kr + 4i (i < 8) x queries lc + 8c (c < 8)
  const int kr = wh * 32 + lr;
  // dV / dK: keys r3 + i (i < 8) x columns c3 + e and 32 + c3 + e (e < 4)
  const int r3 = wh * 32 + 8 * lr;
  const int c3 = lc * kW;
  // dQ: queries rq + 4i (i < 8) x the columns of dV / dK; each half sums
  // half of the keys
  const int rq = wh * 32 + lr;
  const int rank = cluster_rank();
  const int slot = kSlots * rank + sub;
  const int n_slots = kSlots * p.cluster;
  unsigned char* mine = smem + sub * C::kSubBytes;
  float* resK = reinterpret_cast<float*>(mine);
  float* resV = resK + kTileElems;
  float* sP = reinterpret_cast<float*>(smem + C::kOffP);
  float* sDS = reinterpret_cast<float*>(smem + C::kOffDS);
  float4* xch = reinterpret_cast<float4*>(smem + C::kOffX);  // the partials' exchange
  // LSE and delta of the query tile: slot 0's stage (its threads write P and dS)
  const float* sL = reinterpret_cast<const float*>(smem + C::kResBytes +
                                                   C::kStageTiles * kTileBytes);
  const bool vec = p.vec != 0;
  // stages a step, the same for both slots: the contraction chunks slot,
  // slot + n_slots, ... (past nc: a stage with nothing to copy or compute)
  const int n_ch = kStream ? (p.nc + n_slots - 1) / n_slots : 1;

  for (;;) {
    cluster_sync();  // the cluster is done with the previous item and s_item
    if (rank == 0 && tid == 0) {
      const int taken = atomicAdd(p.turn + p.n_turn, 1);
      for (int r = 0; r < p.cluster; ++r) st_cluster(cluster_addr(&s_item, r), taken);
    }
    cluster_sync();
    const int item = s_item;
    if (item >= p.items) return;
    const int j = item % p.n_kt;
    const int grp = kStream ? item / p.n_kt % p.n_groups : 0;
    const int bh = kStream ? item / p.n_kt / p.n_groups : item / p.n_kt;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int chunk = grp * n_slots + slot;  // the gradient columns this slot owns
    const bool owner = chunk < p.nc;
    const float* q = p.q + b * p.q_sb + h * p.q_sh;
    const float* k = p.k + b * p.k_sb + h * p.k_sh;
    const float* v = p.v + b * p.v_sb + h * p.v_sh;
    const float* g = p.dout + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + static_cast<long long>(bh) * p.Nq;
    const float* delta = p.delta + static_cast<long long>(bh) * p.Nq;
    const int k0 = j * kBlock;
    const int kn = min(kBlock, p.Nk - k0);  // live keys of this item
    const int col0 = chunk * kChunk;
    const int n_stages = p.n_qt * n_ch;
    // the query tile of step t
    auto tile_of = [&](int t) { return p.diag ? ((t - j) % p.n_qt + p.n_qt) % p.n_qt : t; };
    // the contraction chunk of stage u of a step: those this slot does not
    // own first, its own last (it stays for the gradient products)
    auto chunk_at = [&](int u) {
      int w = u;
      if (owner) w = u == n_ch - 1 ? grp : (u < grp ? u : u + 1);
      return slot + n_slots * w;
    };
    // stage s = step * n_ch + u of this slot: the query tile's Q and dO
    // chunk (and the K and V chunks when streamed); slot 0 also copies the
    // tile's LSE and delta with the last chunk
    auto issue = [&](int s, int lane0, int lanes) {
      unsigned char* stg = mine + C::kResBytes;
      float* sQ = reinterpret_cast<float*>(stg);
      float* sG = sQ + kTileElems;
      float* sLw = reinterpret_cast<float*>(stg + C::kStageTiles * kTileBytes);
      const int u = s % n_ch;
      const int ch = kStream ? chunk_at(u) : slot;
      const int q0 = tile_of(s / n_ch) * kBlock;
      if (ch < p.nc) {
        load_tile(sQ, q + ch * kChunk, p.q_sn, q0, p.Nq, vec, lane0, lanes);
        load_tile(sG, g + ch * kChunk, p.do_sn, q0, p.Nq, vec, lane0, lanes);
        if constexpr (kStream) {
          load_tile(sG + kTileElems, k + ch * kChunk, p.k_sn, k0, p.Nk, vec, lane0, lanes);
          load_tile(sG + 2 * kTileElems, v + ch * kChunk, p.v_sn, k0, p.Nk, vec, lane0, lanes);
        }
      }
      if (sub == 0 && u == n_ch - 1) {
        const int qn = min(kBlock, p.Nq - q0);
        for (int r = lane0; r < 2 * kBlock; r += lanes) {  // LSE, then delta
          if (r % kBlock < qn) {
            cp_async_4(sLw + r, (r < kBlock ? lse : delta) + q0 + r % kBlock);
          }
        }
      }
    };

    if constexpr (!kStream) {
      if (owner) {
        load_tile(resK, k + col0, p.k_sn, k0, p.Nk, vec, st, kSubThreads);
        load_tile(resV, v + col0, p.v_sn, k0, p.Nk, vec, st, kSubThreads);
      }
      issue(0, st, kSubThreads);
      cp_async_commit();
    }

    float gacc[8][2 * kW];  // dV (first half) or dK (second half)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2 * kW; ++e) gacc[i][e] = 0.f;
    }
    float sacc[8][8];  // S^T (first half) or dP^T (second half)
    int pend = -1, pend_val = 0;  // the turn this slot has yet to publish

    for (int s = 0; s < n_stages; ++s) {
      if constexpr (kStream) {
        issue(s, st, kSubThreads);
        cp_async_commit();
      }
      cp_async_wait_all();
      __syncthreads();
      const unsigned char* stg = mine + C::kResBytes;
      const float* sQ = reinterpret_cast<const float*>(stg);
      const float* sG = sQ + kTileElems;
      const float* sK = kStream ? sG + kTileElems : resK;
      const float* sV = kStream ? sG + 2 * kTileElems : resV;
      const int t = s / n_ch;
      const int u = s % n_ch;
      const int i_tile = tile_of(t);
      const int q0 = i_tile * kBlock;
      const int qn = min(kBlock, p.Nq - q0);  // live queries of this tile

      if (u == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[i][c] = 0.f;
        }
      }
      // the partial S^T = K Q^T (first half) or dP^T = V dO^T (second half)
      // over this chunk; a warp whose 32 keys are all past Nk has nothing to
      // compute
      if ((kStream ? chunk_at(u) : slot) < p.nc && wh * 32 < kn) {
        const float* ka = (half ? sV : sK) + kr * kRS;
        const float* qa = (half ? sG : sQ) + lc * kRS;
#pragma unroll 1
        for (int d = 0; d < kChunk; d += 4) {
          float4 x[8], y[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = ld4(ka + 4 * i * kRS + d);
#pragma unroll
          for (int c = 0; c < 8; ++c) y[c] = ld4(qa + 8 * c * kRS + d);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int c = 0; c < 8; ++c) sacc[i][c] = dot4(x[i], y[c], sacc[i][c]);
          }
        }
      }
      if (u != n_ch - 1) {
        if constexpr (kStream) __syncthreads();  // this stage is rewritten by the next issue
        continue;
      }

      // the cluster's sum of the partials: slot 1 hands its partial to slot
      // 0, which adds it to its own (the CTA's sum in the exchange buffer,
      // once the peers have read the previous one); then slot 0 adds the
      // CTAs' sums in the order of their ranks
      if (s >= n_ch) cluster_wait();  // the previous step's sums are read
      if (sub == 1) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float* a = sacc[e / 2] + 4 * (e % 2);
          xch[e * kSubThreads + st] = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
      bar_sync(kBarLocal, kThreads);
      if (sub == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float4 x = xch[e * kSubThreads + st];
          float* a = sacc[e / 2] + 4 * (e % 2);
          xch[e * kSubThreads + st] = make_float4(a[0] + x.x, a[1] + x.y, a[2] + x.z,
                                                  a[3] + x.w);
        }
      }
      cluster_arrive();
      cluster_wait();
      if (sub == 0) {
        for (int r = 0; r < p.cluster; ++r) {  // sacc = CTA 0's sum, then + CTA 1's, ...
          const uint32_t base = cluster_addr(xch + st, r);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float4 x = ld_cluster4(base + 16 * e * kSubThreads);
            float* a = sacc[e / 2] + 4 * (e % 2);
            a[0] = r == 0 ? x.x : a[0] + x.x;
            a[1] = r == 0 ? x.y : a[1] + x.y;
            a[2] = r == 0 ? x.z : a[2] + x.z;
            a[3] = r == 0 ? x.w : a[3] + x.w;
          }
        }
      }
      cluster_arrive();  // this CTA has read the peers' sums (waited on at the next step)

      // publish the previous step's turn: the barrier at this step's top
      // ordered every thread's adds before the slot's first thread's fence
      // and release, and this tile's products gave them time
      if (pend >= 0) {
        if (st == 0) {
          __threadfence();
          st_release(p.turn + pend, pend_val);
        }
        pend = -1;
      }
      if (sub == 0) {  // P and dS, zero where the key or the query is past its end
        const float scale_log2 = p.scale * kLog2e;
        if (half == 0) {
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
          bar_arrive(kBarP, kSubThreads);
        } else {  // dS = P (dP - delta)
          bar_sync(kBarP, kSubThreads);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int qq = lc + 8 * c;
            const bool q_live = qq < qn;
            const float dl = q_live ? sL[kBlock + qq] : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int key = kr + 4 * i;
              const float pv = sP[qq * kPStride + key];
              sDS[qq * kPStride + key] = q_live && key < kn ? pv * (sacc[i][c] - dl) : 0.f;
            }
          }
        }
      }
      bar_sync(kBarReady, kThreads);  // P and dS are written
      if (owner) {  // dV += P^T dO (first half) or dK += dS^T Q (second half)
        const float* coef = (half ? sDS : sP) + r3;
        const float* rhs = (half ? sQ : sG) + c3;
#pragma unroll 2
        for (int qq = 0; qq < qn; ++qq) {
          const float4 a0 = ld4(coef + qq * kPStride);
          const float4 a1 = ld4(coef + qq * kPStride + 4);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float r[2 * kW];
          ld4_to(rhs + qq * kRS, r);
          ld4_to(rhs + qq * kRS + kChunk / 2, r + kW);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int e = 0; e < 2 * kW; ++e) gacc[i][e] = fmaf(a[i], r[e], gacc[i][e]);
          }
        }
      }
      // the first half lets the second know dO is read; the second, once dO
      // is read (its dK read Q), copies the slot's next tile in while both
      // go on to dQ
      if (half == 0) {
        bar_arrive(kBarDO + sub, kSubThreads);
      } else {
        bar_sync(kBarDO + sub, kSubThreads);
        if constexpr (kEarly) {
          if (s + 1 < n_stages) issue(s + 1, st - kSubThreads / 2, kSubThreads / 2);
          cp_async_commit();
        }
      }

      // dQ's partial of this key tile, dS K: the first half sums keys 0-31,
      // the second 32-63, each thread 8 queries x 8 columns, four keys a
      // step; once both slots have read P and dS, the halves swap half of
      // their rows through P's buffer (slot 0) or dS's (slot 1), and each
      // adds the two sums, the first half's first, for its four rows
      float dq[8][2 * kW];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2 * kW; ++e) dq[i][e] = 0.f;
      }
      if (owner) {
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
            ld4_to(rhs + (key + jj) * kRS, r);
            ld4_to(rhs + (key + jj) * kRS + kChunk / 2, r + kW);
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
          ld4_to(rhs + key * kRS, r);
          ld4_to(rhs + key * kRS + kChunk / 2, r + kW);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = coef[4 * i * kPStride + key];
#pragma unroll
            for (int e = 0; e < 2 * kW; ++e) dq[i][e] = fmaf(ai, r[e], dq[i][e]);
          }
        }
      }
      bar_sync(kBarSwap, kThreads);  // P and dS are read
      // rows rq + 4i, columns c3 + e and 32 + c3 + e; the first half keeps
      // rows i < 4 and hands over i >= 4, the second the other way
      float* part = (sub ? sDS : sP) + rq * kPStride + c3;
      const int mine_rows = half * 4;
      if (owner) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i >> 2) != half) {
            st4_from(part + 4 * i * kPStride, dq[i]);
            st4_from(part + 4 * i * kPStride + kChunk / 2, dq[i] + kW);
          }
        }
      }

      // wait for this tile's turn; the first contributor finds it open
      const int tix = (bh * p.nc + chunk) * p.n_qt + i_tile;
      const int rank_j = dq_rank(p, i_tile, t, j);
      if (owner && st == 0 && rank_j > 0) {
        while (ld_acquire(p.turn + tix) != rank_j) __nanosleep(32);
      }
      bar_sync(kBarSlot + sub, kSubThreads);
      if (owner) {
        float sum[4][2 * kW];  // the first half's partial plus the second's
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float other[2 * kW];
          ld4_to(part + 4 * (mine_rows + i) * kPStride, other);
          ld4_to(part + 4 * (mine_rows + i) * kPStride + kChunk / 2, other + kW);
#pragma unroll
          for (int e = 0; e < 2 * kW; ++e) {
            const float x = half == 0 ? dq[i][e] : dq[4 + i][e];
            sum[i][e] = half == 0 ? x + other[e] : other[e] + x;
          }
        }
        float* acc = p.dq_acc +
                     (static_cast<long long>(bh) * p.n_qt * kBlock + q0 + rq + 4 * mine_rows) *
                         p.D +
                     col0 + c3;
        if (rank_j == p.n_kt - 1) {  // the last contributor writes dQ
          float* out = p.dq + b * p.dq_sb + h * p.dq_sh + col0 + c3;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = q0 + rq + 4 * (mine_rows + i);
            if (row >= p.Nq) continue;
#pragma unroll
            for (int e = 0; e < 2 * kW; ++e) {
              const int col = e < kW ? e : kChunk / 2 + e - kW;
              float x = sum[i][e];
              if (rank_j > 0) x = __ldcg(acc + 4 * i * p.D + col) + x;
              out[row * p.dq_sn + col] = x * p.scale;
            }
          }
        } else if (rank_j == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            __stcg(reinterpret_cast<float4*>(acc + 4 * i * p.D),
                   make_float4(sum[i][0], sum[i][1], sum[i][2], sum[i][3]));
            __stcg(reinterpret_cast<float4*>(acc + 4 * i * p.D + kChunk / 2),
                   make_float4(sum[i][4], sum[i][5], sum[i][6], sum[i][7]));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            red_add4(acc + 4 * i * p.D, sum[i][0], sum[i][1], sum[i][2], sum[i][3]);
            red_add4(acc + 4 * i * p.D + kChunk / 2, sum[i][4], sum[i][5], sum[i][6], sum[i][7]);
          }
        }
        pend = tix;
        pend_val = rank_j + 1;
      }
      // this stage's buffers are rewritten by the next issue (with the early
      // issue they were read before it, and P and dS are rewritten only
      // after the next step's top barrier)
      if constexpr (kStream) __syncthreads();
    }
    cluster_wait();  // the peers have read this CTA's last sums
    __syncthreads();
    if (!owner) continue;
    if (st == 0 && pend >= 0) {
      __threadfence();
      st_release(p.turn + pend, pend_val);
    }

    // dV (first half) or dK * scale (second half) of the live keys
    float* dst = (half ? p.dk : p.dv) + b * (half ? p.dk_sb : p.dv_sb) +
                 h * (half ? p.dk_sh : p.dv_sh) + col0 + c3;
    const long long sn = half ? p.dk_sn : p.dv_sn;
    const float mul = half ? p.scale : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + r3 + i;
      if (key >= p.Nk) continue;
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        dst[key * sn + e] = gacc[i][e] * mul;
        dst[key * sn + kChunk / 2 + e] = gacc[i][kW + e] * mul;
      }
    }
  }
}

// The cluster geometry at head_dim D: chunks, groups, CTAs a cluster (two
// slots each).
void clusters_of(int D, int* nc, int* n_groups, int* cluster) {
  *nc = D / kChunk;
  *n_groups = (*nc + kSlots * kMaxCluster - 1) / (kSlots * kMaxCluster);
  const int slots = (*nc + *n_groups - 1) / *n_groups;
  *cluster = (slots + kSlots - 1) / kSlots;
}

// The walk of the last launch (1 diagonal, 0 in order, -1 none yet) and
// its grid in clusters.
int g_last_walk = -1, g_last_clusters = 0;

template <bool kStream>
cudaError_t launch(Params& p, int B, cudaStream_t stream) {
  using C = Cfg<kStream>;
  // the shared-memory opt-in and the clusters a card holds at once, once a
  // device and cluster size
  static int active[64][kMaxCluster + 1] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_active = device < 64 ? active[device][p.cluster] : 0;
  if (n_active == 0) {
    err = cudaFuncSetAttribute(bwd_wide_kernel<kStream>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(p.cluster);
    err = cudaOccupancyMaxActiveClusters(&n_active, bwd_wide_kernel<kStream>, &cfg);
    if (err != cudaSuccess) return err;
    if (n_active < 1) return cudaErrorInvalidConfiguration;
    if (device < 64) active[device][p.cluster] = n_active;
  }
  const long long bh = static_cast<long long>(B) * p.H;
  const long long items = bh * p.n_groups * p.n_kt;
  const long long n_turn = bh * p.nc * p.n_qt;
  const long long rows = bh * p.Nq;
  const long long cover = rows > n_turn + 1 ? rows : n_turn + 1;
  if (items > INT_MAX || n_turn >= INT_MAX || (cover + 255) / 256 > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  p.items = static_cast<int>(items);
  p.n_turn = static_cast<int>(n_turn);
  const int grid = static_cast<int>(items < n_active ? items : n_active);  // clusters
  p.diag = p.n_kt > 1 && p.n_kt <= grid ? 1 : 0;
  prologue_kernel<<<static_cast<unsigned int>((cover + 255) / 256), 256, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(grid * p.cluster);
  g_last_clusters = grid;
  if (p.diag) {
    // the diagonal walk needs the whole grid resident at once: a cooperative
    // launch starts it only so, or is refused (too large, or no cooperative
    // launch of clusters on this card or driver), and then the in-order walk
    // runs instead; a fault of any other kind refuses that launch too
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, bwd_wide_kernel<kStream>, p);
    if (err == cudaSuccess) {
      g_last_walk = 1;
      return cudaSuccess;
    }
    (void)cudaGetLastError();
    p.diag = 0;
    cfg.numAttrs = 1;
  }
  g_last_walk = 0;
  err = cudaLaunchKernelEx(&cfg, bwd_wide_kernel<kStream>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kStream>
cudaError_t attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, bwd_wide_kernel<kStream>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = Cfg<kStream>::kBytes;
  }
  return err;
}

}  // namespace

// float32 at any head_dim >= 128 that is a multiple of 64; the arguments of
// flash_attn_bwd_f32.cu's entry
extern "C" int videogpa_flash_attn_bwd_wide_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, void* dq_acc, void* turn, int B,
    int H, int Nq, int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, long long do_sb, long long do_sn,
    long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb,
    long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh,
    float scale, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D < 128 || D % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
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
  clusters_of(D, &p.nc, &p.n_groups, &p.cluster);
  p.n_qt = (Nq + kBlock - 1) / kBlock;
  p.n_kt = (Nk + kBlock - 1) / kBlock;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_sn = do_sn; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  // 16-byte copies when every row of the four staged operands starts on 16 bytes
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long s : {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh}) {
    vec = vec && s % 4 == 0;
  }
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.n_groups > 1 ? launch<true>(p, B, s) : launch<false>(p, B, s);
}

// The main kernel's registers a thread and dynamic shared memory a CTA at
// head_dim D, for reports.
extern "C" int videogpa_flash_attn_bwd_wide_f32_attrs(int D, int* regs, int* smem_bytes) {
  if (D < 128 || D % kChunk != 0) return cudaErrorInvalidValue;
  int nc = 0, n_groups = 0, cluster = 0;
  clusters_of(D, &nc, &n_groups, &cluster);
  return n_groups > 1 ? attrs<true>(regs, smem_bytes) : attrs<false>(regs, smem_bytes);
}

// The walk the last launch took (1 diagonal, by a cooperative launch; 0 in
// order; -1 before any launch) and its grid in clusters, for reports.
extern "C" int videogpa_flash_attn_bwd_wide_f32_walk(int* walk, int* clusters) {
  *walk = g_last_walk;
  *clusters = g_last_clusters;
  return 0;
}
