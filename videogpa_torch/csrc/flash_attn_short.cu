// Short-row attention for Hopper (sm_90a): O = softmax(Q K^T / sqrt(D)) V
// over key rows of at most 2,048, bf16 operands in the (B, N, H, D)
// projection layout, f32 accumulation, no LSE (inference only), keys at
// index >= n_valid masked.
//
// Replaces the TPU Pallas kernel videogpa_tpu/ops/attention.py `_flash_short`
// (call :589): VGGT's frame attention and DINOv2, (K*10 frames, 1,374
// tokens, 16 heads, 64). That kernel holds one query block, the whole key
// row and all heads in VMEM and takes an exact one-shot softmax. The row does
// not fit a Hopper SM (one head's K and V at 1,408 padded keys x 64 x 2 B
// are 360 KB against 227 KB of shared memory), so the softmax is exact in two
// passes instead: pass 1 walks the key tiles for the true row max; pass 2
// walks them again for P = exp2(S - max), its row sum and P V, with no
// rescaling of the accumulator. That is the TPU kernel's arithmetic; the
// price is QK^T twice (1.5x the operations of an online softmax).
//
// Masking follows the JAX kernel: keys >= n_valid score -inf and their V
// rows count as zero. Here key tiles past n_valid are never read at all
// (load_tile zero-fills rows >= n_valid), so NaN or Inf in those K or V rows
// cannot reach O.
//
// Bound at (40, 1,374, 16, 64): tensor-core operations, 4*B*H*N^2*D =
// 0.309 TFLOP -> 0.31 ms at the 989 TFLOP/s bf16 dense peak (its 0.45 GB of
// operands and output need 0.13 ms at 3.35 TB/s).
// Design: one CTA of 4 warps per (b*h, 64-query tile); each warp owns 16
// query rows with its Q fragments, row max, row sum and O accumulator in
// registers; 64-key tiles of K (pass 1) and K, V (pass 2) are double-
// buffered in shared memory with cp.async; QK^T and PV on mma.sync
// m16n8k16 bf16 -> f32, P re-packed from the S accumulators, V's fragments
// from ldmatrix.trans. Operands and output are addressed through element
// strides, so slices of the packed qkv projection need no copy.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace videogpa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per CTA
constexpr int kBlockN = 64;           // keys per tile
constexpr int kTileRows = 64;
static_assert(kBlockM == kTileRows && kBlockN == kTileRows, "tile loader shape");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Nq, n_valid;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;  // D^-0.5 * log2(e)
};

// S = Q K^T for one warp's 16 rows x 64 keys, scaled to the log2 domain,
// keys >= n_valid at -inf.
template <int D, int kStride>
__device__ __forceinline__ void scores(float (&s)[kBlockN / 8][4], const uint32_t (&qf)[D / 16][4],
                                       __nv_bfloat16 (*sk)[kStride], int key0,
                                       int n_valid, float scale_log2, int g, int tig) {
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      const uint32_t b0 = lds32(&sk[nt * 8 + g][c]);
      const uint32_t b1 = lds32(&sk[nt * 8 + g][c + 8]);
      mma_16816(s[nt], qf[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + nt * 8 + tig * 2 + (e & 1);
      s[nt][e] = key < n_valid ? s[nt][e] * scale_log2 : -INFINITY;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_short_kernel(const Params p) {
  constexpr int kStride = D + 8;  // +16 bytes per row: conflict-free fragment loads
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM][kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockN][kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockN][kStride];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int n_kv = (p.n_valid + kBlockN - 1) / kBlockN;

  // ---- pass 1: the exact row max ----
  load_tile<D, kStride, kTileRows, kThreads>(sQ, q, p.q_sn, q0, p.Nq);
  load_tile<D, kStride, kTileRows, kThreads>(sK[0], k, p.k_sn, 0, p.n_valid);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY};
  float s[kBlockN / 8][4];
  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D, kStride, kTileRows, kThreads>(sK[st ^ 1], k, p.k_sn, (j + 1) * kBlockN,
                                                 p.n_valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + tig * 2;
        qf[kk][0] = lds32(&sQ[r0][c]);
        qf[kk][1] = lds32(&sQ[r0 + 8][c]);
        qf[kk][2] = lds32(&sQ[r0][c + 8]);
        qf[kk][3] = lds32(&sQ[r0 + 8][c + 8]);
      }
    }
    scores<D, kStride>(s, qf, sK[st], j * kBlockN, p.n_valid, p.scale_log2, g, tig);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
    __syncthreads();  // buffer st is refilled by the next prefetch
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  cp_async_wait<0>();  // the last (empty) group

  // ---- pass 2: P = exp2(S - max), its row sums and P V ----
  load_tile<D, kStride, kTileRows, kThreads>(sK[0], k, p.k_sn, 0, p.n_valid);
  load_tile<D, kStride, kTileRows, kThreads>(sV[0], v, p.v_sn, 0, p.n_valid);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int mi = lane / 8;
  const int mr = lane % 8;
  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_tile<D, kStride, kTileRows, kThreads>(sK[st ^ 1], k, p.k_sn, (j + 1) * kBlockN,
                                                 p.n_valid);
      load_tile<D, kStride, kTileRows, kThreads>(sV[st ^ 1], v, p.v_sn, (j + 1) * kBlockN,
                                                 p.n_valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    scores<D, kStride>(s, qf, sK[st], j * kBlockN, p.n_valid, p.scale_log2, g, tig);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sV[st][kk * 16 + mr + 8 * (mi & 1)][dp * 16 + 8 * (mi >> 1)]);
        mma_16816(acc[2 * dp], a, bv[0], bv[1]);
        mma_16816(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Nq) continue;
    __nv_bfloat16* orow = o + rows[i] * p.o_sn;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + tig * 2) =
          pack_bf16x2(acc[dt][2 * i] * inv[i], acc[dt][2 * i + 1] * inv[i]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Nq + kBlockM - 1) / kBlockM, B * p.H);
  flash_attn_short_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_short(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int n_valid,
    int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long o_sb,
    long long o_sn, long long o_sh, float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.n_valid = n_valid;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
