// int8-QK flash-attention forward for Hopper (sm_90a), inference only:
//   S = int32(q8 k8^T) * sq[row] * sk[col]   (already in the base-2 log domain)
//   O = softmax2(S) V,  P cast to bf16 before PV, f32 accumulation
// q8, k8: int8 rows with one f32 scale per row (sq, sk); V and O: bf16.
// The caller (ops/attention.py::quantize_qk_int8) centres K on its mean over
// the keys, prescales q by log2(e) / sqrt(D) and quantises both per row.
//
// Replaces the TPU Pallas kernels of videogpa_tpu/ops/attention.py:
//   K8 `_fwd_kernel_T8` (head_dim < 128; entry videogpa_flash_attn_int8, head_dim
//       16, 32 or 64) and
//   K9 `_fwd_kernel_i8` (head_dim 128; entry videogpa_flash_attn_int8_d128).
// Both are one templated body. This kernel is a plain online softmax with no
// clamp on the running max, so it is exact for any range of the quantised
// scores: the TPU kernel's lagged max, its 2^110 clamp, the `jumps` output and
// the switch to the exact bf16 kernel have no counterpart here, nor have the
// transposed (D, N) accumulators, the ones-row denominator and the 8-lane
// broadcast of the scales.
//
// Bound: tensor-core operations. QK^T is 2*B*H*Nq*Nk*D integer operations
// (dense int8 peak 1,979 TOP/s) and PV as many in bf16 (989 TFLOP/s): at the
// CogVideoX-5B DiT shape (B=2, N=17,776, H=48, D=64) 1.96 + 3.93 = 5.89 ms,
// against ~0.2 ms for its ~0.65 GB of operands and output at 3.35 TB/s.
//
// Design: one CTA of 4 warps per (b*h, 64-row Q tile) on mma.sync; each warp
// owns 16 query rows and keeps O, the running max and the running sum in
// registers. K (int8), its scales and V (bf16) tiles of 64 keys are
// double-buffered in dynamic shared memory with cp.async; int8 tiles are
// half the bytes of bf16 ones. QK^T runs on the integer tensor cores
// (mma.sync m16n8k32 s8 x s8 -> s32; m16n8k16 at head_dim 16), whose s32
// accumulator fragment has the m16n8 layout of the f32 one, so the
// dequantisation (one convert and two multiplies per score), the ragged-tail
// mask, the online softmax and the repack of P as the bf16 A operand of PV
// (mma.sync m16n8k16 bf16 -> f32, V through ldmatrix.trans) work on the same
// fragments. Rows of int8 tiles are padded by 16 bytes so fragment loads
// are free of bank conflicts at head_dim >= 32. All operands go in by element strides for
// (b, n, h), in either layout, Nq may differ from Nk, and nothing is padded
// on the host: keys past Nk are zero-filled by cp.async and masked to -inf.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace videogpa {
namespace flash_int8 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per CTA
constexpr int kBlockN = 64;           // keys per K/V tile
static_assert(kBlockM == 64 && kBlockN == 64, "tile loader shape");

struct Params {
  const int8_t* q8;
  const float* sq;
  const int8_t* k8;
  const float* sk;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Nq, Nk;
  long long q_sb, q_sn, q_sh;
  long long sq_sb, sq_sn, sq_sh;
  long long k_sb, k_sn, k_sh;
  long long sk_sb, sk_sn, sk_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
};

// d += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) * b (16x8, col); s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8_16816(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// 4-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) of one head's int8 operand (row stride
// `row_stride` bytes) into a padded shared tile; rows >= n_rows become zeros.
template <int D, int kStride>
__device__ __forceinline__ void load_tile_s8(int8_t (*dst)[kStride], const int8_t* base,
                                             long long row_stride, int row0, int n_rows) {
  constexpr int kChunks = D / 16;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 16;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    cp_async_16(&dst[r][col], base + (valid ? row : 0) * row_stride + col, valid);
  }
}

// The 64 key scales that ride with a K tile; keys >= n_rows get 0.
__device__ __forceinline__ void load_scales(float* dst, const float* base, long long row_stride,
                                            int row0, int n_rows) {
  if (threadIdx.x < kBlockN) {
    const int row = row0 + threadIdx.x;
    const bool valid = row < n_rows;
    cp_async_4(&dst[threadIdx.x], base + (valid ? row : 0) * row_stride, valid);
  }
}

template <int D>
constexpr int smem_bytes() {
  // sQ[64] + sK[2][64] int8 rows of D + 16; sV[2][64] bf16 rows of D + 8; sSk[2][64] f32
  return 3 * 64 * (D + 16) + 2 * kBlockN * (D + 8) * 2 + 2 * kBlockN * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) kernel(const Params p) {
  constexpr int kStride8 = D + 16;  // int8 row in bytes
  constexpr int kStrideV = D + 8;   // bf16 row in elements
  constexpr int kSteps = D >= 32 ? D / 32 : 1;  // k-steps of QK^T
  extern __shared__ __align__(16) unsigned char smem[];
  auto sQ = reinterpret_cast<int8_t(*)[kStride8]>(smem);
  auto sK = reinterpret_cast<int8_t(*)[kBlockN][kStride8]>(smem + kBlockM * kStride8);
  auto sV = reinterpret_cast<__nv_bfloat16(*)[kBlockN][kStrideV]>(smem + 3 * 64 * kStride8);
  auto sSk = reinterpret_cast<float(*)[kBlockN]>(smem + 3 * 64 * kStride8 +
                                                 2 * kBlockN * kStrideV * 2);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;        // fragment row group
  const int tig = lane % 4;      // thread in group
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8

  const int8_t* q8 = p.q8 + b * p.q_sb + h * p.q_sh;
  const int8_t* k8 = p.k8 + b * p.k_sb + h * p.k_sh;
  const float* sk = p.sk + b * p.sk_sb + h * p.sk_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const int n_kv = (p.Nk + kBlockN - 1) / kBlockN;

  load_tile_s8<D, kStride8>(sQ, q8, p.q_sn, q0, p.Nq);
  load_tile_s8<D, kStride8>(sK[0], k8, p.k_sn, 0, p.Nk);
  load_scales(sSk[0], sk, p.sk_sn, 0, p.Nk);
  load_tile<D, kStrideV, 64, kThreads>(sV[0], v, p.v_sn, 0, p.Nk);
  cp_async_commit();

  // this thread's two query scales, read once
  const float* sq = p.sq + b * p.sq_sb + h * p.sq_sh;
  const float sq_r[2] = {q0 + r0 < p.Nq ? sq[(q0 + r0) * p.sq_sn] : 0.f,
                         q0 + r0 + 8 < p.Nq ? sq[(q0 + r0 + 8) * p.sq_sn] : 0.f};

  uint32_t qf[kSteps][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 domain)
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_tile_s8<D, kStride8>(sK[st ^ 1], k8, p.k_sn, (j + 1) * kBlockN, p.Nk);
      load_scales(sSk[st ^ 1], sk, p.sk_sn, (j + 1) * kBlockN, p.Nk);
      load_tile<D, kStrideV, 64, kThreads>(sV[st ^ 1], v, p.v_sn, (j + 1) * kBlockN, p.Nk);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();

    if (j == 0) {
      if constexpr (D >= 32) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const int c = kk * 32 + tig * 4;
          qf[kk][0] = lds32(&sQ[r0][c]);
          qf[kk][1] = lds32(&sQ[r0 + 8][c]);
          qf[kk][2] = lds32(&sQ[r0][c + 16]);
          qf[kk][3] = lds32(&sQ[r0 + 8][c + 16]);
        }
      } else {
        qf[0][0] = lds32(&sQ[r0][tig * 4]);
        qf[0][1] = lds32(&sQ[r0 + 8][tig * 4]);
        qf[0][2] = qf[0][3] = 0u;
      }
    }

    // S = (q8 k8^T) * sq * sk for this warp's 16 rows x 64 keys; keys past Nk -> -inf
    const int key0 = j * kBlockN;
    float s[kBlockN / 8][4];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      int si[4] = {0, 0, 0, 0};
      if constexpr (D >= 32) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const int c = kk * 32 + tig * 4;
          const uint32_t b0 = lds32(&sK[st][nt * 8 + g][c]);
          const uint32_t b1 = lds32(&sK[st][nt * 8 + g][c + 16]);
          mma_s8_16832(si, qf[kk], b0, b1);
        }
      } else {
        mma_s8_16816(si, qf[0][0], qf[0][1], lds32(&sK[st][nt * 8 + g][tig * 4]));
      }
      const float2 skv = *reinterpret_cast<const float2*>(&sSk[st][nt * 8 + tig * 2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + tig * 2 + (e & 1);
        const float t = key < p.Nk
                            ? static_cast<float>(si[e]) * sq_r[e >> 1] * ((e & 1) ? skv.y : skv.x)
                            : -INFINITY;
        s[nt][e] = t;
        mx[e >> 1] = fmaxf(mx[e >> 1], t);
      }
    }

    // online softmax; elements 0,1 belong to row r0, elements 2,3 to row r0 + 8
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key0 < Nk, so every row has a finite max in this tile
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk; ldmatrix.trans turns row-major V into B fragments.
    const int mi = lane / 8;
    const int mr = lane % 8;
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
    __syncthreads();  // buffer st is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
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
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.Nq + kBlockM - 1) / kBlockM, B * p.H);
  kernel<D><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

inline Params make_params(const void* q8, const void* sq, const void* k8, const void* sk,
                          const void* v, void* o, int H, int Nq, int Nk,
                          const long long* st) {
  Params p;
  p.q8 = static_cast<const int8_t*>(q8);
  p.sq = static_cast<const float*>(sq);
  p.k8 = static_cast<const int8_t*>(k8);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = st[0]; p.q_sn = st[1]; p.q_sh = st[2];
  p.sq_sb = st[3]; p.sq_sn = st[4]; p.sq_sh = st[5];
  p.k_sb = st[6]; p.k_sn = st[7]; p.k_sh = st[8];
  p.sk_sb = st[9]; p.sk_sn = st[10]; p.sk_sh = st[11];
  p.v_sb = st[12]; p.v_sn = st[13]; p.v_sh = st[14];
  p.o_sb = st[15]; p.o_sn = st[16]; p.o_sh = st[17];
  return p;
}

}  // namespace flash_int8
}  // namespace videogpa

using namespace videogpa::flash_int8;

#define VIDEOGPA_INT8_ARGS                                                                      \
  const void *q8, const void *sq, const void *k8, const void *sk, const void *v, void *o,      \
      int B, int H, int Nq, int Nk, int D, long long q_sb, long long q_sn, long long q_sh,     \
      long long sq_sb, long long sq_sn, long long sq_sh, long long k_sb, long long k_sn,       \
      long long k_sh, long long sk_sb, long long sk_sn, long long sk_sh, long long v_sb,       \
      long long v_sn, long long v_sh, long long o_sb, long long o_sn, long long o_sh,          \
      void *stream

#define VIDEOGPA_INT8_PARAMS                                                                    \
  const long long strides[18] = {q_sb,  q_sn,  q_sh,  sq_sb, sq_sn, sq_sh, k_sb, k_sn, k_sh,   \
                                 sk_sb, sk_sn, sk_sh, v_sb,  v_sn,  v_sh,  o_sb, o_sn, o_sh};  \
  const Params p = make_params(q8, sq, k8, sk, v, o, H, Nq, Nk, strides);                      \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

// K8: head_dim 16, 32 or 64.
extern "C" int videogpa_flash_attn_int8(VIDEOGPA_INT8_ARGS) {
  VIDEOGPA_INT8_PARAMS;
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// K9: head_dim 128.
extern "C" int videogpa_flash_attn_int8_d128(VIDEOGPA_INT8_ARGS) {
  VIDEOGPA_INT8_PARAMS;
  if (D != 128) return cudaErrorInvalidValue;
  return launch<128>(p, B, s);
}
