// Flash-attention backward in float32 (sm_90a): the float32 entry of K3/K7.
//
// Replaces, for float32 operands, the TPU Pallas backward kernels of
// videogpa_tpu/ops/attention.py: `_dq_kernel_T` / `_dkv_kernel_T` (:951, :983;
// calls at :1050, :1064) at head_dim < 128 and `_dq_kernel` / `_dkv_kernel`
// (:883, :908; calls at :1110, :1131) at head_dim 128. The JAX `_flash` vjp
// (:1181-1192) differentiates f32 attention through those kernels; the port's
// wgmma kernels K3 and K7 take bf16 only, so f32 under grad needs its own
// kernel. Given Q, K, V, O, the natural-log LSE of the forward and dO:
//
//   P = exp(S * scale - LSE), S = Q K^T;  delta = rowsum(O * dO)
//   dV = P^T dO;  dS = P * (dO V^T - delta);  dQ = dS K * scale;  dK = dS^T Q * scale
//
// Everything stays in f32 on the CUDA cores (no TF32: the numbers must be
// the JAX package's f32 numbers). Bound: the five products, 10*B*H*Nq*Nk*D
// operations over the 67 TFLOP/s f32 peak; at short rows the bytes of the
// eight operands over 3.35 TB/s.
//
// Design, as the Pallas backward is split: three launches on one stream.
//  1. A prologue writes delta (B*H, Nq), one thread a query row.
//  2. dK/dV: a flat 1-D grid of CTAs over (64-key tile, b*h), 256 threads in
//     16 row groups of 4 keys x 16 column groups. The CTA stages its K and V
//     tiles once and walks the 64-query tiles of Q and dO (cp.async into
//     shared memory, rows padded by 16 bytes), computes S^T and dP^T as 4 x 4
//     FMA micro-tiles, P^T and dS^T from them, passes both through shared
//     memory and accumulates dV += P^T dO and dK += dS^T Q in registers.
//  3. dQ: the same grid over (64-query tile, b*h): Q and dO stay, K and V
//     tiles stream, dQ += dS K accumulates in registers.
// S and dP are computed in both passes (seven products in all) so that no
// pass sums across CTAs: each gradient element is summed by one thread in a
// fixed order and written once, and two runs give the same bits (unlike
// K3's and K7's bf16 dQ, summed by reduce-adds in arrival order). Rows past
// Nq or Nk are never loaded: the products skip them, P and dS are zero
// there, and nothing past them is stored. Operands are addressed through
// (b, n, h) element strides, so the (B, N, H, D) and (B, H, N, D) layouts
// and strided views go in without a copy. A simple kernel first: single
// buffered tiles, no overlap of loads and products.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;                // rows of a tile: keys or queries
constexpr int kThreads = 256;             // 16 row groups of 4 rows x 16 column groups
constexpr int kPStride = kBlock + 4;      // floats a row of P or dS in shared memory

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;   // floats a row of an operand tile
  static constexpr int kTile = kBlock * kStride;
  static constexpr int kA = 0;            // the CTA's own tiles: K, V (dK/dV) or Q, dO (dQ)
  static constexpr int kB = kA + kTile;
  static constexpr int kC = kB + kTile;   // the streamed tiles: Q, dO (dK/dV) or K, V (dQ)
  static constexpr int kE = kC + kTile;
  static constexpr int kP = kE + kTile;   // P^T, [query][key] (dK/dV only)
  static constexpr int kS = kP + kBlock * kPStride;  // dS^T or dS, [reduction row][own row]
  static constexpr int kVec = kS + kBlock * kPStride;  // LSE and delta of the streamed rows
  static constexpr int kBytes = (kVec + 2 * kBlock) * 4;
  static constexpr int kW = D >= 64 ? 4 : D / 16;  // gradient columns a thread holds per chunk
  static constexpr int kChunks = D / 16 / kW;     // chunks of kW columns, 16 * kW apart
  static constexpr int kAcc = kChunks * kW;
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
  int H, Nq, Nk, n_qt, n_kt, vec4;
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
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The rows [row0, min(row0 + 64, n)) of an operand (row stride sn, D
// contiguous floats) into shared memory rows of kStride floats; rows past n
// are not written. 16-byte copies when every row starts on 16 bytes (vec4),
// else 4-byte.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sn, int row0,
                                          int n, bool vec4) {
  constexpr int kStride = Layout<D>::kStride;
  const int rows = min(kBlock, n - row0);
  src += static_cast<long long>(row0) * sn;
  if (vec4) {
    for (int c = threadIdx.x; c < rows * (D / 4); c += kThreads) {
      const int r = c / (D / 4);
      const int d = 4 * (c % (D / 4));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + r * kStride + d)),
                   "l"(src + r * sn + d)
                   : "memory");
    }
  } else {
    for (int c = threadIdx.x; c < rows * D; c += kThreads) {
      const int r = c / D;
      const int d = c % D;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(dst + r * kStride + d)),
                   "l"(src + r * sn + d)
                   : "memory");
    }
  }
}

// kW consecutive floats of a shared-memory row.
template <int W>
__device__ __forceinline__ void load_w(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = ld4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

// 4 own rows x 4 streamed rows of A B^T: own rows a + i * kStride, streamed
// rows b + 16 c * kStride, float4 steps along D.
template <int D>
__device__ __forceinline__ void micro_tile(const float* a, const float* b, float (&s)[4][4]) {
  constexpr int kStride = Layout<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(a + i * kStride + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = ld4(b + 16 * c * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dot4(x[i], y[c], s[i][c]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) delta_kernel(const Params p, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int bh = static_cast<int>(r / p.Nq);
  const int n = static_cast<int>(r % p.Nq);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* o = p.o + b * p.o_sb + h * p.o_sh + n * p.o_sn;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh + n * p.do_sn;
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(o[d], g[d], s);
  p.delta[r] = s;
}

// One CTA per (64-key tile, b*h), item = b*h * n_kt + key tile. Thread t
// holds keys 4 (t / 16) + 0..3 of the tile; for S^T and dP^T the queries
// t % 16 + 16 c (c < 4) of the query tile, for dK and dV the columns
// kW (t % 16) + 16 kW c + 0..kW-1.
template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smf[];
  const int item = blockIdx.x;
  const int bh = item / p.n_kt;
  const int k0 = (item % p.n_kt) * kBlock;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Nq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Nq;
  const bool vec4 = p.vec4 != 0;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  const int kn = min(kBlock, p.Nk - k0);  // live keys of this CTA
  const bool rows_live = 4 * rg < kn;
  float* sp = smf + L::kP;
  float* sds = smf + L::kS;
  float* slse = smf + L::kVec;
  float* sdel = slse + kBlock;

  load_rows<D>(smf + L::kA, k, p.k_sn, k0, p.Nk, vec4);
  load_rows<D>(smf + L::kB, v, p.v_sn, k0, p.Nk, vec4);
  cp_async_commit();

  float dk[4][L::kAcc], dv[4][L::kAcc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < L::kAcc; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  for (int j = 0; j < p.n_qt; ++j) {
    const int q0 = j * kBlock;
    const int qn = min(kBlock, p.Nq - q0);  // live queries of this tile
    load_rows<D>(smf + L::kC, q, p.q_sn, q0, p.Nq, vec4);
    load_rows<D>(smf + L::kE, g, p.do_sn, q0, p.Nq, vec4);
    cp_async_commit();
    if (static_cast<int>(threadIdx.x) < qn) {
      slse[threadIdx.x] = lse[q0 + threadIdx.x];
      sdel[threadIdx.x] = delta[q0 + threadIdx.x];
    }
    cp_async_wait_all();
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    if (rows_live && cg < qn) {
      micro_tile<D>(smf + L::kA + 4 * rg * L::kStride, smf + L::kC + cg * L::kStride, s);
      micro_tile<D>(smf + L::kB + 4 * rg * L::kStride, smf + L::kE + cg * L::kStride, dp);
    }
    // P^T and dS^T, zero where the key or the query is past its end
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qq = cg + 16 * c;
      const bool q_live = rows_live && qq < qn;
      const float lq = q_live ? slse[qq] : 0.f;
      const float dq = q_live ? sdel[qq] : 0.f;
      float pt[4], dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = q_live && 4 * rg + i < kn;
        pt[i] = live ? expf(s[i][c] * p.scale - lq) : 0.f;
        dst[i] = live ? pt[i] * (dp[i][c] - dq) : 0.f;
      }
      *reinterpret_cast<float4*>(sp + qq * kPStride + 4 * rg) =
          make_float4(pt[0], pt[1], pt[2], pt[3]);
      *reinterpret_cast<float4*>(sds + qq * kPStride + 4 * rg) =
          make_float4(dst[0], dst[1], dst[2], dst[3]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the live queries
    const float* gcol = smf + L::kE + L::kW * cg;
    const float* qcol = smf + L::kC + L::kW * cg;
#pragma unroll 2
    for (int qq = 0; qq < (rows_live ? qn : 0); ++qq) {
      const float4 pk = ld4(sp + qq * kPStride + 4 * rg);
      const float4 sk = ld4(sds + qq * kPStride + 4 * rg);
      const float pr[4] = {pk.x, pk.y, pk.z, pk.w};
      const float sr[4] = {sk.x, sk.y, sk.z, sk.w};
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        float gv[L::kW], qv[L::kW];
        load_w<L::kW>(gcol + qq * L::kStride + 16 * L::kW * c, gv);
        load_w<L::kW>(qcol + qq * L::kStride + 16 * L::kW * c, qv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < L::kW; ++e) {
            dv[i][c * L::kW + e] = fmaf(pr[i], gv[e], dv[i][c * L::kW + e]);
            dk[i][c * L::kW + e] = fmaf(sr[i], qv[e], dk[i][c * L::kW + e]);
          }
        }
      }
    }
    __syncthreads();  // Q, dO, P^T and dS^T are rewritten by the next tile
  }

  float* dkp = p.dk + b * p.dk_sb + h * p.dk_sh;
  float* dvp = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * rg + i;
    if (key >= p.Nk) continue;
    float* dkrow = dkp + key * p.dk_sn + L::kW * cg;
    float* dvrow = dvp + key * p.dv_sn + L::kW * cg;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < L::kW; ++e) {
        dkrow[16 * L::kW * c + e] = dk[i][c * L::kW + e] * p.scale;
        dvrow[16 * L::kW * c + e] = dv[i][c * L::kW + e];
      }
    }
  }
}

// One CTA per (64-query tile, b*h), item = b*h * n_qt + query tile. Thread t
// holds queries 4 (t / 16) + 0..3; for S and dP the keys t % 16 + 16 c of
// the key tile, for dQ the columns as in dkdv_kernel.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smf[];
  const int item = blockIdx.x;
  const int bh = item / p.n_qt;
  const int q0 = (item % p.n_qt) * kBlock;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const float* g = p.dout + b * p.do_sb + h * p.do_sh;
  const bool vec4 = p.vec4 != 0;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  const int qn = min(kBlock, p.Nq - q0);  // live queries of this CTA
  const bool rows_live = 4 * rg < qn;
  float* sds = smf + L::kS;

  load_rows<D>(smf + L::kA, q, p.q_sn, q0, p.Nq, vec4);
  load_rows<D>(smf + L::kB, g, p.do_sn, q0, p.Nq, vec4);
  cp_async_commit();
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    const long long at = static_cast<long long>(bh) * p.Nq + row;
    lr[i] = row < p.Nq ? p.lse[at] : 0.f;
    dr[i] = row < p.Nq ? p.delta[at] : 0.f;
  }
  float acc[4][L::kAcc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < L::kAcc; ++e) acc[i][e] = 0.f;
  }

  for (int j = 0; j < p.n_kt; ++j) {
    const int key0 = j * kBlock;
    const int kn = min(kBlock, p.Nk - key0);  // live keys of this tile
    load_rows<D>(smf + L::kC, k, p.k_sn, key0, p.Nk, vec4);
    load_rows<D>(smf + L::kE, v, p.v_sn, key0, p.Nk, vec4);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    if (rows_live && cg < kn) {
      micro_tile<D>(smf + L::kA + 4 * rg * L::kStride, smf + L::kC + cg * L::kStride, s);
      micro_tile<D>(smf + L::kB + 4 * rg * L::kStride, smf + L::kE + cg * L::kStride, dp);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = cg + 16 * c;
      const bool k_live = rows_live && key < kn;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = k_live && 4 * rg + i < qn;
        const float pv = live ? expf(s[i][c] * p.scale - lr[i]) : 0.f;
        ds[i] = live ? pv * (dp[i][c] - dr[i]) : 0.f;
      }
      *reinterpret_cast<float4*>(sds + key * kPStride + 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over the live keys
    const float* kcol = smf + L::kC + L::kW * cg;
#pragma unroll 2
    for (int key = 0; key < (rows_live ? kn : 0); ++key) {
      const float4 sk = ld4(sds + key * kPStride + 4 * rg);
      const float sr[4] = {sk.x, sk.y, sk.z, sk.w};
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        float kv[L::kW];
        load_w<L::kW>(kcol + key * L::kStride + 16 * L::kW * c, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < L::kW; ++e) {
            acc[i][c * L::kW + e] = fmaf(sr[i], kv[e], acc[i][c * L::kW + e]);
          }
        }
      }
    }
    __syncthreads();  // K, V and dS are rewritten by the next tile
  }

  float* dqp = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= p.Nq) continue;
    float* dqrow = dqp + row * p.dq_sn + L::kW * cg;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < L::kW; ++e) {
        dqrow[16 * L::kW * c + e] = acc[i][c * L::kW + e] * p.scale;
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kBytes;
  const long long rows = static_cast<long long>(B) * p.H * p.Nq;
  const long long items_k = static_cast<long long>(B) * p.H * p.n_kt;
  const long long items_q = static_cast<long long>(B) * p.H * p.n_qt;
  if (items_k > 0x7fffffffLL || items_q > 0x7fffffffLL || (rows + 255) / 256 > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err != cudaSuccess) return err;
  delta_kernel<D><<<static_cast<unsigned int>((rows + 255) / 256), 256, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<static_cast<unsigned int>(items_k), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<static_cast<unsigned int>(items_q), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t attrs(int* regs, int* smem_bytes) {
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, dkdv_kernel<D>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&b, dq_kernel<D>);
  if (err == cudaSuccess) {
    *regs = a.numRegs > b.numRegs ? a.numRegs : b.numRegs;
    *smem_bytes = Layout<D>::kBytes;
  }
  return err;
}

}  // namespace

extern "C" int videogpa_flash_attn_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int H, int Nq, int Nk,
    int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long o_sb,
    long long o_sn, long long o_sh, long long do_sb, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sn,
    long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh, float scale,
    void* stream) {
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
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
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
  bool vec4 = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long st : {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn,
                       do_sh}) {
    vec4 = vec4 && st % 4 == 0;
  }
  p.vec4 = vec4 ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The larger of the two main kernels' registers a thread, and their dynamic
// shared memory a CTA, at head_dim D, for reports.
extern "C" int videogpa_flash_attn_bwd_f32_attrs(int D, int* regs, int* smem_bytes) {
  switch (D) {
    case 16: return attrs<16>(regs, smem_bytes);
    case 32: return attrs<32>(regs, smem_bytes);
    case 64: return attrs<64>(regs, smem_bytes);
    case 128: return attrs<128>(regs, smem_bytes);
    default: return cudaErrorInvalidValue;
  }
}
