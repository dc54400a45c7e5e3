// Attention forward on the CUDA cores at any head_dim > 128 that is a
// multiple of 64, in float32, with an optional natural-log LSE (sm_90a):
// O = softmax(S) V, non-causal.
//
// Replaces `_fwd_kernel` (videogpa_tpu/ops/attention.py:65; calls at :175
// with LSE and :186 without), which the JAX package runs at every D >= 128
// (at D % 128 != 0 with its ones-column, :138-144), on f32 operands. bf16
// operands at these widths run on the tensor cores
// (flash_attn_fwd_wide_bf16.cu); f32 stays on the CUDA cores, since TF32
// would move the numbers away from the JAX package's. `attention()`
// zero-pads any other D > 128 to the next multiple of 64 and passes D's
// scale. S = Q K^T * scale in the log2 domain, an exact online softmax, P V
// in f32, O / l. Bound: 4*B*H*Nq*Nk*D operations over the 67 TFLOP/s f32
// peak; at (1, 4,096, 16, 256) 4.10 ms.
//
// Design: one CTA per (64-query tile, slice of O, b*h) on a flat grid (any
// B*H). A slice is at most 256 columns of O (D <= 256 is one slice; above,
// D's nc 64-column chunks are cut into ceil(nc / 4) slices of three or four
// chunks, the last possibly narrower), so O stays in registers: 4 rows x 4
// columns of each chunk a thread, 64 floats at 256 columns. For each 64-key
// tile the CTA computes S once, streaming 64-column chunks of Q and K
// through two cp.async stages, then streams the slice's V chunks through the
// same stages (a V chunk takes Q's place) for P V. The thread layout is K6
// f32's: 16 row groups of 4 queries x 16 column groups, S a 4 x 4
// micro-tile a thread, each row's 64 keys reduced over a half-warp, P
// through shared memory as P^T, a V chunk's columns 4 a thread. The earlier
// design computed S again for every 64-column slice of O (10*N^2*D
// operations where 4*N^2*D are needed at D = 256); this one does 4*N^2*D at
// D <= 256 and 2*N^2*D*(1 + n_slices) above.
//
// Rows past Nq or Nk are never loaded; scores of keys past Nk are masked to
// -inf before they are read, rows past Nq are never stored. Operands are
// addressed through (b, n, h) element strides. Plain C interface (ctypes);
// the entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBlock = 64;            // queries a CTA, keys a tile
constexpr int kThreads = 256;         // 16 row groups of 4 queries x 16 column groups
constexpr int kPStride = kBlock + 4;  // floats a row of P^T
constexpr int kChunk = 64;            // columns a chunk of Q, K, V and O
constexpr int kMaxSlice = 4;          // chunks a slice of O holds at most (256 columns)
constexpr float kLn2 = 0.6931471805599453f;

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

// Rows [row0, min(row0 + 64, n)) of an operand (row stride sn elements, W
// contiguous elements from src) into shared-memory rows of RS elements; rows
// past n are not written. 16-byte copies when every row starts on 16 bytes
// (vec), else 4-byte copies (4-byte elements only).
template <typename T, int W, int RS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long sn, int row0, int n,
                                          bool vec) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int rows = min(kBlock, n - row0);
  src += static_cast<long long>(row0) * sn;
  if (vec) {
    for (int c = threadIdx.x; c < rows * (W / kV); c += kThreads) {
      const int r = c / (W / kV);
      const int d = kV * (c % (W / kV));
      cp_async_16(dst + r * RS + d, src + r * sn + d);
    }
  } else {
    for (int c = threadIdx.x; c < rows * W; c += kThreads) {
      const int r = c / W;
      const int d = c % W;
      cp_async_4(dst + r * RS + d, src + r * sn + d);
    }
  }
}

// The online-softmax step: scores s (4 rows x keys cg
// + 16 c, already in the log2 domain, keys >= Nk at -inf) update the running
// max m and this thread's share of the row sums l; s becomes P; alpha is the
// rescale of O. Each row's 64 keys are spread over the 16 lanes of a
// half-warp.
__device__ __forceinline__ void softmax_step(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                             float (&alpha)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) mt = fmaxf(mt, s[i][c]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float mnew = fmaxf(m[i], mt);  // finite: the tile's first key is live
    alpha[i] = exp2f(m[i] - mnew);       // 0 on the first tile
    m[i] = mnew;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[i][c] = exp2f(s[i][c] - mnew);
      rs += s[i][c];
    }
    l[i] = l[i] * alpha[i] + rs;
  }
}

struct WideParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B*H, Nq) or nullptr
  int H, Nq, Nk, nc, n_slices, n_qt, vec;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;
};

constexpr int kRS = kChunk + 4;  // floats a row of a chunk tile (16-byte padded)
constexpr int kTileFloats = kBlock * kRS;
constexpr int kStageFloats = 2 * kTileFloats;  // Q and K chunks, or a V chunk in Q's place
constexpr int kWideBytes = (2 * kStageFloats + kBlock * kPStride) * 4;

// One CTA per item = (b*h * n_slices + slice) * n_qt + query tile; NCS
// chunks a slice. Thread t holds rows 4 (t / 16) + 0..3 of the tile; for S
// the keys t % 16 + 16 c of the key tile, for O the columns 4 (t % 16) + 0..3
// of each of the slice's chunks. Stage s = key tile * (nc + live) + r: r < nc
// brings chunk r of Q and K, r >= nc chunk c0 + r - nc of V.
template <int NCS>
__global__ void __launch_bounds__(kThreads) attn_wide_f32_kernel(const WideParams p) {
  extern __shared__ __align__(16) float smw[];
  const int item = blockIdx.x;
  const int i_tile = item % p.n_qt;
  const int grp = item / p.n_qt;
  const int slice = grp % p.n_slices;
  const int bh = grp / p.n_slices;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;
  const bool vec = p.vec != 0;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;
  const int q0 = i_tile * kBlock;
  const bool rows_live = 4 * rg < p.Nq - q0;
  const int c0 = slice * NCS;
  const int live = min(NCS, p.nc - c0);
  const int n_per = p.nc + live;  // stages a key tile
  const int n_kt = (p.Nk + kBlock - 1) / kBlock;
  const int n_stages = n_kt * n_per;
  float* sp = smw + 2 * kStageFloats;

  auto issue = [&](int s) {
    float* buf = smw + (s & 1) * kStageFloats;
    const int j = s / n_per;
    const int r = s % n_per;
    if (r < p.nc) {
      load_rows<float, kChunk, kRS>(buf, q + r * kChunk, p.q_sn, q0, p.Nq, vec);
      load_rows<float, kChunk, kRS>(buf + kTileFloats, k + r * kChunk, p.k_sn, j * kBlock, p.Nk,
                                    vec);
    } else {
      load_rows<float, kChunk, kRS>(buf, v + (c0 + r - p.nc) * kChunk, p.v_sn, j * kBlock, p.Nk,
                                    vec);
    }
  };
  issue(0);
  cp_async_commit();

  float acc[4][NCS * 4], m[4], l[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NCS * 4; ++e) acc[i][e] = 0.f;
  }

  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) issue(st + 1);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    const float* buf = smw + (st & 1) * kStageFloats;
    const int j = st / n_per;
    const int r = st % n_per;
    const int key0 = j * kBlock;
    const int kn = min(kBlock, p.Nk - key0);  // live keys in this tile
    if (r < p.nc) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
        }
      }
      if (rows_live && cg < kn) {  // S += Q K^T over this chunk
        const float* qa = buf + 4 * rg * kRS;
        const float* kb = buf + kTileFloats + cg * kRS;
#pragma unroll 4
        for (int d = 0; d < kChunk; d += 4) {
          float4 x[4], y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(qa + i * kRS + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            y[c] = *reinterpret_cast<const float4*>(kb + 16 * c * kRS + d);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              s[i][c] = fmaf(x[i].x, y[c].x, s[i][c]);
              s[i][c] = fmaf(x[i].y, y[c].y, s[i][c]);
              s[i][c] = fmaf(x[i].z, y[c].z, s[i][c]);
              s[i][c] = fmaf(x[i].w, y[c].w, s[i][c]);
            }
          }
        }
      }
      if (r == p.nc - 1) {  // S is whole: the softmax, P^T, the rescale of O
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[i][c] = key0 + cg + 16 * c < p.Nk ? s[i][c] * p.scale_log2 : -INFINITY;
          }
        }
        float alpha[4];
        softmax_step(s, m, l, alpha);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          *reinterpret_cast<float4*>(sp + (cg + 16 * c) * kPStride + 4 * rg) =
              make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < NCS * 4; ++e) acc[i][e] *= alpha[i];
        }
      }
    } else {  // O[:, chunk] += P V[:, chunk]; P^T was written a stage earlier
      const int u = r - p.nc;
      const float* vcol = buf + 4 * cg;
#pragma unroll
      for (int w = 0; w < NCS; ++w) {
        if (w != u) continue;
#pragma unroll 4
        for (int key = 0; key < (rows_live ? kn : 0); ++key) {
          const float4 pk = *reinterpret_cast<const float4*>(sp + key * kPStride + 4 * rg);
          const float pr[4] = {pk.x, pk.y, pk.z, pk.w};
          const float4 x = *reinterpret_cast<const float4*>(vcol + key * kRS);
          const float vv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][4 * w + e] = fmaf(pr[i], vv[e], acc[i][4 * w + e]);
          }
        }
      }
    }
    __syncthreads();  // this stage's buffer (and, after the last V chunk, P^T) is rewritten next
  }

  // epilogue: the row sums over the half-warp, O / l through the strides, LSE
  float* o = p.o + b * p.o_sb + h * p.o_sh + kChunk * c0 + 4 * cg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + 4 * rg + i;
    if (row >= p.Nq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int w = 0; w < NCS; ++w) {
      if (w >= live) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[row * p.o_sn + kChunk * w + e] = acc[i][4 * w + e] * inv;
    }
    if (p.lse != nullptr && slice == 0 && cg == 0) {
      p.lse[static_cast<long long>(bh) * p.Nq + row] = (m[i] + log2f(l[i])) * kLn2;
    }
  }
}

// The slice geometry at head_dim D: chunks, slices and chunks a slice.
void slices_of(int D, int* nc, int* n_slices, int* ncs) {
  *nc = D / kChunk;
  *n_slices = (*nc + kMaxSlice - 1) / kMaxSlice;
  *ncs = (*nc + *n_slices - 1) / *n_slices;
}

template <int NCS>
cudaError_t launch_wide(const WideParams& p, long long items, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attn_wide_f32_kernel<NCS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideBytes);
  if (err != cudaSuccess) return err;
  attn_wide_f32_kernel<NCS><<<static_cast<unsigned int>(items), kThreads, kWideBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename K>
cudaError_t attrs_of(K kernel, int bytes, int* regs, int* smem_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *smem_bytes = bytes;
  }
  return err;
}

}  // namespace

extern "C" int videogpa_flash_attn_fwd_wide_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  if (B < 1 || H < 1 || Nq < 1 || Nk < 1 || D <= 128 || D % kChunk != 0) {
    return cudaErrorInvalidValue;
  }
  int ncs = 0;
  WideParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H; p.Nq = Nq; p.Nk = Nk;
  slices_of(D, &p.nc, &p.n_slices, &ncs);
  p.n_qt = (Nq + kBlock - 1) / kBlock;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  // 16-byte copies when every row of q, k and v starts on 16 bytes
  bool vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (long long s : {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh}) {
    vec = vec && s % 4 == 0;
  }
  p.vec = vec ? 1 : 0;
  const long long items = static_cast<long long>(B) * H * p.n_slices * p.n_qt;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ncs == 3 ? launch_wide<3>(p, items, s) : launch_wide<4>(p, items, s);
}

// registers a thread and dynamic shared memory a CTA at head_dim D, for reports
extern "C" int videogpa_flash_attn_fwd_wide_f32_attrs(int D, int* regs, int* smem_bytes) {
  if (D <= 128 || D % kChunk != 0) return cudaErrorInvalidValue;
  int nc = 0, n_slices = 0, ncs = 0;
  slices_of(D, &nc, &n_slices, &ncs);
  return ncs == 3 ? attrs_of(attn_wide_f32_kernel<3>, kWideBytes, regs, smem_bytes)
                  : attrs_of(attn_wide_f32_kernel<4>, kWideBytes, regs, smem_bytes);
}
