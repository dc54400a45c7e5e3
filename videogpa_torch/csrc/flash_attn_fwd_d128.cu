// Flash-attention forward where K1 does not apply (sm_90a):
// O = softmax(Q K^T / sqrt(D)) V, non-causal, optional natural-log LSE.
//
// Replaces the TPU Pallas kernel videogpa_tpu/ops/attention.py `_fwd_kernel`
// (the classic online-softmax forward that the JAX package runs at
// head_dim >= 128; calls at :175 and :186). Two entry points:
//
// 1. bf16, head_dim 128 (the Wan DiT's heads): flash_fwd_tile.cuh, K1's
//    mma.sync tile at D = 128. The 64-row tiles of Q, K and V (x2) take
//    87 KB of dynamic shared memory, set with cudaFuncSetAttribute. Bound:
//    tensor-core operations, 4*B*H*Nq*Nk*D; at (1, 18,480, 24, 128) that is
//    4.20 TFLOP, 4.24 ms at the 989 TFLOP/s bf16 dense peak.
//
// 2. float32, head_dim 16/32/64/128: the VGGT camera head's trunk
//    (dim 2048, 16 heads of 128) runs in f32, and so does the scorer's
//    reference-exact f32 mode, so the operands are never rounded to bf16 or
//    TF32. CUDA cores only: one warp per query row, each lane holding
//    ceil(D/32) strided elements of q, the O accumulator and the running
//    max/sum; for each key the warp reduces q.k with shuffles and updates an
//    exact online softmax in the log2 domain. At the camera head's shape
//    (B=4, 10 tokens, 16 heads, 128) a call moves 0.33 MB and does 1.3 MFLOP:
//    bound by bytes (0.1 us at 3.35 TB/s) and in practice by the launch.
//    The per-key warp reduction makes it slow for long rows: it is the
//    kernel for short f32 rows, not for the bf16 DiTs.
//
// Operands are addressed through element strides for (b, n, h), so
// (B, N, H, D) views straight from the qkv projection go in without a copy.
// Plain C interface (ctypes). Each entry returns cudaGetLastError() after
// its launch.

#include "flash_fwd_tile.cuh"

namespace {

constexpr int kWarpsF32 = 4;  // query rows per CTA in the f32 kernel
constexpr float kLn2F32 = 0.6931471805599453f;

struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, H, Nq) or nullptr
  int H, Nq, Nk;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kWarpsF32 * 32) attn_f32_kernel(const ParamsF32 p) {
  constexpr int E = (D + 31) / 32;  // elements of the head dim per lane
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsF32 + warp;
  if (row >= p.Nq) return;  // the whole warp leaves together
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const float* q = p.q + b * p.q_sb + h * p.q_sh + row * p.q_sn;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;

  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    qv[e] = d < D ? q[d] * p.scale_log2 : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY;  // running max, log2 domain
  float l = 0.f;        // running sum
  for (int j = 0; j < p.Nk; ++j) {
    const float* kr = k + j * p.k_sn;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      if (d < D) s = fmaf(qv[e], kr[d], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float alpha = exp2f(m - m_new);  // 0 on the first key
    const float pe = exp2f(s - m_new);
    l = l * alpha + pe;
    m = m_new;
    const float* vr = v + j * p.v_sn;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane + 32 * e;
      acc[e] = acc[e] * alpha + (d < D ? pe * vr[d] : 0.f);
    }
  }
  const float inv = 1.f / l;
  float* o = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < D) o[d] = acc[e] * inv;
  }
  if (p.lse != nullptr && lane == 0) {
    p.lse[static_cast<long long>(bh) * p.Nq + row] = (m + log2f(l)) * kLn2F32;
  }
}

template <int D>
cudaError_t launch_f32(const ParamsF32& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Nq + kWarpsF32 - 1) / kWarpsF32, B * p.H);
  attn_f32_kernel<D><<<grid, kWarpsF32 * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int videogpa_flash_attn_fwd_d128_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  using namespace videogpa::flash_fwd;
  if (D != 128) return cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                                 v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const Params p = make_params(q, k, v, o, lse, H, Nq, Nk, strides, scale_log2);
  return launch<128>(p, B, static_cast<cudaStream_t>(stream));
}

extern "C" int videogpa_flash_attn_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_f32<16>(p, B, s);
    case 32: return launch_f32<32>(p, B, s);
    case 64: return launch_f32<64>(p, B, s);
    case 128: return launch_f32<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
