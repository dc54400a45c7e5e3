// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T / sqrt(D)) V,
// non-causal, bf16 operands, f32 accumulation, optional natural-log LSE,
// head_dim 16, 32 or 64.
//
// Replaces the TPU Pallas kernels videogpa_tpu/ops/attention.py
// `_fwd_kernel_T` (the lagged-max forward, D < 128) and `_fwd_kernel_T_stall`
// (its clamp-free exactness fallback). This kernel is a plain online softmax
// with no clamp, so it is exact for any logit range and covers both.
//
// Bound: tensor-core operations. 4*B*H*Nq*Nk*D FLOPs against 2*B*H*(Nq+Nk)*D*2
// bytes of operands; at the CogVideoX-5B DiT shape (B=2, N=17,776, H=48, D=64)
// that is ~7.77 TFLOP per layer, ~7.9 ms at the 989 TFLOP/s bf16 dense peak,
// while its ~0.87 GB of operands and output need ~0.26 ms at 3.35 TB/s.
// Design: flash_fwd_tile.cuh (mma.sync online softmax, 64x64 tiles,
// double-buffered cp.async, strided operands), shared with K6's bf16 path.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launch.

#include "flash_fwd_tile.cuh"

using namespace videogpa::flash_fwd;

extern "C" int videogpa_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int D, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale_log2, void* stream) {
  const long long strides[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                                 v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  const Params p = make_params(q, k, v, o, lse, H, Nq, Nk, strides, scale_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
