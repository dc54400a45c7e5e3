// Warp-level primitives of the port's int8-QK flash-attention kernels K8 and
// K9 (flash_attn_int8.cu, sm_90a): 16-byte cp.async copies with zero fill,
// mma.sync m16n8k16 bf16 -> f32, ldmatrix.trans, bf16 packing and a padded
// tile loader.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace videogpa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + kRows) of one head (row stride `row_stride`
// elements) into a padded shared tile with all kThreads threads of the CTA;
// rows >= n_rows become zeros.
template <int D, int kStride, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kStride],
                                          const __nv_bfloat16* base, long long row_stride,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < n_rows;
    const __nv_bfloat16* src = base + (valid ? row : 0) * row_stride + col;
    cp_async_16(&dst[r][col], src, valid);
  }
}

}  // namespace videogpa
