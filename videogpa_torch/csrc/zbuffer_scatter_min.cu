// Per-slot uint32 minimum over a flat buffer for Hopper (sm_90a):
// buf[lin[u]] = min(buf[lin[u]], key[u]) for every update u whose key is not
// the sentinel 0xFFFFFFFF.
//
// Replaces the TPU Pallas kernel videogpa_tpu/geometry/zbuffer_kernel.py
// `_build` (call :167), the tiered windowed scatter-min, and with it the XLA
// scatter `buf.at[lin].min(key)` of the packed z-buffer
// (videogpa_tpu/geometry/projection.py:266-267) and the exact two-pass
// lowering (projection.py:75-84). The TPU has no per-lane scatter, so that
// kernel bins updates into address windows and reduces all pairs; Hopper has
// a native atomicMin on 32-bit words in L2, so here each update is one
// thread and one atomic. Min is exact and order-free: the result is bit for
// bit the sequential scatter's, whatever order the atomics land in.
//
// Bound: bytes. Each update reads 8 bytes (int32 address, uint32 key); per
// scorer batch of K = 4 clips that is 4 x 26.8 M updates = 0.86 GB, 0.26 ms
// at 3.35 TB/s. The per-clip destination (2.68 M slots, 10.7 MB) stays in the
// 50 MB L2, so the atomics run at L2 atomic throughput, which is what the
// kernel's time measures. The wrapper fills the buffer with 0xFFFFFFFF
// (torch.full) before the launch; the kernel only lowers it.
//
// Plain C interface (ctypes). Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
    scatter_min_kernel(const int32_t* __restrict__ lin, const uint32_t* __restrict__ key,
                       uint32_t* __restrict__ buf, long long n_updates) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       u < n_updates; u += stride) {
    const uint32_t kv = key[u];
    if (kv != kSentinel) atomicMin(buf + lin[u], kv);
  }
}

}  // namespace

extern "C" int videogpa_scatter_min_u32(const void* lin, const void* key, void* buf,
                                        long long n_updates, void* stream) {
  if (n_updates <= 0) return cudaSuccess;
  // enough blocks to fill the card several times over; the grid-stride loop
  // covers the rest
  long long blocks = (n_updates + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  scatter_min_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lin), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(buf), n_updates);
  return cudaGetLastError();
}
