// copy_pages — copy-on-write page duplication, in place, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, copy_pages_pallas.  The
// TPU kernel writes every one of the pool's P pages, identity pages
// included, driven by a scalar-prefetched per-page source map, so that its
// grid stays well-formed.  Here only the real (src, dst) pairs are copied,
// in place, across all L layers of up to two pools (a tier's K and V) in
// one launch; the pairs travel in the kernel's parameter block.
//
// What bounds it on the H100: HBM bytes, 2 * pages * L * page_bytes per
// pool (each copied page read once and written once).  A tick copies at
// most admit_width pages per layer, a few hundred KiB at full width.
//
// What the design does about that: one block per (pair, layer, pool), each
// moving one page with 16-byte loads and stores, neighbouring threads on
// neighbouring addresses.  The wrapper checks on the host that destinations
// are distinct and disjoint from sources, so the blocks' order does not
// matter.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 256;

struct PagePairs {
  int src[kMaxPairs];
  int dst[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads)
copy_pages_kernel(unsigned char* __restrict__ pool_a,
                  unsigned char* __restrict__ pool_b,
                  int64_t layer_bytes, int64_t page_bytes, PagePairs pairs) {
  const int pair = blockIdx.x, layer = blockIdx.y;
  unsigned char* base = (blockIdx.z ? pool_b : pool_a) + layer * layer_bytes;
  const int4* src =
      reinterpret_cast<const int4*>(base + pairs.src[pair] * page_bytes);
  int4* dst = reinterpret_cast<int4*>(base + pairs.dst[pair] * page_bytes);
  const int64_t n = page_bytes / 16;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

}  // namespace

// pool_a, pool_b: (L, P, ...) pools of one shape (pool_b unused when
// n_pools == 1), each layer `layer_bytes` and each page `page_bytes` long,
// both multiples of 16, on 16-byte boundaries; src/dst: host int32 arrays
// of n <= 256 page ids, destinations distinct and disjoint from sources.
// Returns cudaGetLastError() after the launch.
extern "C" int copy_pages_launch(void* pool_a, void* pool_b, int n_pools,
                                 int layers, long long layer_bytes,
                                 long long page_bytes, const int* src,
                                 const int* dst, int n, void* stream) {
  if (n < 0 || n > kMaxPairs || n_pools < 1 || n_pools > 2 || layers < 1 ||
      page_bytes % 16 || layer_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  PagePairs pairs;
  for (int i = 0; i < n; ++i) {
    pairs.src[i] = src[i];
    pairs.dst[i] = dst[i];
  }
  copy_pages_kernel<<<dim3(n, layers, n_pools), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(pool_a), static_cast<unsigned char*>(pool_b),
      layer_bytes, page_bytes, pairs);
  return static_cast<int>(cudaGetLastError());
}
