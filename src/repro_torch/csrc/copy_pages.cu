// copy_pages — copy-on-write page duplication, in place, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, copy_pages_pallas.  The
// TPU kernel writes every one of the pool's P pages, identity pages
// included, driven by a scalar-prefetched per-page source map, so that its
// grid stays well-formed; the reference runs it once per pool and once per
// int8 pool's (L, P, K) float32 scale rows.  Here only the real (src, dst)
// pairs are copied, in place, across all L layers of up to four tensors (a
// tier's K and V pools and, for int8 pools, their K and V scale rows) in
// one launch; the pairs travel in the kernel's parameter block.
//
// What bounds it on the H100: HBM bytes, 2 * pages * L * page_bytes per
// tensor (each copied page read once and written once).  A tick copies at
// most admit_width pages per layer, a few hundred KiB at full width.
//
// What the design does about that: one block per (pair, layer, tensor),
// each moving one page with 16-byte loads and stores, neighbouring threads
// on neighbouring addresses, up to kUnroll loads in flight per thread
// before their stores (a zamba2 int8 page is 40 KiB: ten 16-byte words a
// thread).  A tensor whose page or layer stride, or base,
// is not a multiple of 16 bytes (a scale row is K * 4 bytes: 8 for
// qwen2-1.5b, 4 for gemma3-1b) moves in 4-byte words, or bytes when not a
// multiple of 4 either; that choice is uniform over a block.  The wrapper
// checks on the host that destinations are distinct and disjoint from
// sources, so the blocks' order does not matter.
//
// The host side costs more than the copy (a tick copies a few pages in
// about 2 us on the card): the wrapper keeps each tuple of pools' block of
// base addresses and strides on the host and passes it, and the pairs
// packed in one int32 buffer, by one pointer each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 256;
constexpr int kMaxTensors = 4;
constexpr int kUnroll = 4;

struct PagePairs {
  int src[kMaxPairs];
  int dst[kMaxPairs];
};

struct Tensors {
  unsigned char* base[kMaxTensors];
  int64_t layer_bytes[kMaxTensors];
  int64_t page_bytes[kMaxTensors];
};

template <typename W>
__device__ __forceinline__ void copy_words(const unsigned char* src,
                                           unsigned char* dst, int64_t bytes) {
  const W* __restrict__ s = reinterpret_cast<const W*>(src);
  W* __restrict__ d = reinterpret_cast<W*>(dst);
  const int64_t n = bytes / static_cast<int64_t>(sizeof(W));
  int64_t i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
    W w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) w[u] = s[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[i + u * kThreads] = w[u];
  }
  for (; i < n; i += kThreads) d[i] = s[i];
}

// __grid_constant__: the block indexes the parameter structs with its own
// ids; without it the compiler copies them to a local stack frame first
__global__ void __launch_bounds__(kThreads)
copy_pages_kernel(const __grid_constant__ Tensors t,
                  const __grid_constant__ PagePairs pairs) {
  const int pair = blockIdx.x, layer = blockIdx.y, z = blockIdx.z;
  const int64_t pb = t.page_bytes[z];
  unsigned char* base = t.base[z] + layer * t.layer_bytes[z];
  const unsigned char* src = base + pairs.src[pair] * pb;
  unsigned char* dst = base + pairs.dst[pair] * pb;
  const uint64_t align = static_cast<uint64_t>(pb) |
                         static_cast<uint64_t>(t.layer_bytes[z]) |
                         reinterpret_cast<uintptr_t>(t.base[z]);
  if (align % 16 == 0)
    copy_words<int4>(src, dst, pb);
  else if (align % 4 == 0)
    copy_words<int>(src, dst, pb);
  else
    copy_words<unsigned char>(src, dst, pb);
}

}  // namespace

// tensors: a host block of 3 * n_tensors int64 values: the n_tensors (1..4)
// device base addresses of (L, P, ...) tensors with the same L and P, then
// each tensor's layer stride in bytes, then its page stride in bytes.
// pairs: a host int32 buffer of n <= 256 source page ids, then n
// destination page ids, destinations distinct and disjoint from sources.
// Returns cudaGetLastError() after the launch.
extern "C" int copy_pages_launch(const void* tensors, int n_tensors,
                                 int layers, const void* pairs, int n,
                                 void* stream) {
  if (n < 0 || n > kMaxPairs || n_tensors < 1 || n_tensors > kMaxTensors ||
      layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* block = static_cast<const int64_t*>(tensors);
  Tensors t = {};
  for (int i = 0; i < n_tensors; ++i) {
    const int64_t base = block[i], lb = block[n_tensors + i],
                  pb = block[2 * n_tensors + i];
    if (base == 0 || pb < 1 || lb < pb)
      return static_cast<int>(cudaErrorInvalidValue);
    t.base[i] = reinterpret_cast<unsigned char*>(base);
    t.layer_bytes[i] = lb;
    t.page_bytes[i] = pb;
  }
  if (n == 0) return 0;
  const int* ids = static_cast<const int*>(pairs);
  PagePairs pp;
  for (int i = 0; i < n; ++i) {
    pp.src[i] = ids[i];
    pp.dst[i] = ids[n + i];
  }
  copy_pages_kernel<<<dim3(n, layers, n_tensors), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, pp);
  return static_cast<int>(cudaGetLastError());
}
