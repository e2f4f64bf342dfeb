// chunk-paged attention — C query tokens per slot over a paged KV pool, on
// Hopper's tensor cores (sm_90a).  The chunked-prefill lane's attention.
//
// Replaces: src/repro/kernels/decode_attention.py,
//   decode_attention_chunk_paged_pallas (bodies _chunk_paged_kernel and,
//   for int8 pools, _chunk_paged_kernel_quant, sharing
//   _chunk_flash_update).  The decode case (C = 1) stays with
//   paged_attention_split_kernel in decode_attention_paged.cu: the wrapper
//   decode_attention_chunk_paged_cuda calls this file's entry point for
//   C > 1 only.
// The pool is (P, page, K, D); an int32 block table (B, n_pages) maps each
// slot's logical pages to physical ones; a (B, C, n_pages * page) byte mask
// says which key positions each query may see (any mask: position, the
// intra-chunk causal structure, a sliding window).  Like the TPU kernels it
// keeps q in float32, starts the running max at -1e30, gives masked keys
// probability 0 by a select and finishes with acc / max(l, 1e-30), so a
// query that sees no key returns exactly 0.  An int8 pool comes with (P, K)
// float32 scales, one per physical page and kv head.
//
// What bounds it on the H100: operations, once the copies are hidden.  A
// block's 32 query rows share every K/V row it stages, so at qwen2's chunk
// lane (C = 256, G = 6, D 128, ~500 keys) it does ~100 multiply-adds per
// byte read.  The float32 FMA bound is 12 us there; that of the three bf16
// tensor-core passes below, 2.4 us.  What holds it back in practice is each
// block's serial walk over its key tiles (9 at 544 positions): per tile
// the producers' metadata and issue of 2,048 16-byte copies (32 KB of bf16
// K/V), and the consumers' dependent MMA and exp chains.
//
// What the design does about that:
//   * one block per (kv head, slot, 32 query rows); a query row is a (chunk
//     token, group head) pair ordered by token, so the union of a block's
//     mask rows is narrow.  32-row blocks give qwen2's L chunk case
//     (2 slots x 2 kv heads x 1,536 rows) 192 blocks for the 132 SMs (64-row
//     blocks, measured, were slower: half the blocks, the same tiles each);
//   * Q.K^T and P.V run as mma.sync.m16n8k16 with bf16 operands and float32
//     accumulators.  One bf16 pass over float32 q and p misses the 1e-4
//     tolerance (about 1e-3 to 5e-2), and so does a split into two bf16
//     terms at full-range int8 levels (6e-5 of the 1e-4), so each float32
//     operand is split into three, hi = bf16(x), mid = bf16(x - hi) and
//     lo = bf16(x - hi - mid), all three into the same accumulator: about
//     1e-6 from a float64 reference, closer than the float32 plain version
//     (tests/test_torch_kernel_design.py).  The pool operand is exact in
//     bf16: a bf16 page as it is, an int8 level in -128..127 (converted by
//     a float bit trick, not the slower int-to-float unit).  A float32 pool
//     (tests only) is split in two and adds hi . pool_lo;
//   * int8: each score column is multiplied by its row's scale_k after
//     Q.K^T, and scale_v is folded into P before the split;
//   * warp specialisation: two producer warps run one stage ahead of four
//     consumer warps, handing stages over through mbarriers (full, tracking
//     the producers' cp.async copies; meta; empty).  The producers turn each
//     tile's mask bytes into one bit per (chunk token, key) by warp ballots,
//     find the keys some query row of the block sees, read their block-table
//     entries and int8 scales, and copy their K/V rows with cp.async, 16
//     bytes a lane (8 for an int8 row of D 120), into two stages of shared
//     memory, while the consumers
//     compute the tile before.  The consumers are two row groups of 16 rows
//     times two halves of each key tile; each keeps its online softmax (m,
//     l, acc) in registers, on exp2 with log2(e) folded into the scale; the
//     two key halves merge once, in a fixed order, at the end.  They load
//     the q terms' fragments, and a bf16 tile's K and V fragments, with
//     ldmatrix (V transposed): one instruction for four 8 x 8 blocks.  A
//     head dim that is not whole k-steps of 16 (D 120) runs at the depth
//     rounded up (128): the staged q and K/V rows carry zero columns past
//     D, written once per block, which the copies never touch, so the
//     pool is read only to D and the pad adds exact zeros;
//   * a key row that no query row of the block sees is never loaded, and
//     its shared-memory slot is zero-filled by the copy itself (src-size 0):
//     an MMA multiplies every staged element, and 0 x NaN is NaN.  Its int8
//     scale is not read and reads as 0.  A tile no query row sees is not
//     copied and not computed;
//   * the mask is read, never derived from positions, and a masked (query,
//     key) pair gets probability 0 by a select after the exp.
// Shared memory: ~100 KB at the main path's shapes, up to ~170 KB (float32
// pools at D 256), above the 48 KB default, so the first launch of each
// instantiation raises the limit with cudaFuncSetAttribute, and every call
// returns that call's error if it failed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTerms = 3;         // bf16 terms of a float32 operand
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  // groups of 16 query rows per block, each group two consumer warps (one
  // per half of a key tile)
  static constexpr int kRowGroups = 2;
  static constexpr int kRows = 16 * kRowGroups;
  static constexpr int kWarps = 2 * kRowGroups;    // the consumers
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kProducers = 2;             // and two producer warps
  static constexpr int kThreads = kConsumers + 32 * kProducers;
  static constexpr int kMaxTok = kRows;            // chunk tokens among them
  // keys per stage; each warp takes half of them
  static constexpr int kTile = D * (int)sizeof(T) <= 256 ? 64 : 32;
  static constexpr int kWarpKeys = kTile / 2;
  static constexpr int kWords = kTile / 32;        // mask words per token
  // the MMAs' depth: D padded to whole k-steps of 16 (D 120 -> 128); the
  // staged q and K/V columns D .. kDp - 1 are zeros, set once per block
  static constexpr int kDp = (D + 15) / 16 * 16;
  // bytes per copy: 16, or 8 where a row is not whole 16-byte units (int8
  // at D 120); no copy reads past the head's D elements
  static constexpr int kCopy = D * (int)sizeof(T) % 16 == 0 ? 16 : 8;
  static constexpr int kVec = kCopy / (int)sizeof(T);  // elements per copy
  static constexpr int kVecPerRow = D / kVec;
  // staged rows padded by 16 bytes: conflict-free fragment reads
  static constexpr int kLd = kDp + 16 / (int)sizeof(T);
  static constexpr int kQld = kDp + 8;             // bf16 q rows
  static constexpr int kKvBytes = 2 * 2 * kTile * kLd * (int)sizeof(T);
  static constexpr int kMergeBytes = kRowGroups * 16 * (D + 2) * 4;
  static constexpr int kArea = kKvBytes > kMergeBytes ? kKvBytes : kMergeBytes;
  static constexpr int kQOff = kArea;
  static constexpr int kBitsOff = kQOff + kTerms * kRows * kQld * 2;
  static constexpr int kLiveOff = kBitsOff + 2 * kMaxTok * kWords * 4;
  static constexpr int kRowOff = kLiveOff + 2 * kWords * 4;
  static constexpr int kScaleOff = kRowOff + 2 * kTile * 8;
  static constexpr int kBarOff = kScaleOff + 2 * 2 * kTile * 4;
  static constexpr int kSmem = kBarOff + 6 * 8;  // full, meta, empty: x 2
  // separate Q.K^T accumulators per term where registers allow
  static constexpr bool kSepAcc = D <= 128 && sizeof(T) != 1;
  static_assert(D % 8 == 0 && D % kVec == 0, "unsupported head dim");
  static_assert(kWarpKeys % 16 == 0, "a warp's keys are whole MMA steps");
  static_assert(kArea % 16 == 0 && kBitsOff % 16 == 0 && kRowOff % 8 == 0 &&
                kBarOff % 8 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes (16 or 8) from global to shared; src_size 0 reads nothing and
// zero-fills
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_size) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_size) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_size) : "memory");
}

// mbarriers: the producer warps hand stages to the consumers and back
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// D (16x8 f32) += A (16x16 bf16, row) . B (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 matrices of 16-bit elements from shared memory, one register
// each; lanes 8 m .. 8 m + 7 give matrix m's row addresses.  .trans hands
// out the transposed matrices.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as N bf16 terms each, t[i] = bf16(x - t[0] - ... - t[i-1]), as
// pairs: hi, mid, lo for N = 3
template <int N>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
    __nv_bfloat162 h;
    h.x = h0;
    h.y = h1;
    t[i] = *reinterpret_cast<uint32_t*>(&h);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
}

// int8 levels as exact floats without the int-to-float unit: 2^23 + 128 + x
// has the bits 0x4B000000 | (x ^ 0x80) in its low byte
__device__ __forceinline__ float level(uint32_t byte) {
  return __uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.f;
}

// Two neighbouring elements p[0], p[1] of a staged int8 or float32 row as a
// B-operand pair: hi (and, for float32, lo; otherwise lo is unused).  bf16
// tiles are read by ldmatrix instead.
template <typename T>
__device__ __forceinline__ void pair(const T* p, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
    hi = pack(level(v & 0xffu), level(v >> 8));
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    uint32_t t[2];
    split(v.x, v.y, t);
    hi = t[0];
    lo = t[1];
  }
}

// The same for two elements of one column in neighbouring rows
template <typename T>
__device__ __forceinline__ void column_pair(const T* p0, const T* p1,
                                            uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, float>::value) {
    uint32_t t[2];
    split(*p0, *p1, t);
    hi = t[0];
    lo = t[1];
  } else {
    hi = pack(level(*reinterpret_cast<const uint8_t*>(p0)),
              level(*reinterpret_cast<const uint8_t*>(p1)));
  }
}

// T = int8_t reads scale_k / scale_v; the other types get null pointers and
// compile without the scale code.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads)
chunk_paged_attention_kernel(const float* __restrict__ q,
                             const T* __restrict__ pool_k,
                             const T* __restrict__ pool_v,
                             const float* __restrict__ scale_k,
                             const float* __restrict__ scale_v,
                             const int* __restrict__ block,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ out, int c_len, int kv_heads,
                             int group, int page, int n_pages, float scale) {
  using C = Cfg<T, D>;
  constexpr int kRows = C::kRows, kWarps = C::kWarps;
  constexpr int kConsumers = C::kConsumers, kMaxTok = C::kMaxTok;
  constexpr int kRowGroups = C::kRowGroups;
  constexpr int kTile = C::kTile, kLd = C::kLd, kQld = C::kQld;
  constexpr int kWords = C::kWords;
  constexpr int kWarpKeys = C::kWarpKeys;
  constexpr int kNt = kWarpKeys / 8;       // n-tiles of 8 keys per warp
  constexpr int kDp = C::kDp;
  constexpr int kDn = D / 8;               // n-tiles of 8 output columns
  constexpr int kDnp = kDp / 8;            // the same over the padded depth
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_tiles = reinterpret_cast<T*>(smem);          // [stage][K|V][key][kLd]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + C::kQOff);
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + C::kBitsOff);
  uint32_t* livew = reinterpret_cast<uint32_t*>(smem + C::kLiveOff);
  int64_t* row_off = reinterpret_cast<int64_t*>(smem + C::kRowOff);
  float* row_scale = reinterpret_cast<float*>(smem + C::kScaleOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* meta = full + 2;
  uint64_t* empty = full + 4;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_q = c_len * group;            // query rows of (slot, kv head)
  const int heads = kv_heads * group;
  const int s_tot = n_pages * page;
  const int nt = (s_tot + kTile - 1) / kTile;
  const int tok0 = r0 / group;
  const int n_tok = ((r0 + kRows < n_q ? r0 + kRows : n_q) - 1) / group -
                    tok0 + 1;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], 32 * C::kProducers);  // each producer lane's copies
      mbar_init(&meta[i], 1);                // the producer's tile metadata
      mbar_init(&empty[i], kWarps);          // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // q rows -> their kTerms bf16 terms in shared memory (zero past n_q); all
  // of a consumer's loads are in flight before the first is used
  if (tid < kConsumers) {
    constexpr int kPer = kRows * (D / 2) / kConsumers;
    static_assert(kRows * (D / 2) % kConsumers == 0, "q pairs per thread");
    float2 x[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kConsumers;
      const int rq = r0 + i / (D / 2), c2 = (i % (D / 2)) * 2;
      const float* qp =
          q + ((static_cast<int64_t>(b) * c_len + rq / group) * heads +
               kh * group + rq % group) * D + c2;
      x[j] = rq < n_q ? make_float2(qp[0], qp[1]) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kConsumers;
      const int r = i / (D / 2), c2 = (i % (D / 2)) * 2;
      uint32_t t[kTerms];
      split(x[j].x, x[j].y, t);
#pragma unroll
      for (int m = 0; m < kTerms; ++m)
        *reinterpret_cast<uint32_t*>(qs + (m * kRows + r) * kQld + c2) = t[m];
    }
  }
  if constexpr (kDp > D) {
    // columns D .. kDp - 1 of the q terms and of every staged K/V row: an
    // MMA multiplies them, the copies never write them, and shared memory
    // starts as anything (0 x NaN is NaN)
    constexpr int kQw = (kDp - D) / 2;                   // words per q row
    for (int i = tid; i < kTerms * kRows * kQw; i += C::kThreads)
      *reinterpret_cast<uint32_t*>(qs + (i / kQw) * kQld + D +
                                   2 * (i % kQw)) = 0u;
    constexpr int kKw = (kDp - D) * (int)sizeof(T) / 4;  // words per row
    for (int i = tid; i < 2 * 2 * kTile * kKw; i += C::kThreads)
      *reinterpret_cast<uint32_t*>(kv_tiles + (i / kKw) * kLd + D +
                                   (i % kKw) * 4 / (int)sizeof(T)) = 0u;
  }
  __syncthreads();                       // q terms and barriers initialised

  if (warp >= kWarps) {
    // ---- the producer warps, one stage ahead of the consumers: per tile,
    // the mask as one bit per (token, key), the keys some query row sees
    // (live), their int8 scales, and cp.async copies of the live K/V rows;
    // other rows are zero-filled by the copy itself (src-size 0), since an
    // MMA multiplies every staged element and 0 x NaN is NaN.  Producer
    // warp p takes keys 32 p .. 32 p + 31 of the tile, one per lane, and
    // every other copy.  Its mask and block-table reads go to addresses
    // clamped into the arrays, 16 tokens at a time in flight; the
    // conditions apply at use.
    const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;
    const int* blk = block + static_cast<int64_t>(b) * n_pages;
    const uint8_t* vb =
        valid + (static_cast<int64_t>(b) * c_len + tok0) * s_tot;
    const int pw = warp - kWarps;
    // warp pw < kWords owns the tile's keys 32 pw + lane: it reads their
    // block-table entries and the first 16 tokens' mask bytes one tile
    // ahead, so that they land while this tile's copies are issued
    uint8_t mb[16];
    int phys_n = 0;
    auto prefetch = [&](int t) {
      const int key = t * kTile + 32 * pw + lane;
      const int kc = key < s_tot ? key : s_tot - 1;
      phys_n = blk[kc / page];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mb[i] = vb[static_cast<int64_t>(i < n_tok ? i : n_tok - 1) * s_tot +
                   kc];
    };
    if (pw < kWords) prefetch(0);
    for (int t = 0; t < nt; ++t) {
      const int st = t & 1;
      if (t >= 2) mbar_wait(&empty[st], ((t >> 1) - 1) & 1);
      if (pw < kWords) {
        const int w = pw;
        const int key = t * kTile + 32 * w + lane;
        const bool in = key < s_tot;
        const int kc = in ? key : s_tot - 1;
        const int phys = phys_n;
        uint32_t any = 0;
        for (int c0 = 0; c0 < n_tok; c0 += 16) {
          if (c0) {                    // tokens past the first 16
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int tok = c0 + i < n_tok ? c0 + i : n_tok - 1;
              mb[i] = vb[static_cast<int64_t>(tok) * s_tot + kc];
            }
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const uint32_t m = in && c0 + i < n_tok && mb[i];
            const uint32_t bits = __ballot_sync(0xffffffffu, m);
            if (lane == 0 && c0 + i < n_tok)
              mbits[(st * kMaxTok + c0 + i) * kWords + w] = bits;
            any |= m;
          }
        }
        if (t + 1 < nt) prefetch(t + 1);      // lands during the copies
        const uint32_t live = __ballot_sync(0xffffffffu, any);
        const bool lv = (live >> lane) & 1u;
        row_off[st * kTile + 32 * w + lane] =
            lv ? (static_cast<int64_t>(phys) * page + key % page) *
                         row_stride + static_cast<int64_t>(kh) * D
               : -1;
        if (lane == 0) livew[st * kWords + w] = live;
        if constexpr (kQuant) {
          const int64_t si = static_cast<int64_t>(phys) * kv_heads + kh;
          row_scale[(st * 2) * kTile + 32 * w + lane] = lv ? scale_k[si] : 0.f;
          row_scale[(st * 2 + 1) * kTile + 32 * w + lane] =
              lv ? scale_v[si] : 0.f;
        }
      }
      // both producer warps' metadata written (barrier 2)
      asm volatile("bar.sync 2, %0;\n" :: "n"(32 * C::kProducers) : "memory");
      if (pw == 0 && lane == 0) mbar_arrive(&meta[st]);  // mask, keys, scales
      int any_live = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) any_live |= livew[st * kWords + w] != 0u;
      if (any_live) {
        T* kt = kv_tiles + st * 2 * kTile * kLd;
        for (int i = pw * 32 + lane; i < 2 * kTile * C::kVecPerRow;
             i += 32 * C::kProducers) {
          const int which = i / (kTile * C::kVecPerRow);
          const int rem = i % (kTile * C::kVecPerRow);
          const int r = rem / C::kVecPerRow, c = rem % C::kVecPerRow;
          const int64_t off = row_off[st * kTile + r];
          const T* pool = which ? pool_v : pool_k;
          cp_async<C::kCopy>(kt + (which * kTile + r) * kLd + c * C::kVec,
                             off >= 0 ? pool + off + c * C::kVec : pool,
                             off >= 0 ? C::kCopy : 0);
        }
      }
      mbar_arrive_on_copies(&full[st]);
    }
    return;
  }

  // ---- this warp's share: 16 query rows x half of each key tile ---------
  const int rg = warp % kRowGroups, kq = warp / kRowGroups;
  const int g = lane >> 2, tig = lane & 3;
  const int ra = r0 + rg * 16 + g, rb = ra + 8;  // its two query rows
  const int ta = ra < n_q ? ra / group - tok0 : -1;
  const int tb = rb < n_q ? rb / group - tok0 : -1;
  const bool rows_live = r0 + rg * 16 < n_q;
  const int key0 = kq * kWarpKeys;               // first key of the half
  const int word = key0 / 32, bit0 = key0 % 32;

  // over the padded depth: a pad column's sums stay 0 and are not written
  float acc[kDnp][4];
#pragma unroll
  for (int n = 0; n < kDnp; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float ma = kNeg, mb = kNeg, la = 0.f, lb = 0.f;   // l: this thread's part

  auto compute = [&](int st) {
    const T* kt = kv_tiles + st * 2 * kTile * kLd;
    const T* vt = kt + kTile * kLd;
    const uint32_t lw = livew[st * kWords + word];
    const uint32_t half_mask =
        kWarpKeys == 32 ? 0xffffffffu : (0xffffu << bit0);
    if (!rows_live || !(lw & half_mask)) return;   // warp-uniform

    // S = Q . K^T over the warp's keys: the kTerms terms of q, each into
    // its own accumulator where registers allow (independent MMA chains)
    constexpr int kAcc = C::kSepAcc ? kTerms : 1;
    float sp[kAcc][kNt][4];
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
        sp[i][j][0] = sp[i][j][1] = sp[i][j][2] = sp[i][j][3] = 0.f;
    // fragments by ldmatrix: lane l addresses row (l & 7) + 8 ((l >> 3) & 1)
    // and column 8 (l >> 4) of Q's 16 x 16 block (the A fragment), and key
    // (l & 7) + 8 (l >> 4), column 8 ((l >> 3) & 1) of two 8-key n-tiles of
    // a bf16 K tile (their B fragments)
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
    const int kr8 = (lane & 7) + (lane >> 4) * 8, kc8 = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      const int c0 = kk * 16 + 2 * tig;
      uint32_t a[kTerms][4];
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
        ldsm4(a[i], qs + (i * kRows + rg * 16 + lr) * kQld + kk * 16 + lc);
      if constexpr (kBf16) {
#pragma unroll
        for (int j = 0; j < kNt; j += 2) {
          uint32_t bb[4];       // b0, b1 of n-tile j, then of n-tile j + 1
          ldsm4(bb, kt + (key0 + j * 8 + kr8) * kLd + kk * 16 + kc8);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            mma(sp[C::kSepAcc ? i : 0][j], a[i], bb[0], bb[1]);
            mma(sp[C::kSepAcc ? i : 0][j + 1], a[i], bb[2], bb[3]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const T* kp = kt + (key0 + j * 8 + g) * kLd + c0;
          uint32_t b0, b1, b0l = 0, b1l = 0;
          pair<T>(kp, b0, b0l);
          pair<T>(kp + 8, b1, b1l);
#pragma unroll
          for (int i = 0; i < kTerms; ++i)
            mma(sp[C::kSepAcc ? i : 0][j], a[i], b0, b1);
          if constexpr (kF32) mma(sp[0][j], a[0], b0l, b1l);
        }
      }
    }
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sp[kAcc - 1][j][e];
#pragma unroll
        for (int i = kAcc - 2; i >= 0; --i) x += sp[i][j][e];
        s[j][e] = x;
      }

    // scale (by log2(e) too: the softmax runs on exp2), select by the
    // mask, online softmax
    const uint32_t wa = ta >= 0 ? mbits[(st * kMaxTok + ta) * kWords + word]
                                : 0u;
    const uint32_t wb = tb >= 0 ? mbits[(st * kMaxTok + tb) * kWords + word]
                                : 0u;
    const float* sk = row_scale + (st * 2) * kTile;
    float xa = kNeg, xb = kNeg;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = j * 8 + 2 * tig + e;        // key within the half
        float f = scale * kLog2e;
        if constexpr (kQuant) f *= sk[key0 + kl];
        const bool va = (wa >> (bit0 + kl)) & 1u;
        const bool vbt = (wb >> (bit0 + kl)) & 1u;
        s[j][e] = va ? s[j][e] * f : kNeg;
        s[j][2 + e] = vbt ? s[j][2 + e] * f : kNeg;
        xa = fmaxf(xa, s[j][e]);
        xb = fmaxf(xb, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, o));
      xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, o));
    }
    const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
    const float ca = exp2f(ma - na), cb = exp2f(mb - nb);
    ma = na;
    mb = nb;
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = j * 8 + 2 * tig + e;
        const bool va = (wa >> (bit0 + kl)) & 1u;
        const bool vbt = (wb >> (bit0 + kl)) & 1u;
        s[j][e] = va ? exp2f(s[j][e] - na) : 0.f;
        s[j][2 + e] = vbt ? exp2f(s[j][2 + e] - nb) : 0.f;
        pa += s[j][e];
        pb += s[j][2 + e];
      }
    }
    la = la * ca + pa;
    lb = lb * cb + pb;
#pragma unroll
    for (int n = 0; n < kDnp; ++n) {
      acc[n][0] *= ca;
      acc[n][1] *= ca;
      acc[n][2] *= cb;
      acc[n][3] *= cb;
    }

    // acc += P . V: P as kTerms terms (scale_v folded in first)
    const float* sv = row_scale + (st * 2 + 1) * kTile;
#pragma unroll
    for (int ks = 0; ks < kNt / 2; ++ks) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[h][e] = s[2 * ks + h][e];
          if constexpr (kQuant)
            p[h][e] *= sv[key0 + (2 * ks + h) * 8 + 2 * tig + (e & 1)];
        }
      }
      // A fragment: rows g and g + 8, keys 2tig.. and 8 + 2tig..
      uint32_t f[4][kTerms], a[kTerms][4];
      split(p[0][0], p[0][1], f[0]);
      split(p[0][2], p[0][3], f[1]);
      split(p[1][0], p[1][1], f[2]);
      split(p[1][2], p[1][3], f[3]);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = f[e][i];
      if constexpr (kBf16) {
        // transposed 8 x 8 blocks of V: lane l addresses key (l & 7) +
        // 8 ((l >> 3) & 1), column 8 (l >> 4) of two 8-column n-tiles
        const T* v0 = vt + (key0 + ks * 16 + lr) * kLd + lc;
#pragma unroll
        for (int n = 0; n < kDnp; n += 2) {
          uint32_t bb[4];       // b0, b1 of n-tile n, then of n-tile n + 1
          ldsm4_trans(bb, v0 + n * 8);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            mma(acc[n], a[i], bb[0], bb[1]);
            mma(acc[n + 1], a[i], bb[2], bb[3]);
          }
        }
      } else {
        const T* v0 = vt + (key0 + ks * 16 + 2 * tig) * kLd + g;
#pragma unroll
        for (int n = 0; n < kDnp; ++n) {
          const T* vp = v0 + n * 8;
          uint32_t b0, b1, b0l = 0, b1l = 0;
          column_pair<T>(vp, vp + kLd, b0, b0l);
          column_pair<T>(vp + 8 * kLd, vp + 9 * kLd, b1, b1l);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) mma(acc[n], a[i], b0, b1);
          if constexpr (kF32) mma(acc[n], a[0], b0l, b1l);
        }
      }
    }
  };

  // ---- the consumers' key loop: wait for a stage, compute, release it --
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    mbar_wait(&meta[st], (t >> 1) & 1);
    mbar_wait(&full[st], (t >> 1) & 1);
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) n_live += __popc(livew[st * kWords + w]);
    if (n_live) compute(st);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // ---- merge the two key halves (fixed order) and write -----------------
  // consumers only (barrier 1; the producer has left): the merge reuses the
  // stages' shared memory
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }
  float* mrg = reinterpret_cast<float*>(smem) + rg * 16 * (D + 2);
  float* mrg_m = mrg + 16 * D;
  float* mrg_l = mrg_m + 16;
  if (kq == 1) {
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      const int col = n * 8 + 2 * tig;
      mrg[g * D + col] = acc[n][0];
      mrg[g * D + col + 1] = acc[n][1];
      mrg[(g + 8) * D + col] = acc[n][2];
      mrg[(g + 8) * D + col + 1] = acc[n][3];
    }
    if (tig == 0) {
      mrg_m[g] = ma;
      mrg_m[g + 8] = mb;
      mrg_l[g] = la;
      mrg_l[g + 8] = lb;
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  if (kq == 0) {
    const float m1a = mrg_m[g], m1b = mrg_m[g + 8];
    const float xa = fmaxf(ma, m1a), xb = fmaxf(mb, m1b);
    const float fa0 = exp2f(ma - xa), fa1 = exp2f(m1a - xa);
    const float fb0 = exp2f(mb - xb), fb1 = exp2f(m1b - xb);
    const float da = fmaxf(la * fa0 + mrg_l[g] * fa1, 1e-30f);
    const float db = fmaxf(lb * fb0 + mrg_l[g + 8] * fb1, 1e-30f);
    float* oa = ra < n_q
        ? out + ((static_cast<int64_t>(b) * c_len + ra / group) * heads +
                 kh * group + ra % group) * D
        : nullptr;
    float* ob = rb < n_q
        ? out + ((static_cast<int64_t>(b) * c_len + rb / group) * heads +
                 kh * group + rb % group) * D
        : nullptr;
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      const int col = n * 8 + 2 * tig;
      if (oa)
        *reinterpret_cast<float2*>(oa + col) = make_float2(
            (acc[n][0] * fa0 + mrg[g * D + col] * fa1) / da,
            (acc[n][1] * fa0 + mrg[g * D + col + 1] * fa1) / da);
      if (ob)
        *reinterpret_cast<float2*>(ob + col) = make_float2(
            (acc[n][2] * fb0 + mrg[(g + 8) * D + col] * fb1) / db,
            (acc[n][3] * fb0 + mrg[(g + 8) * D + col + 1] * fb1) / db);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* sk,
           const void* sv, const void* block, const void* valid, void* out,
           int b, int c, int kv, int group, int page, int n_pages,
           float scale, cudaStream_t st) {
  constexpr int smem = Cfg<T, D>::kSmem;
  // set once per instantiation; a failure is returned on every call
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_paged_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (c * group + Cfg<T, D>::kRows - 1) / Cfg<T, D>::kRows;
  chunk_paged_attention_kernel<T, D><<<dim3(kv, b, tiles),
                                       Cfg<T, D>::kThreads, smem,
                                       st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(block),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), c, kv,
      group, page, n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* sk, const void* sv, const void* block,
               const void* valid, void* out, int b, int c, int kv, int group,
               int page, int n_pages, float scale, cudaStream_t st) {
#define CHUNK_CASE(D_)                                                    \
  case D_:                                                                \
    return launch<T, D_>(q, k, v, sk, sv, block, valid, out, b, c, kv,    \
                         group, page, n_pages, scale, st);
  switch (d) {
    CHUNK_CASE(32)
    CHUNK_CASE(64)
    CHUNK_CASE(80)
    CHUNK_CASE(120)
    CHUNK_CASE(128)
    CHUNK_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CHUNK_CASE
}

}  // namespace

// q: (B, C, H, D) float32; pool_k/v: (P, page, K, D) of `dtype` (0 =
// float32, 1 = bfloat16, 2 = int8); scale_k/v: (P, K) float32 for int8
// pools, null otherwise; block: (B, n_pages) int32; valid: (B, C,
// n_pages * page) bytes; out: (B, C, H, D) float32.  All contiguous;
// H = K * group; D in {32, 64, 80, 120, 128, 256}; C > 1.  A bad count, an
// unknown dtype code, or scales that do not match the dtype, is
// cudaErrorInvalidValue and launches nothing.  Returns the error of
// cudaFuncSetAttribute, else cudaGetLastError() after the launch.
extern "C" int chunk_paged_attention_launch(
    const void* q, const void* pool_k, const void* pool_v,
    const void* scale_k, const void* scale_v, const void* block,
    const void* valid, void* out, int dtype, int b, int c, int kv, int group,
    int d, int page, int n_pages, float scale, void* stream) {
  if (b < 1 || c < 2 || kv < 1 || group < 1 || page < 1 || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_scales = scale_k != nullptr && scale_v != nullptr;
  const bool no_scales = scale_k == nullptr && scale_v == nullptr;
  if (!(dtype == 0 || dtype == 1 ? no_scales : dtype == 2 && has_scales))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(d, q, pool_k, pool_v, scale_k, scale_v, block,
                               valid, out, b, c, kv, group, page, n_pages,
                               scale, st);
    case 1:
      return dispatch_d<__nv_bfloat16>(d, q, pool_k, pool_v, scale_k,
                                       scale_v, block, valid, out, b, c, kv,
                                       group, page, n_pages, scale, st);
    case 2:
      return dispatch_d<int8_t>(d, q, pool_k, pool_v, scale_k, scale_v,
                                block, valid, out, b, c, kv, group, page,
                                n_pages, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
