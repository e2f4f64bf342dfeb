// ssd_scan — the Mamba-2 SSD intra-chunk terms on Hopper's tensor cores
// (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_chunk_pallas (body _kernel).
// Per (batch row, chunk of Q positions), with a = dt * A and a_cs its
// cumulative sum over the chunk, for every head h:
//   y_diag[i,h,p] = sum_{j<=i} (C_i . B_j) exp(a_cs[i,h] - a_cs[j,h]) dt[j,h] x[j,h,p]
//   S[h,p,n]      = sum_j exp(a_cs[Q-1,h] - a_cs[j,h]) dt[j,h] x[j,h,p] B[j,n]
//   g[h]          = exp(a_cs[Q-1,h]);   exp_acs[i,h] = exp(a_cs[i,h])
// The inter-chunk recurrence over S and g stays in torch (ops.ssd), as the
// reference leaves it outside Pallas.
//
// What bounds it on the H100: HBM bytes, once the three products run on the
// tensor cores.  Per (batch row, chunk) C.B^T is Q*Q*N/2 multiply-adds
// (causal) and each head adds Q*Q*P/2 (y_diag) and Q*P*N (S); in float32
// FMA that is about 30 operations per byte moved, above the card's float32
// line (67 TFLOP/s over 3.35 TB/s = 20).  On the tensor cores, three TF32
// passes per product, the operations take about two thirds of the time the
// bytes (x, dt, B, C read; y, S, g, exp_acs written) take.
//
// What the design does about that:
//   * the three products run as mma.sync.m16n8k8 with TF32 operands and
//     float32 accumulators.  One TF32 pass (10 mantissa bits) misses the
//     1e-4 + 1e-4 |ref| tolerance; each float32 operand is split into hi
//     (its low 13 mantissa bits cleared) and lo = x - hi, and lo.hi + hi.lo
//     + hi.hi go into the same accumulator: within float32 rounding of a
//     float64 reference (tests/test_torch_kernel_design.py emulates it on
//     the CPU).  The split is a mask and a subtraction: cvt.rna.tf32.f32
//     costs several instructions, and made the kernel markedly slower;
//   * one 16-warp block per (group of heads, chunk, batch row), one block
//     to an SM: the host picks the heads per block from the shapes so that
//     the grid is about one wave (4 heads at mamba2's L admission, 128
//     blocks).  The block stages C and B once (cp.async), keeps B resident
//     for every head's S, and computes the heads' shared C.B^T once, kept in
//     shared memory in the accumulator's own fragment order: one 16-byte
//     read per lane and 16 x 8 tile;
//   * the heads' dt is loaded ahead of the C and B copies and their a_cs,
//     exp_acs, g and w_end * dt computed while those land; each head's x
//     is copied into one of two buffers while the head before computes;
//   * per head, W[i,j] = (C_i.B_j) exp(a_cs[i] - a_cs[j]) is formed in
//     registers from the C.B^T fragments, using each lane's (row, column) of
//     the accumulator layout, for j <= i only and 0 above by a select: the
//     exp of a positive difference is never formed and no overflowed value
//     is multiplied by 0.  The accumulator's two columns per lane are the
//     A operand's two k slots (the k order of both operands permuted to
//     match), so W needs no shuffle;
//   * y_diag = W (dt x) runs over j <= i only, its (row tile, 32 columns)
//     items dealt to the warps longest first and back; S = (w_end dt x)^T B
//     gives each warp 16 rows of P and 4 column tiles of N.  Each warp runs
//     the three passes of a product over 4 or 5 tiles with their own
//     accumulators in turn, so that an MMA's result is not needed by the
//     next one;
//   * a_cs is a sequential sum per head, so positions past a row's length,
//     which carry dt = 0, keep a_cs bit for bit: their decay is exactly 1
//     and their input exactly 0, and S and g equal the state at the length;
//   * staged rows are padded so that every fragment read of a warp hits 32
//     distinct banks; about 176 KB of shared memory at mamba2's shapes.  The
//     shared-memory limit is raised once, on the first launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128, kMaxP = 128, kMaxN = 128;
constexpr int kMaxHeads = 8;       // heads per block
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kMaxSub = (kMaxQ / 16) * (kMaxQ / 16 + 1);  // 16 x 8 tiles
constexpr int kSubPerWarp = (kMaxSub + kWarps - 1) / kWarps;
constexpr int kYTiles = 4;         // y_diag: 8-column tiles per warp item
constexpr int kMaxSTiles = 8;      // S: 8-column tiles per warp item
constexpr int kSGroup = 4;         // S tiles whose MMA chains interleave
static_assert(kMaxSTiles % kSGroup == 0, "whole groups");
static_assert(kMaxQ <= kThreads, "a thread per position");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared; src_size 0 reads nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_size) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_size) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x as hi = x with its low 13 mantissa bits cleared (a TF32 value) and
// lo = x - hi (exact in float32; the MMA reads its top 19 bits): x to
// within 2^-21 of itself.  Two instructions, where cvt.rna.tf32.f32 costs
// several
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D (16x8 f32) += A (16x8 tf32, row) . B (8x8 tf32, col).  Not volatile:
// the compiler may interleave independent accumulators' MMAs.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B-operand fragment of float32 values as TF32 hi and lo pairs
struct BFrag {
  uint32_t h0, h1, l0, l1;
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, h0, l0);
    split(b1, h1, l1);
  }
};

// c[t] += a . b[t] for T tiles sharing the A operand, in three TF32
// passes, small terms first; each pass runs over all T tiles, so that
// dependent MMAs on one accumulator are T apart
template <int T>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const BFrag (&b)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) mma(c[t], al, b[t].h0, b[t].h1);
#pragma unroll
  for (int t = 0; t < T; ++t) mma(c[t], ah, b[t].l0, b[t].l1);
#pragma unroll
  for (int t = 0; t < T; ++t) mma(c[t], ah, b[t].h0, b[t].h1);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

// 16 x 8 tile f of C.B^T covers rows 16 r .. 16 r + 15 and columns
// 8 jt .. 8 jt + 7, with f = r (r + 1) + jt and jt <= 2 r + 1
__device__ __forceinline__ void sub_tile(int f, int& r, int& jt) {
  r = 0;
  while ((r + 1) * (r + 2) <= f) ++r;
  jt = f - r * (r + 1);
}

struct Dims {
  int nc, q, h, p, n, heads_per_block;
};

// shared-memory layout in floats (all offsets multiples of 4)
struct Smem {
  int qp, pp, rt, ldx, ldb, nbuf;
  int cbf, bres, region, vec;
  int total;
  __host__ __device__ explicit Smem(const Dims& d) {
    qp = (d.q + 15) / 16 * 16;
    pp = (d.p + 15) / 16 * 16;
    rt = qp / 16;
    ldx = pp + 4;                 // = 4 mod 16: conflict-free (2 tig, g) reads
    ldb = d.n + 4;                // = 4 mod 8: conflict-free (g, tig) and
                                  // (2 tig, g) reads
    cbf = 0;                      // C.B^T fragments, 128 floats per tile
    bres = rt * (rt + 1) * 128;   // B, resident: (qp, ldb)
    region = bres + qp * ldb;     // C (qp, ldb) for C.B^T, then x (qp, ldx)
                                  // in nbuf buffers
    const int vecs = 3 * d.heads_per_block * qp;  // dt, a_cs, w_end * dt
    nbuf = 2;
    const int x2 = 2 * qp * ldx;
    vec = region + (x2 > qp * ldb ? x2 : qp * ldb);
    if (4 * (vec + vecs) > kSmemLimit) {
      nbuf = 1;                   // no room to copy the next head's x early
      vec = region + (qp * ldx > qp * ldb ? qp * ldx : qp * ldb);
    }
    total = vec + vecs;
  }
};

// One block per (group of heads, chunk, batch row).  Phases: C, B and the
// heads' dt in flight; the heads' a_cs (sequential), exp_acs, g and
// w_end * dt; C.B^T into fragment order; then per head y_diag and S, the
// next head's x copied meanwhile.
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ g_out,
                 float* __restrict__ eacs, Dims dims) {
  extern __shared__ __align__(16) float smem[];
  const Smem L(dims);
  const int q = dims.q, h = dims.h, p = dims.p, n = dims.n;
  const int qp = L.qp, rt = L.rt, ldx = L.ldx, ldb = L.ldb;
  float4* cbf = reinterpret_cast<float4*>(smem + L.cbf);
  float* bres = smem + L.bres;
  float* cst = smem + L.region;
  const int hb0 = blockIdx.x * dims.heads_per_block;
  const int nh = h - hb0 < dims.heads_per_block ? h - hb0
                                                 : dims.heads_per_block;
  float* dts = smem + L.vec;                 // [head][qp]
  float* acs = dts + dims.heads_per_block * qp;
  float* wdt = acs + dims.heads_per_block * qp;

  const int c = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int64_t bc = static_cast<int64_t>(bi) * dims.nc + c;  // (row, chunk)
  const float* Cb = C + bc * q * n;
  const float* Bb = B + bc * q * n;

  // ---- the heads' dt first (issued ahead of the copies, it is not queued
  // behind them), then C and B in flight (rows past q zero-filled), one
  // group
  constexpr int kDtPer = kMaxHeads * kMaxQ / kThreads;
  float dtv[kDtPer];
#pragma unroll
  for (int u = 0; u < kDtPer; ++u) {
    const int i = tid + u * kThreads, hh = i / qp, j = i % qp;
    dtv[u] = i < nh * qp && j < q ? dt[(bc * q + j) * h + hb0 + hh] : 0.f;
  }
  for (int i = tid; i < qp * (n / 4); i += kThreads) {
    const int row = i / (n / 4), col = i % (n / 4) * 4;
    const bool live = row < q;
    const int64_t off = live ? row * n + col : 0;
    cp_async16(cst + row * ldb + col, Cb + off, live ? 16 : 0);
    cp_async16(bres + row * ldb + col, Bb + off, live ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < kDtPer; ++u) {
    const int i = tid + u * kThreads;
    if (i < nh * qp) dts[i] = dtv[u];
  }
  __syncthreads();
  if (lane == 0 && warp < nh) {
    // one head a warp, sequential as the reference's cumsum: adding
    // dt = 0 keeps the sum
    const int hh = warp;
    const float a_h = A[hb0 + hh];
    const float* d = dts + hh * qp;
    float* a = acs + hh * qp;
    float s = 0.f;
    for (int j0 = 0; j0 < qp; j0 += 16) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = d[j0 + e];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        s = __fadd_rn(s, __fmul_rn(v[e], a_h));
        a[j0 + e] = s;
      }
    }
    g_out[bc * h + hb0 + hh] = expf(a[q - 1]);
  }
  __syncthreads();
  for (int i = tid; i < nh * qp; i += kThreads) {
    const int hh = i / qp, j = i % qp;
    const float* a = acs + hh * qp;
    if (j < q) eacs[(bc * q + j) * h + hb0 + hh] = expf(a[j]);
    wdt[i] = j < q ? expf(a[q - 1] - a[j]) * dts[i] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();                           // C, B and the vectors

  // ---- C . B^T, lower-triangle 16 x 8 tiles f = warp + kWarps i; past
  // n_sub a warp recomputes the last tile and does not store it
  // (straight-line MMA code)
  {
    const int n_sub = rt * (rt + 1);
    int tr[kSubPerWarp], tj[kSubPerWarp];
#pragma unroll
    for (int i = 0; i < kSubPerWarp; ++i) {
      const int f = warp + i * kWarps;
      sub_tile(f < n_sub ? f : n_sub - 1, tr[i], tj[i]);
    }
    float acc[kSubPerWarp][4];
#pragma unroll
    for (int i = 0; i < kSubPerWarp; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int k0 = 0; k0 < n; k0 += 8) {
      uint32_t ah[kSubPerWarp][4], al[kSubPerWarp][4];
      BFrag bf[kSubPerWarp];
#pragma unroll
      for (int i = 0; i < kSubPerWarp; ++i) {
        const float* cr = cst + (16 * tr[i] + g) * ldb + k0 + tig;
        const float* br = bres + (8 * tj[i] + g) * ldb + k0 + tig;
        const float av[4] = {cr[0], cr[8 * ldb], cr[4], cr[8 * ldb + 4]};
        split4(av, ah[i], al[i]);
        bf[i].set(br[0], br[4]);
      }
#pragma unroll
      for (int i = 0; i < kSubPerWarp; ++i)
        mma(acc[i], al[i], bf[i].h0, bf[i].h1);
#pragma unroll
      for (int i = 0; i < kSubPerWarp; ++i)
        mma(acc[i], ah[i], bf[i].l0, bf[i].l1);
#pragma unroll
      for (int i = 0; i < kSubPerWarp; ++i)
        mma(acc[i], ah[i], bf[i].h0, bf[i].h1);
    }
#pragma unroll
    for (int i = 0; i < kSubPerWarp; ++i) {
      const int f = warp + i * kWarps;
      if (f < n_sub)
        cbf[f * 32 + lane] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }

  const int pieces = L.pp / 4;
  // copies of head hh's x into buffer buf (rows past q and columns past p
  // zero-filled), one group
  auto stage_x = [&](int hh, int buf) {
    float* xb = cst + buf * qp * ldx;
    for (int i = tid; i < qp * pieces; i += kThreads) {
      const int j = i / pieces, pc = i % pieces;
      const bool live = j < q && pc * 4 < p;
      const int64_t off =
          live ? ((bc * q + j) * h + hb0 + hh) * p + pc * 4 : 0;
      cp_async16(xb + j * ldx + pc * 4, x + off, live ? 16 : 0);
    }
    cp_async_commit();
  };
  __syncthreads();                           // C read: its room takes x
  stage_x(0, 0);

  const int ng = (p + 8 * kYTiles - 1) / (8 * kYTiles);
  const int n_items_y = rt * ng;
  const int pt = L.pp / 16;                  // S: 16-row tiles of P
  const int nt_all = n / 8;
  const int n_seg = pt >= kWarps ? 1 : kWarps / pt;
  const int seg_len = (nt_all + n_seg - 1) / n_seg;

  for (int hh = 0; hh < nh; ++hh) {
    const int hd = hb0 + hh;
    cp_async_wait_all();
    __syncthreads();                         // x of hh; hh - 1's buffer read
    const float* xs = cst + (L.nbuf == 2 ? hh & 1 : 0) * qp * ldx;
    if (L.nbuf == 2 && hh + 1 < nh) stage_x(hh + 1, (hh + 1) & 1);
    const float* dth = dts + hh * qp;
    const float* ach = acs + hh * qp;
    const float* wdh = wdt + hh * qp;

    // ---- y_diag = W (dt x): items (row tile, 16 columns), dealt longest
    // first in a snake so that the warps' triangles balance.  Column tiles
    // past p recompute the last one and are not stored.
    for (int round = 0; round * kWarps < n_items_y; ++round) {
      const int k = round * kWarps + (round & 1 ? kWarps - 1 - warp : warp);
      if (k >= n_items_y) continue;
      const int r = rt - 1 - k / ng, pg = k % ng;
      const int ri0 = 16 * r + g, ri1 = ri0 + 8;
      const float ai0 = ach[ri0], ai1 = ach[ri1];
      float acc[kYTiles][4];
#pragma unroll
      for (int t = 0; t < kYTiles; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int js = 0; js <= 2 * r + 1; ++js) {
        const int cj0 = 8 * js + 2 * tig, cj1 = cj0 + 1;
        const float4 cb = cbf[(r * (r + 1) + js) * 32 + lane];
        const float aj0 = ach[cj0], aj1 = ach[cj1];
        // W at (ri0, cj0), (ri1, cj0), (ri0, cj1), (ri1, cj1): the
        // permuted A operand (k slot tig is column cj0, tig + 4 is cj1)
        const bool k00 = cj0 <= ri0, k10 = cj0 <= ri1;
        const bool k01 = cj1 <= ri0, k11 = cj1 <= ri1;
        const float w[4] = {
            k00 ? cb.x * __expf(k00 ? ai0 - aj0 : 0.f) : 0.f,
            k10 ? cb.z * __expf(k10 ? ai1 - aj0 : 0.f) : 0.f,
            k01 ? cb.y * __expf(k01 ? ai0 - aj1 : 0.f) : 0.f,
            k11 ? cb.w * __expf(k11 ? ai1 - aj1 : 0.f) : 0.f};
        uint32_t ah[4], al[4];
        split4(w, ah, al);
        const float d0 = dth[cj0], d1 = dth[cj1];
        const float* x0 = xs + cj0 * ldx + g;
        BFrag bf[kYTiles];
#pragma unroll
        for (int t = 0; t < kYTiles; ++t) {
          const int ctl = pg * kYTiles + t < p / 8 ? pg * kYTiles + t
                                                   : p / 8 - 1;
          bf[t].set(d0 * x0[8 * ctl], d1 * x0[ldx + 8 * ctl]);
        }
        mma3<kYTiles>(acc, ah, al, bf);
      }
#pragma unroll
      for (int t = 0; t < kYTiles; ++t) {
        const int col = (pg * kYTiles + t) * 8 + 2 * tig;
        if (col < p) {
          if (ri0 < q)
            *reinterpret_cast<float2*>(y + ((bc * q + ri0) * h + hd) * p +
                                       col) = make_float2(acc[t][0],
                                                          acc[t][1]);
          if (ri1 < q)
            *reinterpret_cast<float2*>(y + ((bc * q + ri1) * h + hd) * p +
                                       col) = make_float2(acc[t][2],
                                                          acc[t][3]);
        }
      }
    }

    // ---- S = (w_end dt x)^T B over B resident: item (16 rows of P, a run
    // of 8-column tiles of N) per warp.  Tiles past N recompute the last
    // one and are not stored.
    const int mt = warp / n_seg, seg = warp % n_seg;
    if (mt < pt) {
      const int pr0 = 16 * mt + g, pr1 = pr0 + 8;
      const int nt0 = seg * seg_len;
      float sacc[kMaxSTiles][4];
#pragma unroll
      for (int t = 0; t < kMaxSTiles; ++t)
        sacc[t][0] = sacc[t][1] = sacc[t][2] = sacc[t][3] = 0.f;
      for (int kb = 0; kb < qp; kb += 8) {
        const int j0 = kb + 2 * tig, j1 = j0 + 1;
        const float w0 = wdh[j0], w1 = wdh[j1];
        // A = X'^T, permuted k: rows pr0 / pr1, k slots tig (j0) and
        // tig + 4 (j1)
        const float* xa = xs + j0 * ldx;
        const float av[4] = {w0 * xa[pr0], w0 * xa[pr1], w1 * xa[ldx + pr0],
                             w1 * xa[ldx + pr1]};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* b0p = bres + j0 * ldb + g;
#pragma unroll
        for (int t0 = 0; t0 < kMaxSTiles; t0 += kSGroup) {
          if (t0 < seg_len) {                // uniform over the warp
            BFrag bf[kSGroup];
#pragma unroll
            for (int u = 0; u < kSGroup; ++u) {
              const int nt = nt0 + t0 + u < nt_all ? nt0 + t0 + u
                                                   : nt_all - 1;
              bf[u].set(b0p[nt * 8], b0p[ldb + nt * 8]);
            }
            mma3<kSGroup>(&sacc[t0], ah, al, bf);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxSTiles; ++t) {
        const int nt = nt0 + t;
        if (t < seg_len && nt < nt_all) {
          const int col = nt * 8 + 2 * tig;
          float* sb = S + (bc * h + hd) * p * n + col;
          if (pr0 < p)
            *reinterpret_cast<float2*>(sb + pr0 * n) =
                make_float2(sacc[t][0], sacc[t][1]);
          if (pr1 < p)
            *reinterpret_cast<float2*>(sb + pr1 * n) =
                make_float2(sacc[t][2], sacc[t][3]);
        }
      }
    }
    if (L.nbuf == 1 && hh + 1 < nh) {
      __syncthreads();                       // the one buffer read
      stage_x(hh + 1, 0);
    }
  }
}

}  // namespace

// x: (b, nc, Q, H, P); dt: (b, nc, Q, H); A: (H,); B, C: (b, nc, Q, N);
// y: (b, nc, Q, H, P); S: (b, nc, H, P, N); g: (b, nc, H); eacs: (b, nc, Q,
// H).  All float32 and contiguous; Q, P and N multiples of 8 up to 128;
// 1 to 8 heads per block.  Returns the error of raising the
// kernel's shared-memory limit (done once), else cudaGetLastError() after
// the launch.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* B, const void* C, void* y,
                                void* S, void* g, void* eacs, int b, int nc,
                                int q, int h, int p, int n,
                                int heads_per_block, void* stream) {
  if (b < 1 || nc < 1 || h < 1 || q < 8 || q > kMaxQ || q % 8 || p < 8 ||
      p > kMaxP || p % 8 || n < 8 || n > kMaxN || n % 8 || nc > 65535 ||
      b > 65535 || heads_per_block < 1 || heads_per_block > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Dims dims{nc, q, h, p, n, heads_per_block};
  const size_t smem = sizeof(float) * Smem(dims).total;
  dim3 grid((h + heads_per_block - 1) / heads_per_block, nc, b);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(S), static_cast<float*>(g),
      static_cast<float*>(eacs), dims);
  return static_cast<int>(cudaGetLastError());
}
