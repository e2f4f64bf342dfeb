// ssd_scan — the Mamba-2 SSD intra-chunk terms, for Hopper (sm_90a).
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
// What bounds it on the H100: float32 operations.  Per (batch row, chunk)
// C.B^T is Q*Q*N/2 multiply-adds (causal) and each head adds Q*Q*P/2
// (y_diag) and Q*P*N (S); at Q = 128, H = 32, P = 64, N = 128 that is about
// 30 operations for every byte of x, dt, B and C read and y, S, g, exp_acs
// written, above the float32 ALU line of the card (67 TFLOP/s over
// 3.35 TB/s = 20 per byte).
//
// What the design does about that:
//   * one block per (group of 4 heads, chunk, batch row): the heads share the
//     block's C.B^T, computed once into shared memory (lower triangle only,
//     an 8x8 register tile per thread over staged 8-column slices of C and
//     B); at mamba2's L admission (4 rows x 4 chunks x 32 heads) that is
//     128 blocks for the 132 SMs;
//   * per head, the decay-weighted W[i,j] = (C_i.B_j) exp(a_cs[i] - a_cs[j])
//     is formed in shared memory for j <= i only and is 0 above: an exp of a
//     positive difference, which may overflow, is never formed, and no
//     overflowed value is ever multiplied by 0;
//   * a_cs is a sequential sum per head, so positions past a row's length,
//     which carry dt = 0, keep a_cs bit for bit: their decay is exactly 1
//     and their input exactly 0, and S and g equal the state at the length;
//   * y_diag = W @ (dt x) and S = (w_end dt x)^T @ B are register-tiled
//     (4x8 outputs a thread) over operands in shared memory; the (Q, Q)
//     tiles have a padded row stride so a warp's column reads hit distinct
//     banks.
// A simple kernel first: wgmma/TF32 tensor cores and TMA are left for a
// later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 4;      // heads per block; they share C.B^T
constexpr int kKt = 8;         // state columns per staged slice of C and B

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ g,
                 float* __restrict__ eacs, int nc, int q, int h, int p,
                 int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = q + 1;                      // padded stride of (Q, Q) tiles
  const int buf_len = q * ld > q * n ? q * ld : q * n;
  float* cb = smem;                          // (Q, ld): C_i . B_j
  float* buf = cb + q * ld;                  // C/B slices, W (Q, ld), B (Q, N)
  float* xs = buf + buf_len;                 // (Q, P): dt_j x_j of one head
  float* dts = xs + q * p;                   // (Q,) dt of one head
  float* acs = dts + q;                      // (Q,) a_cs
  float* wend = acs + q;                     // (Q,) exp(a_cs[Q-1] - a_cs[j])

  const int hb0 = blockIdx.x * kHeads, c = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t bc = static_cast<int64_t>(bi) * nc + c;   // (row, chunk)
  const float* Cb = C + bc * q * n;
  const float* Bb = B + bc * q * n;

  // ---- C . B^T, lower triangle: thread t owns 8x8 tile (ti, tj), tj <= ti
  {
    const int tq = q / 8;
    const bool lower = tid < tq * tq && tid % tq <= tid / tq;
    const int ti = tid / tq, tj = tid % tq;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.f;
    float* ct = buf;                         // (kKt, Q): C[:, n0:n0+8]^T
    float* bt = buf + kKt * q;               // (kKt, Q): B[:, n0:n0+8]^T
    for (int n0 = 0; n0 < n; n0 += kKt) {
      for (int e = tid; e < q * kKt; e += kThreads) {
        const int i = e / kKt, k = e % kKt;
        ct[k * q + i] = Cb[i * n + n0 + k];
        bt[k * q + i] = Bb[i * n + n0 + k];
      }
      __syncthreads();
      if (lower) {
#pragma unroll
        for (int k = 0; k < kKt; ++k) {
          float av[8], bv[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            av[r] = ct[k * q + ti * 8 + r];
            bv[r] = bt[k * q + tj * 8 + r];
          }
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
              acc[r][cc] = fmaf(av[r], bv[cc], acc[r][cc]);
        }
      }
      __syncthreads();
    }
    if (lower) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          cb[(ti * 8 + r) * ld + tj * 8 + cc] = acc[r][cc];
    }
    __syncthreads();
  }

  for (int hh = 0; hh < kHeads; ++hh) {
    const int hd = hb0 + hh;
    if (hd >= h) break;                      // uniform over the block
    const float a_h = A[hd];
    for (int j = tid; j < q; j += kThreads)
      dts[j] = dt[(bc * q + j) * h + hd];
    __syncthreads();
    if (tid == 0) {
      // sequential, as the reference's cumsum: adding dt = 0 keeps the sum
      float s = 0.f;
      for (int j = 0; j < q; ++j) {
        s += dts[j] * a_h;
        acs[j] = s;
      }
    }
    for (int e = tid; e < q * p; e += kThreads) {
      const int j = e / p, pp = e % p;
      xs[e] = x[((bc * q + j) * h + hd) * p + pp] * dts[j];
    }
    __syncthreads();

    const float acs_end = acs[q - 1];
    for (int j = tid; j < q; j += kThreads) {
      eacs[(bc * q + j) * h + hd] = expf(acs[j]);
      wend[j] = expf(acs_end - acs[j]);
    }
    if (tid == 0) g[bc * h + hd] = expf(acs_end);
    // W = C.B^T decayed, j <= i only; 0 above the diagonal
    for (int e = tid; e < q * q; e += kThreads) {
      const int i = e / q, j = e % q;
      buf[i * ld + j] = j <= i ? cb[i * ld + j] * expf(acs[i] - acs[j]) : 0.f;
    }
    __syncthreads();

    // ---- y_diag = W @ xs: thread tile rows i0..i0+3, columns p0..p0+7
    const int tp = p / 8;
    for (int t = tid; t < (q / 4) * tp; t += kThreads) {
      const int i0 = (t / tp) * 4, p0 = (t % tp) * 8;
      float o[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) o[r][cc] = 0.f;
      for (int j = 0; j < i0 + 4; ++j) {     // W is 0 past the diagonal
        float wv[4], xv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = buf[(i0 + r) * ld + j];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) xv[cc] = xs[j * p + p0 + cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            o[r][cc] = fmaf(wv[r], xv[cc], o[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          y[((bc * q + i0 + r) * h + hd) * p + p0 + cc] = o[r][cc];
    }
    __syncthreads();                         // buf now takes B

    // ---- S = (wend * xs)^T @ B: thread tile p0..p0+3 x n0..n0+7
    for (int e = tid; e < q * n; e += kThreads) buf[e] = Bb[e];
    __syncthreads();
    const int tn = n / 8;
    for (int t = tid; t < (p / 4) * tn; t += kThreads) {
      const int p0 = (t / tn) * 4, n0 = (t % tn) * 8;
      float o[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) o[r][cc] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float wj = wend[j];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = wj * xs[j * p + p0 + r];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) bv[cc] = buf[j * n + n0 + cc];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            o[r][cc] = fmaf(xv[r], bv[cc], o[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          S[((bc * h + hd) * p + p0 + r) * n + n0 + cc] = o[r][cc];
    }
    __syncthreads();                         // buf and xs are rewritten
  }
}

}  // namespace

// x: (b, nc, Q, H, P); dt: (b, nc, Q, H); A: (H,); B, C: (b, nc, Q, N);
// y: (b, nc, Q, H, P); S: (b, nc, H, P, N); g: (b, nc, H); eacs: (b, nc, Q,
// H).  All float32 and contiguous; Q, P multiples of 8 up to 128, N a
// multiple of 8 up to 128.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                                const void* B, const void* C, void* y,
                                void* S, void* g, void* eacs, int b, int nc,
                                int q, int h, int p, int n, void* stream) {
  if (b < 1 || nc < 1 || h < 1 || q < 8 || q > 128 || q % 8 || p < 8 ||
      p > 128 || p % 8 || n < 8 || n > 128 || n % 8 || nc > 65535 ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = q + 1;
  const int buf_len = q * ld > q * n ? q * ld : q * n;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(q) * ld + buf_len + q * p + 3 * q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((h + kHeads - 1) / kHeads, nc, b);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(S), static_cast<float*>(g),
      static_cast<float*>(eacs), nc, q, h, p, n);
  return static_cast<int>(cudaGetLastError());
}
