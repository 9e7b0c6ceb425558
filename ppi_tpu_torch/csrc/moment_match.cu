// Weighted Gaussian moment match: the sums of one pass over N samples.
//
// Replaces the Pallas kernel ppi_tpu/ops/pallas_ops.py::m_projection_pallas
// (body _mm_kernel, pallas_call at line 78). Given log-weights log_w (N,),
// samples x (N, d) row-major, and two device scalars computed by the wrapper
// outside the kernel, as in JAX -- shift = max(log_w) and centre = mean(x) --
// it accumulates
//     w_i = exp(log_w_i - shift)           (-inf gives exactly 0)
//     S1  = sum_i w_i (x_i - c)            S2 = sum_i w_i (x_i - c)(x_i - c)^T
//     W   = sum_i w_i                      W2 = sum_i w_i^2
// The epilogue (mu, sigma, ess) stays in torch (ppi_tpu_torch/ops/cuda_ops.py).
//
// Design. The Pallas grid walks N in order and sums into one output block;
// CUDA blocks run in parallel, so the sums are split over blocks and reduced
// in a second pass, with no atomics:
//   pass 1, grid (P, S): P = T(T+1)/2 upper-triangle 64x64 tiles of S2
//     (T = ceil(d/64)), S splits of N into ranges of `rows` rows (a multiple
//     of 32). A block of 256 threads walks its rows in chunks of 32: it stages
//     w (x - c) for the tile's row strip and (x - c) for its column strip in
//     shared memory, then each thread accumulates a 4x4 micro-tile in
//     registers with f32 FMA. It writes its partial tile to scratch (S, d, d);
//     the diagonal tiles also write S1 of their strip, and tile (0, 0) W and
//     W2, to scratch (S, d + 2).
//   pass 2: one thread per output value sums the S partials in the order
//     s = 0..S-1 and mirrors the upper triangle of tiles into the lower one.
// Ragged N and d are masked in the kernel (a row >= n or a column >= d loads
// 0), not padded by copies. Two launches on one input give bit-identical
// output. S comes from the shape only (ppi_tpu_torch/ops/cuda_ops.py::plan),
// never from a timing.
//
// What bounds it on an H100: 2 N d^2 flops (about half of it with the upper
// triangle) over 4 (N d + N) bytes read. At N=4096, d=640 that is ~1.9 GFLOP
// over ~10.5 MB: compute-bound, and this SIMT kernel runs on the CUDA cores
// (67 TFLOP/s f32 peak), not the tensor cores. The redesign, a later PR's
// work, is tensor cores with a split-precision scheme that keeps f32
// accuracy. At N=4096, d=64 it is 34 MFLOP over 1 MB: bound by bandwidth and
// latency, where the number of partials matters more than the flops.
//
// Precision: f32 throughout, fmaf and expf only (no TF32, no fast math).
//
// The file also compiles as host C (no __CUDACC__): ppi_mm_host then runs the
// same blocks, chunk loads, accumulation order and pass-2 sums one after the
// other on the CPU, which the CPU tests hold against the plain version.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __host__ __device__ __forceinline__
#else
#include <math.h>
#include <stddef.h>
#include <string.h>
#define PPI_QUAL static inline
#endif

#define MM_TILE 64     // S2 output tile edge
#define MM_CHUNK 32    // rows staged in shared memory at a time
#define MM_THREADS 256 // threads of a pass-1 block: 16 x 16, 4 x 4 values each
#define MM_MICRO 4

// Tile pair p (0 <= p < T(T+1)/2) -> (ti, tj) with ti <= tj, row by row.
PPI_QUAL void mm_tile_pair(int p, int T, int* ti, int* tj) {
  int i = 0;
  while (p >= T - i) {
    p -= T - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

PPI_QUAL float mm_weight(const float* log_w, float shift, int n, int row) {
  return row < n ? expf(log_w[row] - shift) : 0.0f;
}

PPI_QUAL float mm_centred(const float* x, const float* centre, int n, int d,
                          int row, int col) {
  return (row < n && col < d) ? x[(size_t)row * d + col] - centre[col] : 0.0f;
}

// Element e of S2 (row-major d x d): the sum of its S partials, read from the
// upper-triangle tile that holds it.
PPI_QUAL float mm_sum_s2(const float* s2p, int d, int splits, long e) {
  int a = (int)(e / d), b = (int)(e % d);
  if (a / MM_TILE > b / MM_TILE) {
    const int tmp = a;
    a = b;
    b = tmp;
  }
  const size_t dd = (size_t)d * d;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += s2p[s * dd + (size_t)a * d + b];
  return v;
}

// Element e of [S1 (d), W, W2]: the sum of its S partials.
PPI_QUAL float mm_sum_s1(const float* s1p, int d, int splits, int e) {
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += s1p[(size_t)s * (d + 2) + e];
  return v;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(MM_THREADS)
mm_pass1(const float* __restrict__ log_w, const float* __restrict__ x,
         const float* __restrict__ centre, const float* __restrict__ shift_p,
         float* __restrict__ s2p, float* __restrict__ s1p, int n, int d, int T,
         int rows) {
  __shared__ float ws[MM_CHUNK];
  __shared__ __align__(16) float xa[MM_CHUNK][MM_TILE];  // w (x - c), rows
  __shared__ __align__(16) float xb[MM_CHUNK][MM_TILE];  // x - c, columns
  int ti, tj;
  mm_tile_pair(blockIdx.x, T, &ti, &tj);
  const int s = blockIdx.y;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int a0 = ti * MM_TILE, b0 = tj * MM_TILE;
  const bool diag = ti == tj, first = blockIdx.x == 0;
  const float shift = *shift_p;
  const int begin = s * rows;
  const int end = begin + rows < n ? begin + rows : n;

  float acc[MM_MICRO][MM_MICRO];
#pragma unroll
  for (int i = 0; i < MM_MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MM_MICRO; ++j) acc[i][j] = 0.0f;
  float s1 = 0.0f, wsum = 0.0f, w2sum = 0.0f;

  for (int r0 = begin; r0 < end; r0 += MM_CHUNK) {
    if (t < MM_CHUNK) ws[t] = mm_weight(log_w, shift, n, r0 + t);
    __syncthreads();
    for (int e = t; e < MM_CHUNK * MM_TILE; e += MM_THREADS) {
      const int k = e / MM_TILE, c = e % MM_TILE;
      xa[k][c] = ws[k] * mm_centred(x, centre, n, d, r0 + k, a0 + c);
      xb[k][c] = mm_centred(x, centre, n, d, r0 + k, b0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < MM_CHUNK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&xa[k][ty * MM_MICRO]);
      const float4 bv = *reinterpret_cast<const float4*>(&xb[k][tx * MM_MICRO]);
      const float a[MM_MICRO] = {av.x, av.y, av.z, av.w};
      const float b[MM_MICRO] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < MM_MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MM_MICRO; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (diag && t < MM_TILE)
      for (int k = 0; k < MM_CHUNK; ++k) s1 += xa[k][t];
    if (first && t == MM_TILE)
      for (int k = 0; k < MM_CHUNK; ++k) {
        wsum += ws[k];
        w2sum = fmaf(ws[k], ws[k], w2sum);
      }
    __syncthreads();
  }

  float* out = s2p + (size_t)s * d * d;
#pragma unroll
  for (int i = 0; i < MM_MICRO; ++i) {
    const int a = a0 + ty * MM_MICRO + i;
#pragma unroll
    for (int j = 0; j < MM_MICRO; ++j) {
      const int b = b0 + tx * MM_MICRO + j;
      if (a < d && b < d) out[(size_t)a * d + b] = acc[i][j];
    }
  }
  float* out1 = s1p + (size_t)s * (d + 2);
  if (diag && t < MM_TILE && a0 + t < d) out1[a0 + t] = s1;
  if (first && t == MM_TILE) {
    out1[d] = wsum;
    out1[d + 1] = w2sum;
  }
}

__global__ void mm_pass2(const float* __restrict__ s2p,
                         const float* __restrict__ s1p, float* __restrict__ s2,
                         float* __restrict__ s1w, int d, int splits) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long dd = (long)d * d;
  if (e < dd)
    s2[e] = mm_sum_s2(s2p, d, splits, e);
  else if (e < dd + d + 2)
    s1w[e - dd] = mm_sum_s1(s1p, d, splits, (int)(e - dd));
}

// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success). s2p (splits, d, d) and s1p (splits, d + 2) are scratch; the
// results are s2 (d, d) and s1w = [S1 (d), W, W2].
extern "C" int ppi_mm_launch(const float* log_w, const float* x,
                             const float* centre, const float* shift,
                             float* s2p, float* s1p, float* s2, float* s1w,
                             int n, int d, int rows, int splits,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int T = (d + MM_TILE - 1) / MM_TILE;
  const dim3 grid1(T * (T + 1) / 2, splits);
  mm_pass1<<<grid1, MM_THREADS, 0, st>>>(log_w, x, centre, shift, s2p, s1p, n,
                                         d, T, rows);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long total = (long)d * d + d + 2;
  mm_pass2<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(s2p, s1p, s2, s1w,
                                                             d, splits);
  return (int)cudaGetLastError();
}

#else

// One pass-1 block (tile pair p, split s), its threads one after the other.
static void mm_block_host(int p, int s, const float* log_w, const float* x,
                          const float* centre, float shift, float* s2p,
                          float* s1p, int n, int d, int T, int rows) {
  static float acc[MM_TILE][MM_TILE], xa[MM_CHUNK][MM_TILE],
      xb[MM_CHUNK][MM_TILE];
  float ws[MM_CHUNK], s1[MM_TILE];
  int ti, tj;
  mm_tile_pair(p, T, &ti, &tj);
  const int a0 = ti * MM_TILE, b0 = tj * MM_TILE;
  const int diag = ti == tj, first = p == 0;
  const int begin = s * rows;
  const int end = begin + rows < n ? begin + rows : n;
  float wsum = 0.0f, w2sum = 0.0f;
  memset(acc, 0, sizeof(acc));
  memset(s1, 0, sizeof(s1));
  for (int r0 = begin; r0 < end; r0 += MM_CHUNK) {
    for (int k = 0; k < MM_CHUNK; ++k) ws[k] = mm_weight(log_w, shift, n, r0 + k);
    for (int e = 0; e < MM_CHUNK * MM_TILE; ++e) {
      const int k = e / MM_TILE, c = e % MM_TILE;
      xa[k][c] = ws[k] * mm_centred(x, centre, n, d, r0 + k, a0 + c);
      xb[k][c] = mm_centred(x, centre, n, d, r0 + k, b0 + c);
    }
    for (int k = 0; k < MM_CHUNK; ++k)
      for (int a = 0; a < MM_TILE; ++a)
        for (int b = 0; b < MM_TILE; ++b)
          acc[a][b] = fmaf(xa[k][a], xb[k][b], acc[a][b]);
    if (diag)
      for (int c = 0; c < MM_TILE; ++c)
        for (int k = 0; k < MM_CHUNK; ++k) s1[c] += xa[k][c];
    if (first)
      for (int k = 0; k < MM_CHUNK; ++k) {
        wsum += ws[k];
        w2sum = fmaf(ws[k], ws[k], w2sum);
      }
  }
  float* out = s2p + (size_t)s * d * d;
  for (int a = 0; a < MM_TILE && a0 + a < d; ++a)
    for (int b = 0; b < MM_TILE && b0 + b < d; ++b)
      out[(size_t)(a0 + a) * d + b0 + b] = acc[a][b];
  float* out1 = s1p + (size_t)s * (d + 2);
  if (diag)
    for (int c = 0; c < MM_TILE && a0 + c < d; ++c) out1[a0 + c] = s1[c];
  if (first) {
    out1[d] = wsum;
    out1[d + 1] = w2sum;
  }
}

int ppi_mm_host(const float* log_w, const float* x, const float* centre,
                const float* shift, float* s2p, float* s1p, float* s2,
                float* s1w, int n, int d, int rows, int splits) {
  const int T = (d + MM_TILE - 1) / MM_TILE;
  for (int s = 0; s < splits; ++s)
    for (int p = 0; p < T * (T + 1) / 2; ++p)
      mm_block_host(p, s, log_w, x, centre, *shift, s2p, s1p, n, d, T, rows);
  const long dd = (long)d * d;
  for (long e = 0; e < dd; ++e) s2[e] = mm_sum_s2(s2p, d, splits, e);
  for (int e = 0; e < d + 2; ++e) s1w[e] = mm_sum_s1(s1p, d, splits, e);
  return 0;
}

#endif
