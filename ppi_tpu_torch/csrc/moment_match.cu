// Weighted Gaussian moment match on Hopper's tensor cores, in three launches.
//
// Replaces the Pallas kernel ppi_tpu/ops/pallas_ops.py::m_projection_pallas
// (body _mm_kernel, pallas_call at line 78). Given log-weights log_w (N,) and
// samples x (N, d) row-major, it computes, with c the column means and
// shift = max(log_w),
//     w_i = exp(log_w_i - shift)           (-inf gives exactly 0)
//     S1  = sum_i w_i (x_i - c)            S2 = sum_i w_i (x_i - c)(x_i - c)^T
//     W   = sum_i w_i                      W2 = sum_i w_i^2
//     mu  = S1 / W + c    sigma = S2 / W - mu_c mu_c^T    ess = W^2 / W2
// and writes mu, sigma (exactly symmetric) and ess into one output buffer.
//
// What bounds it on an H100: S2, 2 N d^2 multiply-adds (half of them with the
// upper triangle) over 4 (N d + N) bytes read. At N=4096, d=640 that is
// ~1.7 GFLOP over ~10.5 MB: bound by operations. On the CUDA cores (67
// TFLOP/s f32) that floor is ~25 us. The tensor cores run TF32 at 495
// TFLOP/s, but one TF32 product keeps 11 significant bits, far from f32
// accuracy. So S2 runs on the tensor cores in three TF32 products a term:
// each staged value v, after centring (a mean of 100 and a spread of 0.01
// would lose the spread if split before), is split into hi = tf32(v) and
// lo = tf32(v - hi), and the products lo*hi + hi*lo, then hi*hi, of each
// chunk of 32 samples are summed from 0 on the tensor cores and added to the
// running sums in f32 on the CUDA cores. The tensor cores' own accumulation
// drops the bits below its running value's: a build that carried the sums
// through them over all of a block's samples left sigma beyond 1e-5 of
// plain at (4000, 640) and (16384, 640) on an H100.
//
// Design:
//   1. mm_prologue, grid (ceil(d/32), P): block (c, p) sums columns
//      32c..32c+31 over rows [p*part_rows, (p+1)*part_rows) into colsum
//      (P, d), and the blocks of c = 0 the max of log_w over their rows into
//      maxp (P). Fixed order: 8 row groups a column, then the groups in
//      order.
//   2. mm_main, grid (S, pairs), clusters of S blocks (S <= 8): a block of
//      TILE/64 warpgroups computes one TILE x TILE tile (TILE 128, or 64 for
//      d <= 64) of the upper triangle of S2 over rank s's range of `rows`
//      samples. It first takes shift (the max of maxp) and the centre of its
//      columns (colsum summed over p in order, over N), then walks its rows
//      in chunks of 32: global -> registers (the next chunk's loads in
//      flight) -> centre, weight, split -> shared memory, double-buffered,
//      K-major in unswizzled core matrices (8 rows x 16 bytes) as wgmma
//      reads TF32 operands. Each warpgroup issues the chunk's 12
//      wgmma.m64nTILEk8 products asynchronously and stages the next chunk
//      while the tensor cores run them. S1 (diagonal tiles), W and W2 (tile
//      pair 0) are summed in plain f32 from the staged f32 values. The S
//      partial tiles of a cluster are then summed through distributed
//      shared memory in the fixed order of the ranks (rank r sums rows r,
//      r + S, ...), and written once to the sigma buffer: no scratch of
//      partials in device memory and no atomics.
//   3. mm_epilogue, one block of 32 x 8 threads for each 32 x 32 tile of the
//      upper triangle: sigma = S2 / W - mu_c mu_c^T in place, mirrored into
//      the lower triangle through a shared-memory transpose (the diagonal
//      tiles take the upper value for both), and mu and ess.
// Ragged N and d are masked in the kernels, not padded by copies. Two
// launches on one input give bit-identical output. The tile, S and P come
// from the shape only (ppi_tpu_torch/ops/cuda_ops.py::plan).
//
// wgmma over mma.sync: a first version of this design issued
// mma.sync.m16n8k8 TF32 products from register fragments; on the card it
// was bound by the tensor pipe's mma.sync rate, with the fragments' shared
// loads and register moves beside it, and was the slower of the two.
//
// What bounds it now: the staging, not the tensor cores (a build with SM
// clocks around each step of the main loop, on an H100): each block
// centres, weights and splits the samples of its own two column strips, so
// each value is staged once for every tile pair that reads it.
//
// The file also compiles as host C (no __CUDACC__): ppi_mm_host then runs the
// same prologue, tile pairs, cluster ranks, chunks, TF32 split, products of 8
// samples, chunk sums and reduction orders one after the other on the CPU,
// which the CPU tests hold against the plain version (the tensor cores'
// internal order of a product's 8 terms is the hardware's: the model sums
// them in order).

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>
#define PPI_QUAL __host__ __device__ __forceinline__
namespace cg = cooperative_groups;
#else
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#define PPI_QUAL static inline
#endif

#define MM_THREADS 256   // threads of a prologue or epilogue block
#define MM_MAX_CLUSTER 8 // blocks of a cluster, at most
#define MM_CHUNK 32      // samples staged a chunk
#define MM_RED_PAD 4     // a row of the reduced tile is TILE + MM_RED_PAD
#define MM_COLS 32       // prologue: columns a block
#define MM_GROUPS 8      // prologue: row groups a block
#define MM_KS (MM_CHUNK / 8)  // k8 products a chunk, summed from 0

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

// v rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 does; inf and NaN pass through. In integer
// operations on the card too: sm_90a emulates cvt.rna.tf32.f32 in ~6
// instructions.
PPI_QUAL float mm_tf32(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  memcpy(&v, &u, 4);
  return v;
}

// mm_tf32 without the inf and NaN guard, for lo = v - tf32(v): finite
// wherever v is, and where v is not, its hi carries the inf or NaN into
// every product.
PPI_QUAL float mm_tf32_lo(float v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  u = (u + 0x1000u) & 0xffffe000u;
  memcpy(&v, &u, 4);
  return v;
}

// The column mean of column col (0 past d): its P partial sums in order,
// over n.
PPI_QUAL float mm_centre(const float* colsum, int parts, int n, int d,
                         int col) {
  if (col >= d) return 0.0f;
  float v = 0.0f;
  for (int p = 0; p < parts; ++p) v += colsum[(size_t)p * d + col];
  return v / (float)n;
}

PPI_QUAL float mm_shift(const float* maxp, int parts) {
  float m = maxp[0];
  for (int p = 1; p < parts; ++p) m = fmaxf(m, maxp[p]);
  return m;
}

// Floats of the main kernel's dynamic shared memory: two stages of the A
// (w (x - c)) and B (x - c) operands' hi and lo parts, each a K-major
// MM_CHUNK x tile tile, and the chunk's weights. The cluster reduction
// reuses it for the partial tile, S1 and W.
PPI_QUAL size_t mm_smem_floats(int tile) {
  return (size_t)2 * 4 * MM_CHUNK * tile + MM_CHUNK;
}

// The buffer's layout: sigma (d, d), mu (d), ess, then the scratch colsum
// (P, d), maxp (P), S1 (d), centre (d), [W, W2].
typedef struct {
  float *sigma, *mu, *ess, *colsum, *maxp, *s1, *centre, *wsum;
} MmBuffers;

PPI_QUAL MmBuffers mm_buffers(float* out, int d, int parts) {
  MmBuffers b;
  const size_t dd = (size_t)d * d;
  b.sigma = out;
  b.mu = out + dd;
  b.ess = b.mu + d;
  b.colsum = b.ess + 1;
  b.maxp = b.colsum + (size_t)parts * d;
  b.s1 = b.maxp + parts;
  b.centre = b.s1 + d;
  b.wsum = b.centre + d;
  return b;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(MM_THREADS)
mm_prologue(const float* __restrict__ log_w, const float* __restrict__ x,
            float* __restrict__ colsum, float* __restrict__ maxp, int n,
            int d, int part_rows) {
  __shared__ float red[MM_GROUPS][MM_COLS + 1];
  __shared__ float mred[MM_THREADS];
  const int t = threadIdx.x, c = t % MM_COLS, g = t / MM_COLS;
  const int col = blockIdx.x * MM_COLS + c, p = blockIdx.y;
  const int begin = p * part_rows;
  const int end = begin + part_rows < n ? begin + part_rows : n;
  float s = 0.0f;
  if (col < d) {
#pragma unroll 8
    for (int r = begin + g; r < end; r += MM_GROUPS)
      s += x[(size_t)r * d + col];
  }
  red[g][c] = s;
  __syncthreads();
  if (g == 0 && col < d) {
    float v = 0.0f;
    for (int q = 0; q < MM_GROUPS; ++q) v += red[q][c];
    colsum[(size_t)p * d + col] = v;
  }
  if (blockIdx.x == 0) {
    float m = -INFINITY;
    for (int r = begin + t; r < end; r += MM_THREADS) m = fmaxf(m, log_w[r]);
    mred[t] = m;
    __syncthreads();
    for (int h = MM_THREADS / 2; h > 0; h /= 2) {
      if (t < h) mred[t] = fmaxf(mred[t], mred[t + h]);
      __syncthreads();
    }
    if (t == 0) maxp[p] = mred[0];
  }
}

// The shared-memory descriptor of a K-major, unswizzled operand tile:
// core matrices of 8 rows x 16 bytes, 128 bytes apart along K (LBO) and
// 256 bytes apart along M or N (SBO).
__device__ __forceinline__ uint64_t mm_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D (64 x N, f32, N/2 registers a thread) = A B + (scale_d ? D : 0), A
// (64 x 8) and B (8 x N) TF32 from shared memory; asynchronous until
// wgmma.wait_group.
__device__ __forceinline__ void mm_wgmma128(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mm_wgmma64(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int TILE>
__device__ __forceinline__ void mm_wg(float* d, uint64_t da, uint64_t db,
                                      int scale_d) {
  if constexpr (TILE == 128) mm_wgmma128(d, da, db, scale_d);
  else mm_wgmma64(d, da, db, scale_d);
}

template <int TILE>
__global__ void __launch_bounds__(2 * TILE, 1)
mm_main(const float* __restrict__ log_w, const float* __restrict__ x,
        const float* __restrict__ colsum, const float* __restrict__ maxp,
        float* __restrict__ s2, float* __restrict__ s1_out,
        float* __restrict__ centre_out, float* __restrict__ wsum_out, int n,
        int d, int T, int rows, int parts) {
  constexpr int THREADS = 2 * TILE;          // TILE / 64 warpgroups
  constexpr int OP = MM_CHUNK * TILE;        // floats of one operand part
  constexpr int STAGE = 4 * OP;              // A hi, A lo, B hi, B lo
  constexpr int NACC = TILE / 2;             // accumulators a thread
  constexpr int QUADS = MM_CHUNK / 4 / 2;    // row quads a thread stages
  constexpr int LDR = TILE + MM_RED_PAD;
  constexpr int KG = 2;
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();

  int ti, tj;
  mm_tile_pair(blockIdx.y, T, &ti, &tj);
  const bool diag = ti == tj, first = blockIdx.y == 0;
  const int a0 = ti * TILE, b0 = tj * TILE;
  const int t = threadIdx.x, cc = t % TILE, kg = t / TILE;
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int wg = warp / 4, wi = warp % 4;
  const int acol = a0 + cc, bcol = b0 + cc;
  const int begin = rank * rows;
  const int end = begin + rows < n ? begin + rows : n;
  const int chunks = (end - begin + MM_CHUNK - 1) / MM_CHUNK;
  // shift and the two columns' centres (mm_shift's and mm_centre's
  // arithmetic), their partials loaded together
  float shift = maxp[0], ca = 0.0f, cb = 0.0f;
  {
    const float* pa = colsum + (acol < d ? acol : 0);
    const float* pb = colsum + (bcol < d ? bcol : 0);
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {
      if (p > 0) shift = fmaxf(shift, maxp[p]);
      ca += pa[p * d];
      cb += pb[p * d];
    }
    ca = acol < d ? ca / (float)n : 0.0f;
    cb = bcol < d ? cb / (float)n : 0.0f;
  }

  float acc[NACC], part[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = part[e] = 0.0f;
  float s1 = 0.0f, wsum = 0.0f, w2sum = 0.0f;
  float* ws = smem + 2 * STAGE;                  // [MM_CHUNK]
  float ra[4 * QUADS], rb[4 * QUADS], rl = 0.0f;

  // thread (cc, kg) stages column cc of rows 4q..4q+3 for the quads
  // q = kg, kg + 2, ...: a float4 of K at its core-matrix row. A masked
  // value loads the column's centre, so it centres to exactly 0; a chunk
  // whose rows and the thread's columns all lie inside loads unmasked
  // (N d < 2^31: int offsets).
  const bool cols_in = acol < d && bcol < d;
  auto load = [&](int c) {
    const int r0 = begin + c * MM_CHUNK;
    const float* pa = x + (size_t)(r0 + 4 * kg) * d + acol;
    const float* pb = x + (size_t)(r0 + 4 * kg) * d + bcol;
    if (cols_in && r0 + MM_CHUNK <= end) {
#pragma unroll
      for (int q = 0; q < QUADS; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ra[4 * q + r] = pa[(8 * q + r) * d];
          if (!diag) rb[4 * q + r] = pb[(8 * q + r) * d];
        }
    } else {
#pragma unroll
      for (int q = 0; q < QUADS; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bool ok = r0 + 4 * (kg + 2 * q) + r < end;
          ra[4 * q + r] = ok && acol < d ? pa[(8 * q + r) * d] : ca;
          if (!diag)
            rb[4 * q + r] = ok && bcol < d ? pb[(8 * q + r) * d] : cb;
        }
    }
    if (t < MM_CHUNK) {
      const int k = r0 + t;
      rl = k < end ? log_w[k] : -INFINITY;
    }
  };

  auto weights = [&]() {
    if (t < MM_CHUNK) {
      const float w = expf(rl - shift);
      ws[t] = w;
      wsum += w;
      w2sum = fmaf(w, w, w2sum);
    }
  };
  auto store = [&](int s) {
    float* st = smem + s * STAGE;
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const int quad = kg + 2 * q, ks = quad / 2, kb = quad % 2;
      const int at =
          ks * TILE * 8 + ((cc / 8) * 2 + kb) * 32 + (cc % 8) * 4;
      float ah[4], al[4], bh[4], bl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xa = ws[4 * quad + r] * (ra[4 * q + r] - ca);
        const float xb = (diag ? ra[4 * q + r] : rb[4 * q + r]) - cb;
        s1 += xa;
        ah[r] = mm_tf32(xa);
        al[r] = mm_tf32_lo(xa - ah[r]);
        bh[r] = mm_tf32(xb);
        bl[r] = mm_tf32_lo(xb - bh[r]);
      }
      float4* out = reinterpret_cast<float4*>(st + at);
      out[0] = make_float4(ah[0], ah[1], ah[2], ah[3]);
      out[OP / 4] = make_float4(al[0], al[1], al[2], al[3]);
      out[OP / 2] = make_float4(bh[0], bh[1], bh[2], bh[3]);
      out[3 * OP / 4] = make_float4(bl[0], bl[1], bl[2], bl[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  auto pin = [&]() {
#pragma unroll
    for (int e = 0; e < NACC; ++e)
      asm volatile("" : "+f"(part[e])::"memory");
  };
  // the chunk's 12 products (lo*hi + hi*lo, then hi*hi, for each k8 step)
  // into part from 0, asynchronously
  auto issue = [&](int s) {
    const float* st = smem + s * STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < MM_KS; ++ks) {
      const float* a = st + ks * TILE * 8 + wg * 64 * 8;
      const float* b = st + 2 * OP + ks * TILE * 8;
      mm_wg<TILE>(part, mm_desc(a + OP), mm_desc(b), ks > 0);
      mm_wg<TILE>(part, mm_desc(a), mm_desc(b + OP), 1);
      mm_wg<TILE>(part, mm_desc(a), mm_desc(b), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    pin();
  };

  // chunk c + 1's loads are issued right after chunk c's values leave the
  // registers, a whole chunk before they are staged; chunk c's products run
  // on the tensor cores while chunk c + 1 is staged
  load(0);
  weights();
  __syncthreads();
  store(0);
  if (chunks > 1) load(1);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    issue(c & 1);
    if (c + 1 < chunks) {
      weights();
      __syncthreads();
      store((c + 1) & 1);
      if (c + 2 < chunks) load(c + 2);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin();
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] += part[e];
    __syncthreads();
  }

  float* red = smem;                       // TILE x LDR
  float* s1_parts = red + TILE * LDR;      // KG x TILE
  float* red_s1 = s1_parts + KG * TILE;    // TILE
  float* w_parts = red_s1 + TILE;          // MM_CHUNK x 2
  float* red_w = w_parts + 2 * MM_CHUNK;   // 2
  {
    const int row = wg * 64 + wi * 16 + g;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int col = j * 8 + 2 * tq;
      red[row * LDR + col] = acc[4 * j];
      red[row * LDR + col + 1] = acc[4 * j + 1];
      red[(row + 8) * LDR + col] = acc[4 * j + 2];
      red[(row + 8) * LDR + col + 1] = acc[4 * j + 3];
    }
  }
  s1_parts[kg * TILE + cc] = s1;
  if (t < MM_CHUNK) {
    w_parts[2 * t] = wsum;
    w_parts[2 * t + 1] = w2sum;
  }
  __syncthreads();
  if (t < TILE) {
    float v = 0.0f;
    for (int q = 0; q < KG; ++q) v += s1_parts[q * TILE + t];
    red_s1[t] = v;
  }
  if (t < 2) {
    float v = 0.0f;
    for (int q = 0; q < MM_CHUNK; ++q) v += w_parts[2 * q + t];
    red_w[t] = v;
  }
  cluster.sync();
  const int my_rows = (TILE - rank + splits - 1) / splits;
  for (int e = t; e < my_rows * TILE; e += THREADS) {
    const int row = rank + splits * (e / TILE), col = e % TILE;
    float pr[MM_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MM_MAX_CLUSTER; ++q)
      if (q < splits)
        pr[q] = cluster.map_shared_rank(red, q)[row * LDR + col];
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < MM_MAX_CLUSTER; ++q)
      if (q < splits) v += pr[q];
    if (a0 + row < d && b0 + col < d)
      s2[(size_t)(a0 + row) * d + b0 + col] = v;
  }
  if (diag && rank == 0 && t < TILE && a0 + t < d) {
    float v = 0.0f;
    for (int q = 0; q < splits; ++q)
      v += cluster.map_shared_rank(red_s1, q)[t];
    s1_out[a0 + t] = v;
    centre_out[a0 + t] = ca;
  }
  if (first && rank == 0 && t < 2) {
    float v = 0.0f;
    for (int q = 0; q < splits; ++q)
      v += cluster.map_shared_rank(red_w, q)[t];
    wsum_out[t] = v;
  }
  cluster.sync();
}

__global__ void __launch_bounds__(MM_THREADS)
mm_epilogue(float* __restrict__ sigma, const float* __restrict__ s1,
            const float* __restrict__ centre, const float* __restrict__ wsum,
            float* __restrict__ mu, float* __restrict__ ess, int d, int T32) {
  __shared__ float tile[32][33];
  int ti, tj;
  mm_tile_pair(blockIdx.x, T32, &ti, &tj);
  const int a0 = ti * 32, b0 = tj * 32, tx = threadIdx.x, ty = threadIdx.y;
  const float W = wsum[0];
  for (int r = ty; r < 32; r += 8) {
    const int a = a0 + r, b = b0 + tx;
    if (a < d && b < d)
      tile[r][tx] = sigma[(size_t)a * d + b] / W - (s1[a] / W) * (s1[b] / W);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    int a = a0 + r, b = b0 + tx;
    if (a < d && b < d)
      sigma[(size_t)a * d + b] = ti == tj && r > tx ? tile[tx][r] : tile[r][tx];
    a = b0 + r;
    b = a0 + tx;
    if (ti != tj && a < d && b < d) sigma[(size_t)a * d + b] = tile[tx][r];
  }
  if (blockIdx.x == 0) {
    const int t = ty * 32 + tx;
    for (int c = t; c < d; c += MM_THREADS) mu[c] = s1[c] / W + centre[c];
    if (t == 0) *ess = W * W / wsum[1];
  }
}

template <int TILE>
static int mm_launch_main(const float* log_w, const float* x, MmBuffers b,
                          int n, int d, int rows, int splits, int parts,
                          cudaStream_t st) {
  const int T = (d + TILE - 1) / TILE;
  const size_t smem = mm_smem_floats(TILE) * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      mm_main<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, T * (T + 1) / 2, 1);
  cfg.blockDim = dim3(2 * TILE, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, mm_main<TILE>, log_w, x,
                                 (const float*)b.colsum,
                                 (const float*)b.maxp, b.sigma, b.s1,
                                 b.centre, b.wsum, n, d, T, rows, parts);
}

// The three launches on `stream`; returns the first CUDA error (0 on
// success). `out` holds (mm_buffers) sigma, mu, ess and the scratch.
extern "C" int ppi_mm_launch(const float* log_w, const float* x, float* out,
                             int n, int d, int tile, int rows, int splits,
                             int parts, int part_rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const MmBuffers b = mm_buffers(out, d, parts);
  if ((tile != 64 && tile != 128) || splits < 1 || splits > MM_MAX_CLUSTER)
    return -1;
  mm_prologue<<<dim3((d + MM_COLS - 1) / MM_COLS, parts), MM_THREADS, 0,
                st>>>(log_w, x, b.colsum, b.maxp, n, d, part_rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = tile == 128
            ? mm_launch_main<128>(log_w, x, b, n, d, rows, splits, parts, st)
            : mm_launch_main<64>(log_w, x, b, n, d, rows, splits, parts, st);
  if (err != 0) return err;
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int T32 = (d + 31) / 32;
  mm_epilogue<<<T32 * (T32 + 1) / 2, dim3(32, 8), 0, st>>>(
      b.sigma, b.s1, b.centre, b.wsum, b.mu, b.ess, d, T32);
  return (int)cudaGetLastError();
}

#else

static void mm_prologue_host(const float* log_w, const float* x, MmBuffers b,
                             int n, int d, int parts, int part_rows) {
  for (int p = 0; p < parts; ++p) {
    const int begin = p * part_rows;
    const int end = begin + part_rows < n ? begin + part_rows : n;
    for (int col = 0; col < d; ++col) {
      float gs[MM_GROUPS] = {0.0f};
      for (int g = 0; g < MM_GROUPS; ++g)
        for (int r = begin + g; r < end; r += MM_GROUPS)
          gs[g] += x[(size_t)r * d + col];
      float v = 0.0f;
      for (int g = 0; g < MM_GROUPS; ++g) v += gs[g];
      b.colsum[(size_t)p * d + col] = v;
    }
    float m = -INFINITY;
    for (int r = begin; r < end; ++r) m = fmaxf(m, log_w[r]);
    b.maxp[p] = m;
  }
}

// One block of mm_main (tile pair `pair`, cluster rank `rank`): its partial
// tile (tile x tile), S1 (tile) and [W, W2], in the kernel's orders.
static void mm_block_host(int pair, int rank, const float* log_w,
                          const float* x, MmBuffers b, int n, int d, int tile,
                          int rows, int parts, float* tile_out, float* s1_out,
                          float* w_out, float* st) {
  const int T = (d + tile - 1) / tile, kgs = 2;
  int ti, tj;
  mm_tile_pair(pair, T, &ti, &tj);
  const int a0 = ti * tile, b0 = tj * tile;
  const float shift = mm_shift(b.maxp, parts);
  const int begin = rank * rows;
  const int end = begin + rows < n ? begin + rows : n;
  const int na = d - a0 < tile ? d - a0 : tile;
  const int nb = d - b0 < tile ? d - b0 : tile;
  float* ahi = st;                          // MM_CHUNK x tile each
  float* alo = ahi + MM_CHUNK * tile;
  float* bhi = alo + MM_CHUNK * tile;
  float* blo = bhi + MM_CHUNK * tile;
  float* ca = blo + MM_CHUNK * tile;        // tile
  float* cb = ca + tile;                    // tile
  float* s1k = cb + tile;                   // kgs x tile: column c, rows
                                            // of quads kg, kg + 2, ...
  float wk[2 * MM_CHUNK];                   // lane t: rows t of each chunk
  for (int c = 0; c < tile; ++c) {
    ca[c] = mm_centre(b.colsum, parts, n, d, a0 + c);
    cb[c] = mm_centre(b.colsum, parts, n, d, b0 + c);
  }
  memset(tile_out, 0, sizeof(float) * tile * tile);
  memset(s1k, 0, sizeof(float) * kgs * tile);
  memset(wk, 0, sizeof(wk));
  for (int r0 = begin; r0 < end; r0 += MM_CHUNK) {
    for (int kk = 0; kk < MM_CHUNK; ++kk) {
      const int k = r0 + kk, kg = kk / 4 % kgs, ok = k < end;
      const float w = ok ? expf(log_w[k] - shift) : 0.0f;
      wk[2 * kk] += w;
      wk[2 * kk + 1] = fmaf(w, w, wk[2 * kk + 1]);
      for (int c = 0; c < tile; ++c) {
        const float xa = ok && a0 + c < d
                             ? w * (x[(size_t)k * d + a0 + c] - ca[c])
                             : 0.0f;
        const float xb =
            ok && b0 + c < d ? x[(size_t)k * d + b0 + c] - cb[c] : 0.0f;
        const float ha = mm_tf32(xa), hb = mm_tf32(xb);
        s1k[kg * tile + c] += xa;
        ahi[kk * tile + c] = ha;
        alo[kk * tile + c] = mm_tf32_lo(xa - ha);
        bhi[kk * tile + c] = hb;
        blo[kk * tile + c] = mm_tf32_lo(xb - hb);
      }
    }
    for (int a = 0; a < na; ++a)
      for (int c = 0; c < nb; ++c) {
        float part = 0.0f;
        for (int k0 = 0; k0 < MM_CHUNK; k0 += 8) {
          float p = 0.0f;
          for (int k = k0; k < k0 + 8; ++k)
            p += alo[k * tile + a] * bhi[k * tile + c];
          part += p;
          p = 0.0f;
          for (int k = k0; k < k0 + 8; ++k)
            p += ahi[k * tile + a] * blo[k * tile + c];
          part += p;
          p = 0.0f;
          for (int k = k0; k < k0 + 8; ++k)
            p += ahi[k * tile + a] * bhi[k * tile + c];
          part += p;
        }
        tile_out[a * tile + c] += part;
      }
  }
  for (int c = 0; c < tile; ++c) {
    float v = 0.0f;
    for (int q = 0; q < kgs; ++q) v += s1k[q * tile + c];
    s1_out[c] = v;
  }
  for (int e = 0; e < 2; ++e) {
    float v = 0.0f;
    for (int q = 0; q < MM_CHUNK; ++q) v += wk[2 * q + e];
    w_out[e] = v;
  }
}

static int mm_main_host(const float* log_w, const float* x, MmBuffers b,
                        int n, int d, int tile, int rows, int splits,
                        int parts) {
  const int T = (d + tile - 1) / tile;
  const size_t tt = (size_t)tile * tile;
  float* parts_buf = (float*)malloc(sizeof(float) * splits * (tt + tile + 2));
  float* st = (float*)malloc(
      sizeof(float) * (4 * MM_CHUNK * tile + 4 * tile));
  if (parts_buf == NULL || st == NULL) {
    free(parts_buf);
    free(st);
    return -1;
  }
  for (int pair = 0; pair < T * (T + 1) / 2; ++pair) {
    int ti, tj;
    mm_tile_pair(pair, T, &ti, &tj);
    const int a0 = ti * tile, b0 = tj * tile;
    for (int r = 0; r < splits; ++r)
      mm_block_host(pair, r, log_w, x, b, n, d, tile, rows, parts,
                    parts_buf + r * tt, parts_buf + splits * tt + r * tile,
                    parts_buf + splits * (tt + tile) + 2 * r, st);
    for (int a = 0; a < tile && a0 + a < d; ++a)
      for (int c = 0; c < tile && b0 + c < d; ++c) {
        float v = 0.0f;
        for (int q = 0; q < splits; ++q) v += parts_buf[q * tt + a * tile + c];
        b.sigma[(size_t)(a0 + a) * d + b0 + c] = v;
      }
    if (ti == tj)
      for (int c = 0; c < tile && a0 + c < d; ++c) {
        float v = 0.0f;
        for (int q = 0; q < splits; ++q)
          v += parts_buf[splits * tt + q * tile + c];
        b.s1[a0 + c] = v;
        b.centre[a0 + c] = mm_centre(b.colsum, parts, n, d, a0 + c);
      }
    if (pair == 0)
      for (int e = 0; e < 2; ++e) {
        float v = 0.0f;
        for (int q = 0; q < splits; ++q)
          v += parts_buf[splits * (tt + tile) + 2 * q + e];
        b.wsum[e] = v;
      }
  }
  free(parts_buf);
  free(st);
  return 0;
}

static void mm_epilogue_host(MmBuffers b, int d) {
  const float W = b.wsum[0];
  for (int a = 0; a < d; ++a)
    for (int c = a; c < d; ++c) {
      const size_t up = (size_t)a * d + c;
      b.sigma[up] = b.sigma[up] / W - (b.s1[a] / W) * (b.s1[c] / W);
      b.sigma[(size_t)c * d + a] = b.sigma[up];
    }
  for (int c = 0; c < d; ++c) b.mu[c] = b.s1[c] / W + b.centre[c];
  *b.ess = W * W / b.wsum[1];
}

int ppi_mm_host(const float* log_w, const float* x, float* out, int n, int d,
                int tile, int rows, int splits, int parts, int part_rows) {
  const MmBuffers b = mm_buffers(out, d, parts);
  if ((tile != 64 && tile != 128) || splits < 1 || splits > MM_MAX_CLUSTER)
    return -1;
  mm_prologue_host(log_w, x, b, n, d, parts, part_rows);
  const int err = mm_main_host(log_w, x, b, n, d, tile, rows, splits, parts);
  if (err != 0) return err;
  mm_epilogue_host(b, d);
  return 0;
}

// mm_tf32 on n values, for the tests of its rounding.
int ppi_mm_tf32(const float* in, float* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = mm_tf32(in[i]);
  return 0;
}

#endif
