// Palm-IK kernel: the scripted experts' gradient IK, all iterations of one
// IK call in one launch.
//
// Replaces no Pallas kernel: the JAX package solves each expert's palm IK
// as a Python loop over jax.jit(jax.grad(obj)), obj the squared distance
// of the palm geom (env._sites_soa) to a target (ppi_tpu/envs/
// door_hand.py:344-361, door_adroit.py:351-371, hammer_hand.py:367-386,
// hammer_adroit.py:390-409, relocate_adroit.py:360-379). Eagerly in
// PyTorch one iteration is 2.5k-8.7k launches (the whole-site FK and its
// backward), and an expert runs up to 42,000 iterations.
//
// One thread runs `iters` steps of x <- clip(x - lr * grad f(x), lo, hi)
// over the first PPI_IK_NV coordinates of the configuration q, the others
// held at q_fixed. Every entry of x is clipped each step, the digits with
// a zero gradient included. The gradient is the generated header
// "ik_body.h": ppi_ik_grad, the scalar program's FK of the palm point p
// (fk_soa, geom_point_soa of ppi_tpu_torch/envs/physics/engine_soa.py)
// and its geometric Jacobian, a_j x (p - o_j) for a hinge and a_j for a
// slide, as 2 J^T (p - target), plus 2 w (x1 + x2 + x3) on x1-x3 where
// the header defines PPI_IK_LEVEL; emitted as straight-line f32 C by
// ppi_tpu_torch/envs/physics/ik_kernel.py. The compiler drops the bodies
// the palm does not depend on. This file is the hand-written skeleton
// around it.
//
// Layout: x0, lo, hi (PPI_IK_NV,); q_fixed (PPI_IK_NQ,), whose first
// PPI_IK_NV entries are not read; target (3,); dyn (3,), the scene offset
// of the model's dynamic body (the door frame, the board), read only where
// the header defines PPI_IK_DYN; params (2,): lr, w; out (PPI_IK_NV,).
//
// What bounds it on an H100: one thread's dependent chain of scalar f32
// operations (the FK down the palm's chain, then the Jacobian's dot
// products), a few hundred a step, `iters` steps one after another, on a
// configuration held in registers; no memory traffic inside the loop. It
// is latency-bound and uses one lane of one SM. A warp an IK call, the
// Jacobian's columns over its lanes, is the way to shorten the chain.
//
// The file also compiles as host C (no __CUDACC__): ppi_ik_host runs the
// same loop on the CPU and ppi_ik_grad_host the gradient alone, which the
// CPU tests call to check the generated body before any GPU run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#else
#include <math.h>
#define PPI_QUAL static inline
#endif

#include "ik_body.h"

// One IK call: `iters` projected gradient steps from x0.
PPI_QUAL void ppi_ik_solve(const float* x0, const float* q_fixed,
                           const float* target, const float* dyn,
                           const float* lo, const float* hi,
                           const float* params, int iters, float* out) {
  float q[PPI_IK_NQ], g[PPI_IK_NV], lower[PPI_IK_NV], upper[PPI_IK_NV];
  const float lr = params[0];
#pragma unroll
  for (int k = PPI_IK_NV; k < PPI_IK_NQ; ++k) q[k] = q_fixed[k];
#pragma unroll
  for (int j = 0; j < PPI_IK_NV; ++j) {
    q[j] = x0[j];
    lower[j] = lo[j];
    upper[j] = hi[j];
  }
  for (int it = 0; it < iters; ++it) {
    ppi_ik_grad(q, target, dyn, params, g);
#pragma unroll
    for (int j = 0; j < PPI_IK_NV; ++j)
      q[j] = ppi_min(ppi_max(q[j] - lr * g[j], lower[j]), upper[j]);
  }
#pragma unroll
  for (int j = 0; j < PPI_IK_NV; ++j) out[j] = q[j];
}

#ifdef __CUDACC__

__global__ void ppi_ik_kernel(const float* __restrict__ x0,
                              const float* __restrict__ q_fixed,
                              const float* __restrict__ target,
                              const float* __restrict__ dyn,
                              const float* __restrict__ lo,
                              const float* __restrict__ hi,
                              const float* __restrict__ params,
                              float* __restrict__ out, int iters) {
  ppi_ik_solve(x0, q_fixed, target, dyn, lo, hi, params, iters, out);
}

// Launches one thread on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int ppi_ik_launch(const float* x0, const float* q_fixed,
                             const float* target, const float* dyn,
                             const float* lo, const float* hi,
                             const float* params, float* out, int iters,
                             void* stream) {
  ppi_ik_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      x0, q_fixed, target, dyn, lo, hi, params, out, iters);
  return (int)cudaGetLastError();
}

#else

int ppi_ik_host(const float* x0, const float* q_fixed, const float* target,
                const float* dyn, const float* lo, const float* hi,
                const float* params, float* out, int iters) {
  ppi_ik_solve(x0, q_fixed, target, dyn, lo, hi, params, iters, out);
  return 0;
}

// The generated gradient alone at the configuration q (PPI_IK_NQ,).
int ppi_ik_grad_host(const float* q, const float* target, const float* dyn,
                     const float* params, float* g) {
  ppi_ik_grad(q, target, dyn, params, g);
  return 0;
}

#endif
