// Whole-rollout kernel: N rollouts of H control steps of contact physics,
// one thread per rollout lane.
//
// Replaces the Pallas megakernel ppi_tpu/envs/physics/pallas_rollout.py
// (make_pallas_rollout, pallas_call at line 190). Per control step, per
// lane: the env's torque, PPI_SUBSTEPS physics substeps (FK, Jacobians,
// mass matrix, Newton-Euler bias, penalty contacts, Gauss-Jordan solve,
// semi-implicit Euler), the env's optional projection (PPI_PROJECT: a
// kinematic clamp that sees the step's initial coordinates q_prev), a
// sticky NaN latch, and that step's reward.
// The reward may take the step's raw action (a control cost) and
// PPI_NCONSTS per-episode constants (a sampled goal), read once per lane.
//
// The per-env body (env_torque, env_substep, env_reward, env_project where
// PPI_PROJECT is defined, and the PPI_* sizes) is the generated header
// "env_body.h": the same Python scalar
// program that runs eagerly over torch tensors, emitted as straight-line
// f32 C (ppi_tpu_torch/envs/physics/rollout_kernel.py). This file is the
// hand-written skeleton around it.
//
// Layout (as the Pallas kernel's): q0, qd0 (nq, N); actions (H, d_a, N);
// rewards (H, N); qf, qdf (nq, N); dyn (3,) and consts (PPI_NCONSTS,),
// either null when the env has none. Lane-major, so a warp's loads and
// stores are coalesced. Lanes >= n are masked, not padded.
//
// What bounds it on an H100: each lane is a long dependent scalar chain
// (thousands of f32 ops per substep) with q and qd in registers and almost
// no memory traffic, so it is latency-bound at low occupancy: 1024 lanes
// are 32 warps on 132 SMs, and the canonical 64 lanes are 2 warps. The
// 12- and 23-DoF hand bodies exceed 255 registers and keep 2.6 and 7.5 KB
// of stack a lane (nvcc -Xptxas -v, sm_90a), which at 64 lanes stays in L1
// and adds latency, not memory traffic. Making it fast -- more parallelism
// per lane (splitting a substep across threads), CUDA graphs around the
// PPI iteration -- is later work.
//
// The file also compiles as host C (no __CUDACC__): the lane loop then runs
// on the CPU through ppi_rollout_host, which the CPU tests call to check the
// generated body before any GPU run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#define PPI_NAN __int_as_float(0x7fc00000)
#else
#include <math.h>
#define PPI_QUAL static inline
#define PPI_NAN NAN
#endif

#include "env_body.h"

// One rollout lane: horizon control steps from (q0, qd0)[lane].
PPI_QUAL void ppi_rollout_lane(int lane, int n, int horizon,
                               const float* q0, const float* qd0,
                               const float* act, const float* dyn,
                               const float* consts, float* rew, float* qf,
                               float* qdf) {
  float q[PPI_NQ], qd[PPI_NQ], a[PPI_DA], tau[PPI_NQ];
#ifdef PPI_PROJECT
  float q_prev[PPI_NQ];
#endif
  for (int j = 0; j < PPI_NQ; ++j) {
    q[j] = q0[j * n + lane];
    qd[j] = qd0[j * n + lane];
  }
  int bad = 0;
  for (int t = 0; t < horizon; ++t) {
    for (int k = 0; k < PPI_DA; ++k) a[k] = act[(t * PPI_DA + k) * n + lane];
    env_torque(q, qd, a, dyn, tau);
#ifdef PPI_PROJECT
    for (int j = 0; j < PPI_NQ; ++j) q_prev[j] = q[j];
#endif
    for (int s = 0; s < PPI_SUBSTEPS; ++s) env_substep(q, qd, tau, dyn);
#ifdef PPI_PROJECT
    env_project(q_prev, q, qd, dyn);
#endif
    // sticky NaN latch: from a lane's first non-finite state on, its
    // reward is NaN (the solver then gives it zero weight)
    for (int j = 0; j < PPI_NQ; ++j) {
      if (ppi_isfinite(q[j]) == 0.0f || ppi_isfinite(qd[j]) == 0.0f) bad = 1;
    }
    const float r = env_reward(q, qd, a, dyn, consts);
    rew[t * n + lane] = bad ? PPI_NAN : r;
  }
  for (int j = 0; j < PPI_NQ; ++j) {
    qf[j * n + lane] = q[j];
    qdf[j * n + lane] = qd[j];
  }
}

#ifdef __CUDACC__

__global__ void ppi_rollout_kernel(const float* __restrict__ q0,
                                   const float* __restrict__ qd0,
                                   const float* __restrict__ act,
                                   const float* __restrict__ dyn,
                                   const float* __restrict__ consts,
                                   float* __restrict__ rew,
                                   float* __restrict__ qf,
                                   float* __restrict__ qdf,
                                   int n, int horizon) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (dyn != nullptr) {
    d[0] = dyn[0];
    d[1] = dyn[1];
    d[2] = dyn[2];
  }
  // the episode's reward constants, in registers like the body offset
  float c[PPI_NCONSTS > 0 ? PPI_NCONSTS : 1] = {0.0f};
  for (int k = 0; k < PPI_NCONSTS; ++k) c[k] = consts[k];
  ppi_rollout_lane(lane, n, horizon, q0, qd0, act, d, c, rew, qf, qdf);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ppi_rollout_launch(const float* q0, const float* qd0,
                                  const float* act, const float* dyn,
                                  const float* consts, float* rew,
                                  float* qf, float* qdf, int n, int horizon,
                                  int block, void* stream) {
  const int grid = (n + block - 1) / block;
  ppi_rollout_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      q0, qd0, act, dyn, consts, rew, qf, qdf, n, horizon);
  return (int)cudaGetLastError();
}

#else

int ppi_rollout_host(const float* q0, const float* qd0, const float* act,
                     const float* dyn, const float* consts, float* rew,
                     float* qf, float* qdf, int n, int horizon) {
  for (int lane = 0; lane < n; ++lane)
    ppi_rollout_lane(lane, n, horizon, q0, qd0, act, dyn, consts, rew, qf,
                     qdf);
  return 0;
}

#endif
