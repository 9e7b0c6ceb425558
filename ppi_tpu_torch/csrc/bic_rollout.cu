// Ball-in-a-cup kernel: N episodic trajectories of the ball-in-a-cup task,
// one thread per trajectory, all three phases in one launch.
//
// Replaces no Pallas kernel: the JAX package runs these trajectories as an
// XLA scan under jax.vmap (ppi_tpu/envs/episodic.py, BallInACup.evaluate,
// over BallInCupSim.execute_trajectory, ppi_tpu/envs/ball_in_a_cup.py:341).
// Eagerly in PyTorch one trajectory of 1,600 steps would be tens of
// millions of launches, so the port's episodic policy search runs here.
//
// Per lane: reset (the arm at rest at q_start, the string hanging from the
// cup), n_stab steps holding q_start, the statistics cleared and the
// position penalty's pose set, T steps through the lane's setpoints (its
// four action channels drive joints 1 and 3: q, q, qd, qd), n_cool steps
// holding the last setpoint, then the score. One step: bic_arm (PD torque +
// J^T F of the string's reaction, forward dynamics, semi-implicit Euler),
// bic_string (Verlet, Jacobi distance sweeps, cup contact, the reaction),
// again both with this step's reaction when PPI_BIC_SAME_STEP, then
// bic_commit (the statistics, the violation latch). Those functions are
// the generated header "bic_body.h": the scalar program of
// ppi_tpu_torch/envs/ball_in_a_cup.py emitted as straight-line f32 C by
// ppi_tpu_torch/envs/physics/bic_kernel.py, every particle loop unrolled.
// This file is the hand-written skeleton around it.
//
// Layout: q_start (4,); act (T, 4, N); state (PPI_BIC_S, N), the final lane
// states; score (2, N): reward, success (0/1). Lane-major, so a warp's
// loads and stores are coalesced. Lanes >= n are not written. A NaN in a
// lane stays in that lane's registers.
//
// What bounds it on an H100: each lane is one long dependent chain of
// scalar f32 operations (some 20 thousand a step, 1,600 steps) on a state
// of ~100 floats held in registers, with four loads a step and no other
// memory traffic; so it is latency-bound, and at the canonical 128 lanes
// (4 warps on 132 SMs) it uses a sliver of the card. bic_rollout_warp.cu
// spreads a trajectory's string over a warp's lanes and is the route
// wherever the string fits a warp; this layout stays the reference it
// equals bit for bit, and the route for a longer string.
//
// The file also compiles as host C (no __CUDACC__): the lane loop then runs
// on the CPU through ppi_bic_host, which the CPU tests call to check the
// generated body before any GPU run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#define PPI_NEG_INF (-__int_as_float(0x7f800000))
#else
#include <math.h>
#define PPI_QUAL static inline
#define PPI_NEG_INF (-INFINITY)
#endif

#include "bic_body.h"

// Step clocks, for a study's build only (the header defines
// PPI_BIC_CLOCKS; the main path's never does): lane 0 of every warp adds
// the SM cycles of each call of a step to ppi_bic_clocks[k], read and
// zeroed by ppi_bic_clocks_take: 0 bic_arm and 1 bic_string of the first
// pass, 2 and 3 of the second (PPI_BIC_SAME_STEP), 4 bic_commit.
#define PPI_BIC_N_CLOCKS 5
#if defined(__CUDACC__) && defined(PPI_BIC_CLOCKS)
__device__ unsigned long long ppi_bic_clocks[PPI_BIC_N_CLOCKS];
#define PPI_CLOCK_START long long ppi_t0 = clock64()
#define PPI_CLOCK(i)                                                  \
  do {                                                                \
    if ((threadIdx.x & 31u) == 0u) {                                  \
      const long long ppi_t1 = clock64();                             \
      atomicAdd(&ppi_bic_clocks[i],                                   \
                (unsigned long long)(ppi_t1 - ppi_t0));               \
      ppi_t0 = ppi_t1;                                                \
    }                                                                 \
  } while (0)
#else
#define PPI_CLOCK_START
#define PPI_CLOCK(i) ((void)0)
#endif

// One control step of the lane state s toward (qdes, qddes), as
// BallInCupSim.step_soa composes it.
PPI_QUAL void ppi_bic_step(float* s, const float* qdes, const float* qddes) {
  float arm[8], str[PPI_BIC_NSTR];
  PPI_CLOCK_START;
  bic_arm(s, qdes, qddes, s + PPI_BIC_FORCE, arm);
  PPI_CLOCK(0);
  bic_string(s, arm, str);
  PPI_CLOCK(1);
#if PPI_BIC_SAME_STEP
  bic_arm(s, qdes, qddes, str + PPI_BIC_STR_REACTION, arm);
  PPI_CLOCK(2);
  bic_string(s, arm, str);
  PPI_CLOCK(3);
#endif
  bic_commit(s, arm, str);
  PPI_CLOCK(4);
}

// One trajectory: lane `lane` of n.
PPI_QUAL void ppi_bic_lane(int lane, int n, int horizon, int n_stab,
                           int n_cool, const float* q_start, const float* act,
                           float* state, float* score) {
  float s[PPI_BIC_S];
  float hold[4], still[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < 4; ++j) hold[j] = q_start[j];
  bic_reset(hold, s);
  s[PPI_BIC_MAX_POT] = PPI_NEG_INF;
  for (int k = 0; k < n_stab; ++k) ppi_bic_step(s, hold, still);
  // only the trajectory and the cool-down are scored
  s[PPI_BIC_MAX_POT] = PPI_NEG_INF;
  s[PPI_BIC_SUM_VEL] = 0.0f;
  s[PPI_BIC_SUM_POS] = 0.0f;
  s[PPI_BIC_SUM_BALL] = 0.0f;
  s[PPI_BIC_N_STEPS] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[PPI_BIC_Q0 + j] = s[PPI_BIC_Q + j];
  float qdes[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float qddes[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < horizon; ++t) {
    qdes[1] = act[(t * 4 + 0) * n + lane];
    qdes[3] = act[(t * 4 + 1) * n + lane];
    qddes[1] = act[(t * 4 + 2) * n + lane];
    qddes[3] = act[(t * 4 + 3) * n + lane];
    ppi_bic_step(s, qdes, qddes);
  }
  for (int k = 0; k < n_cool; ++k) ppi_bic_step(s, qdes, still);
  float sc[2];
  bic_score(s, sc);
#pragma unroll
  for (int k = 0; k < PPI_BIC_S; ++k) state[k * n + lane] = s[k];
  score[lane] = sc[0];
  score[n + lane] = sc[1];
}

#ifdef __CUDACC__

__global__ void ppi_bic_kernel(const float* __restrict__ q_start,
                               const float* __restrict__ act,
                               float* __restrict__ state,
                               float* __restrict__ score, int n, int horizon,
                               int n_stab, int n_cool) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  ppi_bic_lane(lane, n, horizon, n_stab, n_cool, q_start, act, state, score);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ppi_bic_launch(const float* q_start, const float* act,
                              float* state, float* score, int n, int horizon,
                              int n_stab, int n_cool, int block,
                              void* stream) {
  const int grid = (n + block - 1) / block;
  ppi_bic_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      q_start, act, state, score, n, horizon, n_stab, n_cool);
  return (int)cudaGetLastError();
}

#ifdef PPI_BIC_CLOCKS
// Copies the step clocks to `out` (PPI_BIC_N_CLOCKS counts) and zeroes
// them.
extern "C" int ppi_bic_clocks_take(unsigned long long* out) {
  const size_t bytes = sizeof(unsigned long long) * PPI_BIC_N_CLOCKS;
  cudaError_t e = cudaMemcpyFromSymbol(out, ppi_bic_clocks, bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[PPI_BIC_N_CLOCKS] = {0};
  return (int)cudaMemcpyToSymbol(ppi_bic_clocks, zero, bytes);
}
#endif

#else

int ppi_bic_host(const float* q_start, const float* act, float* state,
                 float* score, int n, int horizon, int n_stab, int n_cool) {
  for (int lane = 0; lane < n; ++lane)
    ppi_bic_lane(lane, n, horizon, n_stab, n_cool, q_start, act, state,
                 score);
  return 0;
}

#endif
