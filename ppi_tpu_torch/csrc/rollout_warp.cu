// Whole-rollout kernel, warp layout: N rollouts of H control steps of
// contact physics, one rollout per warp.
//
// Replaces, for the bodies whose lane layout one thread's dependent chain
// bounds (door-v0-hand, door-v0-adroit, relocate-v0-adroit,
// hammer-v0-adroit, hammer-v0-hand, relocate-v0-hand, pen-v0-adroit,
// fetch-pick), the Pallas megakernel
// ppi_tpu/envs/physics/pallas_rollout.py (make_pallas_rollout, pallas_call
// at line 190), as rollout.cu does with one rollout a thread for the
// others. The contract is rollout.cu's: the same arguments and lane-major
// layout (q0, qd0 (nq, N); actions (H, d_a, N); rewards (H, N); qf, qdf
// (nq, N); dyn (3,) and consts (PPI_NCONSTS,), either null when the env
// has none), the env's optional projection (PPI_PROJECT), the sticky NaN
// latch, rollouts >= n never written, H a run-time argument.
//
// Per substep, in the rollout's shared memory (q, qd, tau, the action, the
// augmented matrix and the values the stages hand to each other):
//   1. env_assemble on lane 0: FK and velocity kinematics down to where the
//      body tree branches into the digits, the passive torques (straight-
//      line code generated from the scalar program, as rollout.cu's
//      env_substep);
//   2. env_stages: generated template stages, each ending in __syncwarp:
//      the digits' kinematics one depth a stage, then the world inertias,
//      Jacobian columns and contact points, then I_w jw, the bias wrenches
//      and the contact pairs' forces, then each sphere's contact force.
//      Instances of one computation share one function and run on the
//      lanes side by side, lane i taking instances i, i + 32, ...;
//   3. the mass matrix and the right-hand side: every lane sums entries of
//      M from the generated table ppi_mass_ops (the same instructions on
//      each lane, other addresses), lane j the right-hand side's entry j;
//      each entry's terms in the scalar program's order;
//   4. Gauss-Jordan without pivoting, lane c holding column c of the
//      augmented matrix in registers: step k broadcasts the pivot and
//      column k's factors from lane k with __shfl_sync, and every lane
//      updates its column; the leading steps whose pivot the scalar
//      program folds to a constant (PPI_SOLVE_FROM of them) take their
//      folded operands from generated tables;
//   5. env_integrate on lane 0: the semi-implicit Euler step.
// Every value is computed by the same operations on the same operands as
// in the lane layout, and nvcc runs with -fmad=false, so every value is
// the lane layout's, bit for bit.
//
// The generated header "env_warp.h" (ppi_tpu_torch/envs/physics/
// rollout_kernel.py, layout "warp"; warp_layout.py) defines env_torque,
// env_assemble, env_stages, env_integrate, env_reward, env_project where
// PPI_PROJECT is defined, the PPI_* sizes and shared-memory offsets, and
// the tables. The tables are read-only global memory: a warp's lanes read
// different rows of them at once, which the constant cache would
// serialize; every SM keeps them in L1. Staging the skeleton's own tables
// once a block in shared memory (bulk copies on an mbarrier) was measured
// on an H100 and was no faster than those L1 hits (PERF.md section 6).
//
// What bounds it on an H100: latency. One rollout is one warp's chain of
// dependent stages; at the canonical N=64-256 each warp has an SM to
// itself and its time is lane 0's straight-line stage, the stages' loads
// and __syncwarps, the tables and the solve (PERF.md section 5 has the SM
// cycles of each), far above the operation bound. A block holds `warps`
// rollouts (a launch argument; 1 measured best, or within the run-to-run
// spread of the best).
//
// The file also compiles as host C (no __CUDACC__): each cooperative stage
// then runs lane by lane, lane 0 to 31, in the same per-element order, so
// the CPU tests check the generated stages and tables before any GPU run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#define PPI_NAN __int_as_float(0x7fc00000)
#define PPI_TABLE __device__ const
#define PPI_EACH_LANE(l) \
  for (int l = (int)(threadIdx.x & 31u), l##_once = 0; l##_once < 1; \
       ++l##_once)
#define PPI_LANE0 if ((threadIdx.x & 31u) == 0u)
#define PPI_SYNC() __syncwarp()
#else
#include <math.h>
#include <stdlib.h>
#define PPI_QUAL static inline
#define PPI_NAN NAN
#define PPI_TABLE static const
#define PPI_EACH_LANE(l) for (int l = 0; l < PPI_LANES; ++l)
#define PPI_LANE0
#define PPI_SYNC() ((void)0)
#endif

#define PPI_LANES 32

// one constant of the rollout's shared memory: offset, f32 value
typedef struct {
  int at;
  float value;
} PpiConstSlot;

// one term of a mass-matrix entry (flags: PPI_START, PPI_END, PPI_CONST,
// PPI_JW); offsets are into the rollout's shared memory, dst and dst_t
// into the augmented matrix
typedef struct {
  float init;   // the entry's value before its first op (PPI_START)
  float m;      // the body's mass
  float c;      // a folded constant term (PPI_CONST)
  short a, b;   // jv[b][k], jv[b][l]
  short w, e;   // jw[b][k], I_w jw[b][l] (PPI_JW)
  short dst, dst_t, md;  // cells (k, l), (l, k); k for the diagonal, or -1
  short flags;
} PpiMassOp;
#define PPI_START 1
#define PPI_END 2
#define PPI_CONST 4
#define PPI_JW 8

// the right-hand side's entry j: its first operand, joint j's axis and
// origin, hinge or slide, and its body and contact terms
typedef struct {
  short rhs0, axis, origin, hinge, body0, nbody, contact0, ncontact;
} PpiRhsJoint;
typedef struct {
  short jv, f, w, nb, jw;  // jv[b][j], f_bias[b], jw[b][j], n_bias[b]
} PpiRhsBody;
typedef struct {
  short p, f;  // contact point and force
} PpiRhsContact;
// one op of the solve's constant head, on lane c's column (kind: PPI_HEAD_*)
typedef struct {
  float v;
  int kind;
} PpiHeadOp;
#define PPI_HEAD_SYM 0
#define PPI_HEAD_LIT 1
#define PPI_HEAD_CONST 2

#include "env_warp.h"

#define PPI_W (PPI_NQ + 1)  // row stride of the augmented matrix
// the first step of the solve whose pivot is not a folded constant; the
// steps before it are the constant head (a header that defines it defines
// the tables ppi_head_rows and ppi_head_ops)
#ifndef PPI_SOLVE_FROM
#define PPI_SOLVE_FROM 0
#endif

// Stage clocks, for a study's build only (the header defines
// PPI_STAGE_CLOCKS; the main path's never does): lane 0 of every rollout
// adds the SM cycles from one stage boundary to the next to
// ppi_stage_clocks[stage], read and zeroed by ppi_stage_clocks_take.
// Stages: 0 action and torque, 1 env_assemble, 2 env_stage_1 and
// env_stage_2, 3 the table assembly, 4 the solve, 5 env_integrate, 6
// projection, latch and reward.
#define PPI_N_STAGES 7
#if defined(__CUDACC__) && defined(PPI_STAGE_CLOCKS)
__device__ unsigned long long ppi_stage_clocks[PPI_N_STAGES];
#define PPI_CLOCK_START long long ppi_t0 = clock64()
#define PPI_STAGE(i)                                                   \
  do {                                                                 \
    if ((threadIdx.x & 31u) == 0u) {                                   \
      const long long ppi_t1 = clock64();                              \
      atomicAdd(&ppi_stage_clocks[i],                                  \
                (unsigned long long)(ppi_t1 - ppi_t0));                \
      ppi_t0 = ppi_t1;                                                 \
    }                                                                  \
  } while (0)
#else
#define PPI_CLOCK_START
#define PPI_STAGE(i) ((void)0)
#endif

PPI_QUAL float ppi_dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The constant cells of the augmented matrix (exact zeros, folded slide
// entries): rewritten every substep, as the solve overwrites them.
PPI_QUAL void ppi_fill_const_cells(float* aug, int lane) {
  for (int i = lane; i < PPI_N_CONST_CELLS; i += PPI_LANES)
    aug[ppi_const_cells[i].at] = ppi_const_cells[i].value;
}

// Lane `lane`'s entries of the mass matrix, one op a step.
PPI_QUAL void ppi_mass(float* sh, int lane) {
  float acc = 0.0f;
  for (int s = 0; s < PPI_MASS_STEPS; ++s) {
    const PpiMassOp o = ppi_mass_ops[s * PPI_LANES + lane];
    if (o.flags & PPI_START) acc = o.init;
    const float d = ppi_dot(sh + o.a, sh + o.b);
    float t = (o.flags & PPI_CONST) ? o.c : o.m * d;
    if (o.flags & PPI_JW) t = t + ppi_dot(sh + o.w, sh + o.e);
    acc = acc + t;
    if (o.flags & PPI_END) {
      sh[PPI_SH_AUG + o.dst] = acc;
      sh[PPI_SH_AUG + o.dst_t] = acc;
      if (o.md >= 0) sh[PPI_SH_MDIAG + o.md] = acc;
    }
  }
}

// Lane j's entry of the right-hand side (column nq of the augmented
// matrix): body terms, then contact terms through joint j's column.
PPI_QUAL void ppi_rhs(float* sh, int lane) {
  if (lane >= PPI_NQ) return;
  const PpiRhsJoint J = ppi_rhs_joint[lane];
  float acc = sh[J.rhs0];
  for (int i = 0; i < J.nbody; ++i) {
    const PpiRhsBody o = ppi_rhs_body[J.body0 + i];
    acc = acc + ppi_dot(sh + o.jv, sh + o.f);
    if (o.jw) acc = acc - ppi_dot(sh + o.w, sh + o.nb);
  }
  const float* ax = sh + J.axis;
  const float* org = sh + J.origin;
  for (int i = 0; i < J.ncontact; ++i) {
    const PpiRhsContact o = ppi_rhs_contact[J.contact0 + i];
    const float* p = sh + o.p;
    float col[3];
    if (J.hinge) {
      const float r0 = p[0] - org[0], r1 = p[1] - org[1], r2 = p[2] - org[2];
      col[0] = ax[1] * r2 - ax[2] * r1;
      col[1] = ax[2] * r0 - ax[0] * r2;
      col[2] = ax[0] * r1 - ax[1] * r0;
    } else {
      col[0] = ax[0];
      col[1] = ax[1];
      col[2] = ax[2];
    }
    acc = acc + ppi_dot(col, sh + o.f);
  }
  sh[PPI_SH_AUG + lane * PPI_W + PPI_NQ] = acc;
}

// The solve: Gauss-Jordan without pivoting (solve_pd_scalar's operations,
// operand for operand), lane c holding column c of the augmented matrix in
// registers. Step k broadcasts the pivot aug[k][k] and column k's factors
// from lane k (__shfl_sync) and every lane updates its column: row k
// scaled, every other row minus its factor times it. Every lane runs every
// step (columns <= k are dead, and lanes past nq hold no column: their
// values are never read), so the warp never diverges. Lane nq ends with
// the solution and writes it back to column nq.
//
// The constant head, steps 0 .. PPI_SOLVE_FROM - 1 (pivots that the scalar
// program folds in float64): each lane reads its column's op of the step
// from the generated tables, so that a folded reciprocal, row entry,
// product or cell is the program's f32 literal; a constant cell's register
// holds that literal, so a broadcast factor is the program's operand too.
// Both sides of every select are computed, so the warp never diverges.
#ifdef __CUDACC__
PPI_QUAL void ppi_solve(float* aug) {
  const int c = (int)(threadIdx.x & 31u);
  const int cc = c <= PPI_NQ ? c : PPI_NQ;
  float col[PPI_NQ];
#pragma unroll
  for (int i = 0; i < PPI_NQ; ++i) col[i] = aug[i * PPI_W + cc];
#if PPI_SOLVE_FROM > 0
#pragma unroll
  for (int k = 0; k < PPI_SOLVE_FROM; ++k) {
    const PpiHeadOp r = ppi_head_rows[k * PPI_W + cc];
    const float rk = r.kind == PPI_HEAD_SYM ? col[k] * r.v : r.v;
#pragma unroll
    for (int i = 0; i < PPI_NQ; ++i) {
      if (i == k) continue;
      const float f = __shfl_sync(0xffffffffu, col[i], k);
      const PpiHeadOp o = ppi_head_ops[(k * PPI_NQ + i) * PPI_W + cc];
      const float d = o.kind == PPI_HEAD_SYM ? col[i] - f * rk : col[i] - o.v;
      col[i] = o.kind == PPI_HEAD_CONST ? o.v : d;
    }
    col[k] = rk;
  }
#endif
#pragma unroll
  for (int k = PPI_SOLVE_FROM; k < PPI_NQ; ++k) {
    const float inv_p = 1.0f / __shfl_sync(0xffffffffu, col[k], k);
    const float rk = col[k] * inv_p;
#pragma unroll
    for (int i = 0; i < PPI_NQ; ++i) {
      if (i == k) continue;
      const float f = __shfl_sync(0xffffffffu, col[i], k);
      col[i] = col[i] - f * rk;
    }
    col[k] = rk;
  }
  if (c == PPI_NQ) {
#pragma unroll
    for (int i = 0; i < PPI_NQ; ++i) aug[i * PPI_W + PPI_NQ] = col[i];
  }
  __syncwarp();
}
#else
// The same steps lane by lane: each step's broadcasts are read from lane
// k's column before any lane updates its own.
PPI_QUAL void ppi_solve(float* aug) {
  float cols[PPI_NQ + 1][PPI_NQ], f[PPI_NQ];
  for (int c = 0; c <= PPI_NQ; ++c)
    for (int i = 0; i < PPI_NQ; ++i) cols[c][i] = aug[i * PPI_W + c];
#if PPI_SOLVE_FROM > 0
  for (int k = 0; k < PPI_SOLVE_FROM; ++k) {
    for (int i = 0; i < PPI_NQ; ++i) f[i] = cols[k][i];
    for (int c = 0; c <= PPI_NQ; ++c) {
      const PpiHeadOp r = ppi_head_rows[k * PPI_W + c];
      const float rk = r.kind == PPI_HEAD_SYM ? cols[c][k] * r.v : r.v;
      for (int i = 0; i < PPI_NQ; ++i) {
        if (i == k) continue;
        const PpiHeadOp o = ppi_head_ops[(k * PPI_NQ + i) * PPI_W + c];
        if (o.kind == PPI_HEAD_CONST)
          cols[c][i] = o.v;
        else if (o.kind == PPI_HEAD_LIT)
          cols[c][i] = cols[c][i] - o.v;
        else
          cols[c][i] = cols[c][i] - f[i] * rk;
      }
      cols[c][k] = rk;
    }
  }
#endif
  for (int k = PPI_SOLVE_FROM; k < PPI_NQ; ++k) {
    const float inv_p = 1.0f / cols[k][k];
    for (int i = 0; i < PPI_NQ; ++i) f[i] = cols[k][i];
    for (int c = 0; c <= PPI_NQ; ++c) {
      const float rk = cols[c][k] * inv_p;
      for (int i = 0; i < PPI_NQ; ++i) {
        if (i == k) continue;
        cols[c][i] = cols[c][i] - f[i] * rk;
      }
      cols[c][k] = rk;
    }
  }
  for (int i = 0; i < PPI_NQ; ++i) aug[i * PPI_W + PPI_NQ] = cols[PPI_NQ][i];
}
#endif

// Rollout r: horizon control steps from (q0, qd0)[r], by the whole warp;
// `sh` is its PPI_SH_SIZE floats of shared memory.
PPI_QUAL void ppi_rollout_warp(int r, int n, int horizon, const float* q0,
                               const float* qd0, const float* act,
                               const float* dyn, const float* consts,
                               float* rew, float* qf, float* qdf,
                               float* sh) {
  float* q = sh + PPI_SH_Q;
  float* qd = sh + PPI_SH_QD;
  float* a = sh + PPI_SH_ACT;
  float* aug = sh + PPI_SH_AUG;
  PPI_EACH_LANE(l) {
    for (int j = l; j < PPI_NQ; j += PPI_LANES) {
      q[j] = q0[j * n + r];
      qd[j] = qd0[j * n + r];
    }
    for (int i = l; i < PPI_N_CONST_SLOTS; i += PPI_LANES)
      sh[ppi_const_slots[i].at] = ppi_const_slots[i].value;
  }
  PPI_SYNC();
  int bad = 0;  // lane 0's sticky NaN latch
  PPI_CLOCK_START;
  for (int t = 0; t < horizon; ++t) {
    PPI_EACH_LANE(l) {
      for (int k = l; k < PPI_DA; k += PPI_LANES)
        a[k] = act[(t * PPI_DA + k) * n + r];
    }
    PPI_SYNC();
    PPI_LANE0 {
      env_torque(q, qd, a, dyn, sh + PPI_SH_TAU);
#ifdef PPI_PROJECT
      for (int j = 0; j < PPI_NQ; ++j) sh[PPI_SH_QPREV + j] = q[j];
#endif
    }
    PPI_STAGE(0);
    for (int s = 0; s < PPI_SUBSTEPS; ++s) {
      PPI_LANE0 env_assemble(q, qd, sh + PPI_SH_TAU, dyn, sh);
      PPI_SYNC();
      PPI_STAGE(1);
      env_stages(sh);
      PPI_STAGE(2);
      PPI_EACH_LANE(l) {
        ppi_fill_const_cells(aug, l);
        ppi_mass(sh, l);
        ppi_rhs(sh, l);
      }
      PPI_SYNC();
      PPI_STAGE(3);
      ppi_solve(aug);
      PPI_STAGE(4);
      PPI_LANE0 env_integrate(q, qd, sh);
      PPI_STAGE(5);
    }
    PPI_LANE0 {
#ifdef PPI_PROJECT
      env_project(sh + PPI_SH_QPREV, q, qd, dyn);
#endif
      // from a rollout's first non-finite state on, its reward is NaN
      for (int j = 0; j < PPI_NQ; ++j) {
        if (ppi_isfinite(q[j]) == 0.0f || ppi_isfinite(qd[j]) == 0.0f)
          bad = 1;
      }
      const float rw = env_reward(q, qd, a, dyn, consts);
      rew[t * n + r] = bad ? PPI_NAN : rw;
    }
    PPI_SYNC();  // the next step's action overwrites this one's
    PPI_STAGE(6);
  }
  PPI_EACH_LANE(l) {
    for (int j = l; j < PPI_NQ; j += PPI_LANES) {
      qf[j * n + r] = q[j];
      qdf[j * n + r] = qd[j];
    }
  }
}

#ifdef __CUDACC__

__global__ void ppi_rollout_warp_kernel(const float* __restrict__ q0,
                                        const float* __restrict__ qd0,
                                        const float* __restrict__ act,
                                        const float* __restrict__ dyn,
                                        const float* __restrict__ consts,
                                        float* __restrict__ rew,
                                        float* __restrict__ qf,
                                        float* __restrict__ qdf, int n,
                                        int horizon) {
  extern __shared__ float ppi_smem[];
  const int w = (int)(threadIdx.x >> 5);
  const int r = (int)blockIdx.x * (int)(blockDim.x >> 5) + w;
  if (r >= n) return;  // the whole warp: rollouts past n are never written
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (dyn != nullptr) {
    d[0] = dyn[0];
    d[1] = dyn[1];
    d[2] = dyn[2];
  }
  float c[PPI_NCONSTS > 0 ? PPI_NCONSTS : 1] = {0.0f};
  for (int k = 0; k < PPI_NCONSTS; ++k) c[k] = consts[k];
  ppi_rollout_warp(r, n, horizon, q0, qd0, act, d, c, rew, qf, qdf,
                   ppi_smem + w * PPI_SH_SIZE);
}

// Launches on `stream` with `warps` rollouts a block; returns the first
// CUDA error (0 on success).
extern "C" int ppi_rollout_warp_launch(const float* q0, const float* qd0,
                                       const float* act, const float* dyn,
                                       const float* consts, float* rew,
                                       float* qf, float* qdf, int n,
                                       int horizon, int warps,
                                       void* stream) {
  const int bytes = warps * PPI_SH_SIZE * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ppi_rollout_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + warps - 1) / warps;
  ppi_rollout_warp_kernel<<<grid, 32 * warps, bytes, (cudaStream_t)stream>>>(
      q0, qd0, act, dyn, consts, rew, qf, qdf, n, horizon);
  return (int)cudaGetLastError();
}

#ifdef PPI_STAGE_CLOCKS
// Copies the stage clocks to `out` (PPI_N_STAGES counts) and zeroes them.
extern "C" int ppi_stage_clocks_take(unsigned long long* out) {
  const size_t bytes = sizeof(unsigned long long) * PPI_N_STAGES;
  cudaError_t e = cudaMemcpyFromSymbol(out, ppi_stage_clocks, bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[PPI_N_STAGES] = {0};
  return (int)cudaMemcpyToSymbol(ppi_stage_clocks, zero, bytes);
}
#endif

#else

int ppi_rollout_warp_host(const float* q0, const float* qd0, const float* act,
                          const float* dyn, const float* consts, float* rew,
                          float* qf, float* qdf, int n, int horizon) {
  float* sh = (float*)malloc(sizeof(float) * PPI_SH_SIZE);
  if (sh == NULL) return 1;
  for (int r = 0; r < n; ++r)
    ppi_rollout_warp(r, n, horizon, q0, qd0, act, dyn, consts, rew, qf, qdf,
                     sh);
  free(sh);
  return 0;
}

// The cooperative solve alone on a row-major nq x (nq + 1) augmented
// matrix, in place: column nq becomes the solution.
int ppi_warp_solve_host(float* aug) {
  ppi_solve(aug);
  return 0;
}

#endif
