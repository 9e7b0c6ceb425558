// Whole-rollout kernel, split layout: N rollouts of H control steps of
// contact physics, each rollout's program spread over the PPI_K warps of a
// block, each warp carrying the block's 32 rollouts.
//
// Replaces, for door-v0, relocate-v0, cheetah, walker2d, walker~walk,
// humanoid-standup and pen-v0-hand, the Pallas megakernel
// ppi_tpu/envs/physics/pallas_rollout.py (make_pallas_rollout, pallas_call
// at line 190; door-v0's body also runs under sharded_pallas_mpc_objective,
// shard_map at line 322), as rollout.cu does with one rollout a thread for
// the other lane bodies (hammer-v0 has a split body too, slower on the
// card than its lane body, which it keeps). The contract
// is rollout.cu's: the same arguments and lane-major layout (q0, qd0 (nq,
// N); actions (H, d_a, N); rewards (H, N); qf, qdf (nq, N); dyn (3,) and
// consts (PPI_NCONSTS,), either null when the env has none), the env's
// optional projection (PPI_PROJECT), the sticky NaN latch, rollouts >= n
// never written, H a run-time argument.
//
// What bounds it on an H100: the lane layout runs a rollout's whole
// straight-line substep (4,199 f32 ops for door-v0, 2,906 for hammer-v0,
// 7,003 and 7,028 for relocate-v0 and cheetah, with a longest dependent
// chain under 90 for the first two, of weight 173 and 150 for the last
// two) on one thread, so one warp scheduler of the SM issues it alone: at
// the canonical N=64 two warps on one SM of 132, 2.3-2.6 cycles an op,
// while three of the SM's four schedulers idle. Not the dependences but
// one warp's issue of a long straight line sets the pace.
//
// The design: a block is one group of 32 rollouts (lane l holds rollout
// 32 * blockIdx.x + l) and PPI_K warps (3 for door-v0 and cheetah, 4 for
// relocate-v0). The generator (ppi_tpu_torch/envs/physics/split_layout.py)
// list-schedules the lane layout's own emitted substep and reward into
// PPI_K streams and phases, or (the routed bodies but door-v0) partitions the
// substep by the body tree, one warp for each root chain and each subtree
// hanging off it, so that only frames, the terms of the shared sums and
// the accelerations cross warps (3 phases a substep for cheetah, 4 for
// relocate-v0, against 12 in relocate-v0's list schedule):
// warp w runs stream w, inside one warp-uniform if/else chain, so no warp
// diverges; a barrier of the block separates two phases. A value that
// another stream reads goes through the group's shared memory at
// sh[slot * 32 + lane] (lane-minor: no bank conflicts), stored by its
// producer and loaded after the next barrier; a slot is reused only in a
// phase after its last load. q and qd live in slots of their own across
// substeps and steps; every warp runs the torque itself (tau and the
// action stay in its registers); the reward ends on warp 0, which holds
// the sticky NaN latch and writes the rewards and the final state. The
// reward's last phase needs no barrier: its slots are not the substep's.
// Every value is computed by the lane layout's expression on the same
// operands, and nvcc runs with -fmad=false, so every value is the lane
// layout's, bit for bit. A split pays only where its phases are few and
// its exchanges light: each phase ends in a barrier, and each value
// another warp reads is a shared store, a barrier and a shared load on a
// dependent chain; so the generator keeps chains of single-reader ops on
// one warp, leaves a narrow stretch (the solve) to one warp, and
// charges every barrier and every load and store of every warp
// (PERF.md section 6).
//
// A lane past n (the last group's ragged edge) computes rollout n - 1's
// values from clamped loads and reaches every barrier; it stores nothing
// to global memory.
//
// The generated header "env_split.h" (ppi_tpu_torch/envs/physics/
// rollout_kernel.py, layout "split") defines env_torque, env_project where
// PPI_PROJECT is defined, the phase functions, the sequencers env_sub and
// env_rew (device) or the tables ppi_env_sub_fns and ppi_env_rew_fns
// (host), and the PPI_* sizes.
//
// The file also compiles as host C (no __CUDACC__): each phase then runs
// stream by stream, and each stream's share lane by lane
// (ppi_each_stream), so the CPU tests check the generated schedule before
// any GPU run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#define PPI_NAN __int_as_float(0x7fc00000)
#else
#include <math.h>
#include <stddef.h>
#include <stdlib.h>
#define PPI_QUAL static inline
#define PPI_NAN NAN
#endif

#define PPI_LANES 32
// one stream's share of one phase, for one lane: sh is the lane's first
// slot (a slot's floats are PPI_LANES apart), reg its carried registers
#define PPI_PHASE_ARGS                                                   \
  float *sh, float *reg, const float *tau, const float *act,             \
      const float *dyn, const float *consts
#define PPI_PHASE_CALL sh, reg, tau, act, dyn, consts
#define PPI_SEQ_ARGS                                                     \
  float *sh, const float *tau, const float *act, const float *dyn,       \
      const float *consts

#ifdef __CUDACC__
// the barrier after phase i (PPI_BARRIER) or the end of a phase that needs
// none (PPI_MARK); a study's build times them (PPI_PHASE_CLOCKS)
PPI_QUAL void ppi_barrier(int i);
PPI_QUAL void ppi_mark(int i);
#define PPI_BARRIER(i) ppi_barrier(i)
#define PPI_MARK(i) ppi_mark(i)
#else
typedef void (*PpiPhaseFn)(PPI_PHASE_ARGS);
#endif

#include "env_split.h"

#define PPI_SH(slot) ((slot) * PPI_LANES)

#ifdef __CUDACC__

// Phase clocks, for a study's build only (the header defines
// PPI_PHASE_CLOCKS; the main path's never does): lane 0 of every warp adds
// to ppi_phase_clocks[i][w] the SM cycles from the end of the previous
// phase to its arrival at barrier i ([0], its work) and to its leaving it
// ([1], work and wait), read and zeroed by ppi_phase_clocks_take. Ids:
// the substep's phases, the reward's, then the torque (with the previous
// step's latch).
#define PPI_CLOCK_TORQUE (PPI_SUB_PHASES + PPI_REW_PHASES)
#define PPI_CLOCK_IDS (PPI_CLOCK_TORQUE + 1)
#ifdef PPI_PHASE_CLOCKS
__device__ unsigned long long ppi_phase_clocks[PPI_CLOCK_IDS][PPI_K][2];
__shared__ long long ppi_clock_t0[PPI_K];
PPI_QUAL void ppi_clock(int i, bool sync) {
  const int w = (int)(threadIdx.x >> 5);
  const long long a = clock64();
  if (sync) __syncthreads();
  const long long b = sync ? clock64() : a;
  if ((threadIdx.x & 31u) == 0u) {
    atomicAdd(&ppi_phase_clocks[i][w][0],
              (unsigned long long)(a - ppi_clock_t0[w]));
    atomicAdd(&ppi_phase_clocks[i][w][1],
              (unsigned long long)(b - ppi_clock_t0[w]));
    ppi_clock_t0[w] = b;
  }
}
PPI_QUAL void ppi_barrier(int i) { ppi_clock(i, true); }
PPI_QUAL void ppi_mark(int i) { ppi_clock(i, false); }
#define PPI_CLOCK_START                                                  \
  if ((threadIdx.x & 31u) == 0u) ppi_clock_t0[threadIdx.x >> 5] = clock64()
#else
PPI_QUAL void ppi_barrier(int i) { __syncthreads(); }
PPI_QUAL void ppi_mark(int i) {}
#define PPI_CLOCK_START ((void)0)
#endif

__global__ void __launch_bounds__(PPI_K * PPI_LANES)
    ppi_rollout_split_kernel(const float* __restrict__ q0,
                             const float* __restrict__ qd0,
                             const float* __restrict__ act,
                             const float* __restrict__ dyn,
                             const float* __restrict__ consts,
                             float* __restrict__ rew, float* __restrict__ qf,
                             float* __restrict__ qdf, int n, int horizon) {
  extern __shared__ float ppi_smem[];
  const int w = (int)(threadIdx.x >> 5);
  const int r = (int)blockIdx.x * PPI_LANES + (int)(threadIdx.x & 31u);
  const int rc = r < n ? r : n - 1;  // clamped: a lane past n still syncs
  float* sh = ppi_smem + (threadIdx.x & 31u);
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (dyn != nullptr) {
    d[0] = dyn[0];
    d[1] = dyn[1];
    d[2] = dyn[2];
  }
  float c[PPI_NCONSTS > 0 ? PPI_NCONSTS : 1] = {0.0f};
  for (int k = 0; k < PPI_NCONSTS; ++k) c[k] = consts[k];
  if (w == 0) {
    for (int j = 0; j < PPI_NQ; ++j) {
      sh[PPI_SH(PPI_SLOT_Q + j)] = q0[j * n + rc];
      sh[PPI_SH(PPI_SLOT_QD + j)] = qd0[j * n + rc];
    }
  }
  __syncthreads();
  PPI_CLOCK_START;
  int bad = 0;  // warp 0's sticky NaN latch
  for (int t = 0; t < horizon; ++t) {
    float a[PPI_DA], q[PPI_NQ], qd[PPI_NQ], tau[PPI_NQ];
    for (int k = 0; k < PPI_DA; ++k) a[k] = act[(t * PPI_DA + k) * n + rc];
    for (int j = 0; j < PPI_NQ; ++j) {
      q[j] = sh[PPI_SH(PPI_SLOT_Q + j)];
      qd[j] = sh[PPI_SH(PPI_SLOT_QD + j)];
    }
    env_torque(q, qd, a, d, tau);
    PPI_MARK(PPI_CLOCK_TORQUE);
    for (int s = 0; s < PPI_SUBSTEPS; ++s) env_sub(w, sh, tau, a, d, c);
#ifdef PPI_PROJECT
    if (w == 0) {  // q still holds the step's initial coordinates
      float q2[PPI_NQ], qd2[PPI_NQ];
      for (int j = 0; j < PPI_NQ; ++j) {
        q2[j] = sh[PPI_SH(PPI_SLOT_Q + j)];
        qd2[j] = sh[PPI_SH(PPI_SLOT_QD + j)];
      }
      env_project(q, q2, qd2, d);
      for (int j = 0; j < PPI_NQ; ++j) {
        sh[PPI_SH(PPI_SLOT_Q + j)] = q2[j];
        sh[PPI_SH(PPI_SLOT_QD + j)] = qd2[j];
      }
    }
    __syncthreads();
#endif
    env_rew(w, sh, tau, a, d, c);
    if (w == 0) {
      // from a rollout's first non-finite state on, its reward is NaN
      for (int j = 0; j < PPI_NQ; ++j) {
        if (ppi_isfinite(sh[PPI_SH(PPI_SLOT_Q + j)]) == 0.0f ||
            ppi_isfinite(sh[PPI_SH(PPI_SLOT_QD + j)]) == 0.0f)
          bad = 1;
      }
      if (r < n) rew[t * n + r] = bad ? PPI_NAN : sh[PPI_SH(PPI_SLOT_R)];
    }
  }
  if (w == 0 && r < n) {
    for (int j = 0; j < PPI_NQ; ++j) {
      qf[j * n + r] = sh[PPI_SH(PPI_SLOT_Q + j)];
      qdf[j * n + r] = sh[PPI_SH(PPI_SLOT_QD + j)];
    }
  }
}

// Launches on `stream`, one block of PPI_K warps a group of 32 rollouts;
// returns the first CUDA error (0 on success).
extern "C" int ppi_rollout_split_launch(const float* q0, const float* qd0,
                                        const float* act, const float* dyn,
                                        const float* consts, float* rew,
                                        float* qf, float* qdf, int n,
                                        int horizon, void* stream) {
  const int bytes = PPI_SLOTS * PPI_LANES * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ppi_rollout_split_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n + PPI_LANES - 1) / PPI_LANES;
  ppi_rollout_split_kernel<<<grid, PPI_K * PPI_LANES, bytes,
                             (cudaStream_t)stream>>>(
      q0, qd0, act, dyn, consts, rew, qf, qdf, n, horizon);
  return (int)cudaGetLastError();
}

// Blocks of the kernel an SM holds at once (its registers and shared
// memory decide), into *blocks.
extern "C" int ppi_rollout_split_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ppi_rollout_split_kernel, PPI_K * PPI_LANES,
      PPI_SLOTS * PPI_LANES * sizeof(float));
}

#ifdef PPI_PHASE_CLOCKS
// Copies the phase clocks to `out` (PPI_CLOCK_IDS x PPI_K x 2 counts) and
// zeroes them.
extern "C" int ppi_phase_clocks_take(unsigned long long* out) {
  const size_t bytes = sizeof(ppi_phase_clocks);
  cudaError_t e = cudaMemcpyFromSymbol(out, ppi_phase_clocks, bytes);
  if (e != cudaSuccess) return (int)e;
  static unsigned long long zero[PPI_CLOCK_IDS][PPI_K][2];
  return (int)cudaMemcpyToSymbol(ppi_phase_clocks, zero, bytes);
}
#endif

#else

// One phase of a program: each stream in order, each stream lane by lane
// (the group's 32 lanes; a slot's floats are PPI_LANES apart).
#define PPI_REG_SIZE (PPI_REGS > 0 ? PPI_REGS : 1)
static void ppi_each_stream(const PpiPhaseFn* fns, float* sh, float* reg,
                            const float* tau, const float* act,
                            const float* dyn, const float* consts) {
  for (int w = 0; w < PPI_K; ++w) {
    if (fns[w] == NULL) continue;
    for (int l = 0; l < PPI_LANES; ++l)
      fns[w](sh + l, reg + (w * PPI_LANES + l) * PPI_REG_SIZE,
             tau + l * PPI_NQ, act + l * PPI_DA, dyn, consts);
  }
}

int ppi_rollout_split_host(const float* q0, const float* qd0, const float* act,
                           const float* dyn, const float* consts, float* rew,
                           float* qf, float* qdf, int n, int horizon) {
  float* sh = (float*)malloc(sizeof(float) * PPI_SLOTS * PPI_LANES);
  float* reg = (float*)malloc(sizeof(float) * PPI_K * PPI_LANES *
                              PPI_REG_SIZE);
  if (sh == NULL || reg == NULL) {
    free(sh);
    free(reg);
    return 1;
  }
  float a[PPI_LANES][PPI_DA > 0 ? PPI_DA : 1], tau[PPI_LANES][PPI_NQ];
  float q[PPI_LANES][PPI_NQ], qd[PPI_LANES][PPI_NQ];
  for (int g = 0; g < n; g += PPI_LANES) {
    int bad[PPI_LANES] = {0};
    for (int l = 0; l < PPI_LANES; ++l) {
      const int rc = g + l < n ? g + l : n - 1;
      for (int j = 0; j < PPI_NQ; ++j) {
        sh[PPI_SH(PPI_SLOT_Q + j) + l] = q0[j * n + rc];
        sh[PPI_SH(PPI_SLOT_QD + j) + l] = qd0[j * n + rc];
      }
    }
    for (int t = 0; t < horizon; ++t) {
      for (int l = 0; l < PPI_LANES; ++l) {
        const int rc = g + l < n ? g + l : n - 1;
        for (int k = 0; k < PPI_DA; ++k)
          a[l][k] = act[(t * PPI_DA + k) * n + rc];
        for (int j = 0; j < PPI_NQ; ++j) {
          q[l][j] = sh[PPI_SH(PPI_SLOT_Q + j) + l];
          qd[l][j] = sh[PPI_SH(PPI_SLOT_QD + j) + l];
        }
        env_torque(q[l], qd[l], a[l], dyn, tau[l]);
      }
      for (int s = 0; s < PPI_SUBSTEPS; ++s)
        for (int p = 0; p < PPI_SUB_PHASES; ++p)
          ppi_each_stream(ppi_env_sub_fns[p], sh, reg, tau[0], a[0], dyn,
                          consts);
#ifdef PPI_PROJECT
      for (int l = 0; l < PPI_LANES; ++l) {
        float q2[PPI_NQ], qd2[PPI_NQ];
        for (int j = 0; j < PPI_NQ; ++j) {
          q2[j] = sh[PPI_SH(PPI_SLOT_Q + j) + l];
          qd2[j] = sh[PPI_SH(PPI_SLOT_QD + j) + l];
        }
        env_project(q[l], q2, qd2, dyn);
        for (int j = 0; j < PPI_NQ; ++j) {
          sh[PPI_SH(PPI_SLOT_Q + j) + l] = q2[j];
          sh[PPI_SH(PPI_SLOT_QD + j) + l] = qd2[j];
        }
      }
#endif
      for (int p = 0; p < PPI_REW_PHASES; ++p)
        ppi_each_stream(ppi_env_rew_fns[p], sh, reg, tau[0], a[0], dyn,
                        consts);
      for (int l = 0; l < PPI_LANES && g + l < n; ++l) {
        for (int j = 0; j < PPI_NQ; ++j) {
          if (ppi_isfinite(sh[PPI_SH(PPI_SLOT_Q + j) + l]) == 0.0f ||
              ppi_isfinite(sh[PPI_SH(PPI_SLOT_QD + j) + l]) == 0.0f)
            bad[l] = 1;
        }
        rew[t * n + g + l] = bad[l] ? PPI_NAN : sh[PPI_SH(PPI_SLOT_R) + l];
      }
    }
    for (int l = 0; l < PPI_LANES && g + l < n; ++l) {
      for (int j = 0; j < PPI_NQ; ++j) {
        qf[j * n + g + l] = sh[PPI_SH(PPI_SLOT_Q + j) + l];
        qdf[j * n + g + l] = sh[PPI_SH(PPI_SLOT_QD + j) + l];
      }
    }
  }
  free(sh);
  free(reg);
  return 0;
}

#endif
