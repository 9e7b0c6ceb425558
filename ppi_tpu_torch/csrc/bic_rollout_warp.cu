// Ball-in-a-cup kernel, warp layout: N episodic trajectories of the
// ball-in-a-cup task, one warp a trajectory, the string's points and its
// Jacobi segments spread over the warp's lanes, all three phases in one
// launch.
//
// Replaces no Pallas kernel, as bic_rollout.cu, the one-thread layout it
// redesigns: the JAX package runs these trajectories as an XLA scan under
// jax.vmap (ppi_tpu/envs/episodic.py, BallInACup.evaluate, over
// BallInCupSim.execute_trajectory, ppi_tpu/envs/ball_in_a_cup.py:341).
// The contract is bic_rollout.cu's: q_start (4,); act (T, 4, N); state
// (PPI_BIC_S, N), the final lane states; score (2, N): reward, success
// (0/1); trajectories >= n never written; a NaN stays in its trajectory.
//
// Lane l owns point l of the string: lane 0 the anchor pinned to the cup,
// lanes 1..PPI_BIC_NP-1 the particles, the last of them the ball; each
// keeps its position, its previous position and its prediction, and
// segment l's constants (PpiPoint). Lanes past the string idle. A step,
// as BallInCupSim.step_soa composes it, with PPI_BIC_SAME_STEP twice:
//   1. the arm (PD torque + J^T F of the string's reaction, forward
//      dynamics, semi-implicit Euler) and the cup's frame at its new pose
//      (bicw_frame). What the two passes compute alike (the kinematics,
//      the mass matrix and its elimination, the bias, the PD torque:
//      all but what reads the reaction) runs once a step
//      (bicw_arm_shared), the rest each pass (bicw_arm_pass). Every lane
//      computes them on the same values (lane 0's part of the state, a,
//      is the same in every lane), as a warp issues one instruction for
//      all its lanes: none needs them sent;
//   2. each particle's Verlet prediction (bicw_predict), the anchor's the
//      cup's bottom;
//   3. PPI_BIC_SWEEPS Jacobi sweeps, a loop: lane l reads point l + 1's
//      prediction from its neighbour (__shfl_sync), computes segment l's
//      two corrections (bicw_segment; its divisions, as every division
//      of the header, through ppi_div, which takes a zero dividend past
//      the IEEE division's slow path), receives the correction of its
//      point from segment l - 1 and forms (pred + da) + db
//      (bicw_correct); the anchor stays pinned;
//   4. the ball against the cup on the ball's lane (bicw_contact); each
//      particle's term of the reaction (bicw_term), summed left to right
//      over the particles as the scalar program's _sum does (not a tree:
//      that would change the bits), and the reaction (bicw_reaction);
//   5. once a step, the statistics from the ball's position and its
//      previous one (bicw_stats, on the last frame's kinematics) and each
//      lane's particle copied.
// The functions are the generated header "bic_warp.h"
// (ppi_tpu_torch/envs/physics/bic_kernel.py, generate_warp_header), each
// running the scalar program's helpers of
// ppi_tpu_torch/envs/ball_in_a_cup.py, so every value is computed by the
// same f32 operations on the same operands as in the one-thread layout's
// body; nvcc runs with -fmad=false, so the two layouts agree bit for bit.
//
// What bounds it on an H100: latency. A trajectory is one warp's chain of
// dependent steps; the canonical 128 trajectories are 64 blocks of two
// warps, two an SM. The sweeps take most of a step (PERF.md section 5):
// each of a segment's nine divisions branches on its operands, and little
// of one overlaps the next; the arm's straight-line chain comes next. Far
// above the operation bound.
//
// The file also compiles as host C (no __CUDACC__): each lane's part then
// runs lane by lane, 0 to 31 (PPI_EACH_LANE), and an exchange reads the
// other lane's slot; a loop over the lanes reads only values that no lane
// writes in it, so the CPU tests run the warp's program before any GPU
// run.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PPI_QUAL __device__ __forceinline__
#define PPI_NEG_INF (-__int_as_float(0x7f800000))
#define PPI_TABLE __device__ const
// a thread holds its lane's point; the lane loop runs once, for it
#define PPI_SLOTS 1
#define PPI_EACH_LANE(l)                                              \
  for (int l = (int)(threadIdx.x & 31u), l##_once = 0; l##_once < 1;  \
       ++l##_once)
#define PPI_ME(p, l) ((p)[0])
#define PPI_OF(p, field, src) __shfl_sync(0xffffffffu, (p)[0].field, (src))
#else
#include <math.h>
#define PPI_QUAL static inline
#define PPI_NEG_INF (-INFINITY)
#define PPI_TABLE static const
#define PPI_SLOTS PPI_LANES
#define PPI_EACH_LANE(l) for (int l = 0; l < PPI_LANES; ++l)
#define PPI_ME(p, l) ((p)[l])
#define PPI_OF(p, field, src) ((p)[(src)].field)
#endif

#define PPI_LANES 32

#include "bic_warp.h"

#define PPI_BIC_PASSES (1 + PPI_BIC_SAME_STEP)
#define PPI_BIC_BALL (PPI_BIC_NP - 1)

// One lane's point of the string and segment l's constants.
typedef struct {
  float part[3], prev[3];  // the point's position, its previous position
  float pred[3];           // its prediction, corrected by each sweep
  float dadb[6];           // segment l's corrections of points l and l + 1
  float term[3];           // the particle's term of the reaction
  float k[3];              // segment l's (w_l, w_l+1, denom_l)
  float mass, drop;        // its mass, its drop in the hanging string
} PpiPoint;

// Step clocks, for a study's build only (the header defines
// PPI_BIC_CLOCKS; the main path's never does): lane 0 of every trajectory
// adds the SM cycles of each part of a step to ppi_bic_clocks[k], read and
// zeroed by ppi_bic_clocks_take: for each pass p (4p +) 0 the arm, 1 the
// cup's frame, 2 the prediction and the sweeps, 3 the contact and the
// reaction; 8 the statistics and the copies.
#define PPI_BIC_N_CLOCKS 9
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

// One control step toward (qdes, qddes), as BallInCupSim.step_soa
// composes it: lane 0's state a (PPI_BIC_A floats) and every lane's point.
PPI_QUAL void ppi_bic_step(PpiPoint* pts, float* a, const float* qdes,
                           const float* qddes) {
  float rin[3], arm[8], frame[9], reaction[3];
  float arm_sh[PPI_BIC_ARM_SH], frame_sh[PPI_BIC_FRAME_SH];
  PPI_CLOCK_START;
#pragma unroll
  for (int c = 0; c < 3; ++c) rin[c] = a[PPI_BIC_A_FORCE + c];
  // what both passes of the arm compute alike, once
  bicw_arm_shared(a, qdes, qddes, arm_sh);
  // the second pass runs the first's code: one copy of it
#pragma unroll 1
  for (int pass = 0; pass < PPI_BIC_PASSES; ++pass) {
    bicw_arm_pass(arm_sh, a, qdes, qddes, rin, arm);
    PPI_CLOCK(4 * pass);
    // the string's pass at the arm's new coordinates; the frame's
    // kinematics kept for the statistics
    bicw_frame(arm, frame, frame_sh);
    PPI_CLOCK(4 * pass + 1);
    PPI_EACH_LANE(l) {
      PpiPoint* me = &PPI_ME(pts, l);
      if (l == 0) {
        for (int c = 0; c < 3; ++c) me->pred[c] = frame[c];
      } else if (l < PPI_BIC_NP) {
        bicw_predict(me->part, me->prev, me->pred);
      }
    }
#pragma unroll 1
    for (int it = 0; it < PPI_BIC_SWEEPS; ++it) {
      PPI_EACH_LANE(l) {
        float b[3];
        for (int c = 0; c < 3; ++c)
          b[c] = PPI_OF(pts, pred[c], (l + 1) % PPI_LANES);
        PpiPoint* me = &PPI_ME(pts, l);
        if (l < PPI_BIC_BALL) bicw_segment(me->pred, b, me->k, me->dadb);
      }
      PPI_EACH_LANE(l) {
        float db[3];
        for (int c = 0; c < 3; ++c)
          db[c] = PPI_OF(pts, dadb[3 + c], (l + PPI_LANES - 1) % PPI_LANES);
        PpiPoint* me = &PPI_ME(pts, l);
        if (l >= 1 && l < PPI_BIC_BALL) {
          bicw_correct(me->pred, me->dadb, db, me->pred);
        } else if (l == PPI_BIC_BALL) {
          bicw_correct_ball(me->pred, db, me->pred);
        }
      }
    }
    PPI_CLOCK(4 * pass + 2);
    PPI_EACH_LANE(l) {
      PpiPoint* me = &PPI_ME(pts, l);
      if (l == PPI_BIC_BALL) bicw_contact(me->pred, frame, me->pred);
      if (l >= 1 && l < PPI_BIC_NP)
        bicw_term(me->pred, me->part, me->prev, &me->mass, me->term);
    }
    // summed left to right over the particles, as _sum
    float sums[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = PPI_OF(pts, term[c], 1);
#pragma unroll
      for (int i = 2; i < PPI_BIC_NP; ++i)
        acc = acc + PPI_OF(pts, term[c], i);
      sums[c] = acc;
    }
    bicw_reaction(sums, reaction);
    PPI_CLOCK(4 * pass + 3);
#pragma unroll
    for (int c = 0; c < 3; ++c) rin[c] = reaction[c];
  }
  float ball[3], ball_prev[3], stats[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ball[c] = PPI_OF(pts, pred[c], PPI_BIC_BALL);
    ball_prev[c] = PPI_OF(pts, part[c], PPI_BIC_BALL);
  }
  bicw_stats(frame_sh, arm, frame, a, ball, ball_prev, stats);
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = arm[j];
#pragma unroll
  for (int c = 0; c < 3; ++c) a[PPI_BIC_A_FORCE + c] = reaction[c];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[PPI_BIC_A_MAX_POT + k] = stats[k];
  PPI_EACH_LANE(l) {
    PpiPoint* me = &PPI_ME(pts, l);
    for (int c = 0; c < 3; ++c) {
      me->prev[c] = me->part[c];
      me->part[c] = me->pred[c];
    }
  }
  PPI_CLOCK(8);
}

// One trajectory: warp (or, on the host, lane loop) `r` of n.
PPI_QUAL void ppi_bic_trajectory(int r, int n, int horizon, int n_stab,
                                 int n_cool, const float* q_start,
                                 const float* act, float* state,
                                 float* score) {
  PpiPoint pts[PPI_SLOTS];
  float a[PPI_BIC_A], hold[4], still[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float rest[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float frame[9], frame_sh[PPI_BIC_FRAME_SH];
#pragma unroll
  for (int j = 0; j < 4; ++j) hold[j] = rest[j] = q_start[j];
  // at rest at q_start, the string hanging from the cup (reset_soa)
#pragma unroll
  for (int k = 0; k < PPI_BIC_A; ++k) a[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = hold[j];
    a[PPI_BIC_A_Q0 + j] = hold[j];
  }
  a[PPI_BIC_A_MAX_POT] = PPI_NEG_INF;
  bicw_frame(rest, frame, frame_sh);
  PPI_EACH_LANE(l) {
    PpiPoint* me = &PPI_ME(pts, l);
    const int i = l < PPI_BIC_NP ? l : PPI_BIC_BALL;
    for (int c = 0; c < 3; ++c) me->k[c] = ppi_bic_seg_k[i][c];
    me->mass = ppi_bic_point[i][0];
    me->drop = ppi_bic_point[i][1];
    bicw_hang(frame, &me->drop, me->part);
    for (int c = 0; c < 3; ++c) {
      me->prev[c] = me->part[c];
      me->pred[c] = me->part[c];
      me->term[c] = 0.0f;
    }
    for (int c = 0; c < 6; ++c) me->dadb[c] = 0.0f;
  }
  for (int k = 0; k < n_stab; ++k) ppi_bic_step(pts, a, hold, still);
  // only the trajectory and the cool-down are scored
  a[PPI_BIC_A_MAX_POT] = PPI_NEG_INF;
  a[PPI_BIC_A_SUM_VEL] = 0.0f;
  a[PPI_BIC_A_SUM_POS] = 0.0f;
  a[PPI_BIC_A_SUM_BALL] = 0.0f;
  a[PPI_BIC_A_N_STEPS] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) a[PPI_BIC_A_Q0 + j] = a[j];
  float qdes[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float qddes[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < horizon; ++t) {
    qdes[1] = act[(t * 4 + 0) * n + r];
    qdes[3] = act[(t * 4 + 1) * n + r];
    qddes[1] = act[(t * 4 + 2) * n + r];
    qddes[3] = act[(t * 4 + 3) * n + r];
    ppi_bic_step(pts, a, qdes, qddes);
  }
  for (int k = 0; k < n_cool; ++k) ppi_bic_step(pts, a, qdes, still);
  float ball[3], sc[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) ball[c] = PPI_OF(pts, part[c], PPI_BIC_BALL);
  bicw_score(a, ball, sc);
  PPI_EACH_LANE(l) {
    const PpiPoint* me = &PPI_ME(pts, l);
    if (l < PPI_BIC_NP) {
      for (int c = 0; c < 3; ++c) {
        state[(PPI_BIC_PARTICLES + 3 * l + c) * n + r] = me->part[c];
        state[(PPI_BIC_PREV + 3 * l + c) * n + r] = me->prev[c];
      }
    }
    if (l == 0) {
      for (int k = 0; k < PPI_BIC_A; ++k)
        state[(k < 8 ? k : PPI_BIC_FORCE + k - 8) * n + r] = a[k];
      score[r] = sc[0];
      score[n + r] = sc[1];
    }
  }
}

#ifdef __CUDACC__

__global__ void ppi_bic_warp_kernel(const float* __restrict__ q_start,
                                    const float* __restrict__ act,
                                    float* __restrict__ state,
                                    float* __restrict__ score, int n,
                                    int horizon, int n_stab, int n_cool) {
  // one trajectory a warp: the whole warp leaves together
  const int r = blockIdx.x * (int)(blockDim.x >> 5) + (int)(threadIdx.x >> 5);
  if (r >= n) return;
  ppi_bic_trajectory(r, n, horizon, n_stab, n_cool, q_start, act, state,
                     score);
}

// Launches on `stream` with `warps` trajectories a block; returns
// cudaGetLastError() (0 on success).
extern "C" int ppi_bic_warp_launch(const float* q_start, const float* act,
                                   float* state, float* score, int n,
                                   int horizon, int n_stab, int n_cool,
                                   int warps, void* stream) {
  if (warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  const int grid = (n + warps - 1) / warps;
  ppi_bic_warp_kernel<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
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

int ppi_bic_warp_host(const float* q_start, const float* act, float* state,
                      float* score, int n, int horizon, int n_stab,
                      int n_cool) {
  for (int r = 0; r < n; ++r)
    ppi_bic_trajectory(r, n, horizon, n_stab, n_cool, q_start, act, state,
                       score);
  return 0;
}

#endif
