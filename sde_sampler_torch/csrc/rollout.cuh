// Fused rollouts of a control-net SDE, in one launch: kernel 1 (Euler-
// Maruyama) and kernel 2 (the DDS exponential integrator).
//
// Kernel 1 replaces the TPU kernel `fused_sim_rollout` with `sde_step_fn`
// (sde_sampler_tpu/ops/rollout_pallas.py:68, pallas_call at :202, step at
// :214); kernel 2 replaces the same call with `exp_integrator_step_fn`
// (step at :229). CUDA cannot trace a generic step function, so both are
// specialised to control forms and target scores:
//
//   lerp (LerpCtrl, DIS):
//     u = clip(FourierMLP(s, x), clip_model) * ctrl_scale[k]
//         + diff[k] * sscore[k] * clip(lerp(prior score, target score; w[k]),
//                                     clip_score)
//   lerp_target (LerpTargetCtrl, the generative control of solver=bridge;
//   kernel 1 only; no prior):
//     u = clip(FourierMLP(s, x), clip_model) * ctrl_scale[k]
//         + diff[k] * sscore[k] * clip(w[k] * target score, clip_score)
//   lerp_prior (LerpPriorCtrl, model=lerp_prior; kernel 1 only; no target,
//   w[k] = 1 - t / T and the hard constraint's factor 2 t / T):
//     u = clip(FourierMLP(s, x), clip_model) * ctrl_scale[k]
//         + diff[k] * sscore[k] * clip(w[k] * prior score, clip_score)
//   score (ScoreCtrl, PIS / EulerDDS / DDS):
//     u = clip(FourierMLP(s, x), clip_model) + sscore[k] * clip(target score,
//                                                              clip_score)
//   clipped (ClippedCtrl, DIS and PIS without a score; kernel 1 only):
//     u = clip(FourierMLP(s, x), clip_model)
//   potential (PotentialCtrl over a one-output net, SubtrajBridge; kernel 1
//   only; its own kernels, in rollout_potential.cu):
//     u = diff[k] * grad_x clip(FourierMLP(s, x), clip_model)
//   cancel_drift (CancelDriftCtrl, model=langevin_init; kernel 1 only):
//     u = clip(FourierMLP(s, x), clip_model)
//         + ((scale[k] * clip(target score, clip_score)) * sscore[k]
//            - drift[k] * x) / diff[k]
//     in the JAX package's order: the drift is subtracted inside u and
//     added back by the EM update; scale[k] is diff[k]^2 / 2 with
//     langevin_init, else scale_score (in the lerp weight's column);
//
// and the updates
//
//   EM  (kernel 1): x' = x + (drift[k] * x + diff[k] * u) * dt[k] + diff[k] * db[k]
//   exp (kernel 2): x' = (a[k] * x + b2s2[k] * u) + sb[k] * eps[k]
//
// where, for the exponential integrator, beta_k = clip(alpha sqrt(dt), 0, 1),
// a = sqrt(1 - beta^2), b2s2 = beta^2 sigma^2, sb = sigma beta and eps is a
// standard normal; a step with dt = 0 has a = 1, b2s2 = sb = 0 and passes
// the state through. The Gauss prior's score (loc - x) / scale^2 (an
// IsotropicGauss or a diagonal Gauss such as PIS's Delta, its loc and
// variance per coordinate, staged in shared memory) and the target scores
// are inline device functions:
//
//   funnel: (-x0 / var - (d - 1) / 2 + sum_{j>0} x_j^2 e^-x0 / 2, -x_j e^-x0),
//     from the row reductions x0 and sum_{j>0} x_j^2;
//   gmm (GMM; Gauss and IsotropicGauss with K = 1): the log-weights
//     lw_k = c_k - sum_j (x_j - loc_kj)^2 / (2 scale_kj^2) of each (row,
//     component) pair, c_k = log w_k - sum_j log scale_kj, then
//     e_k = exp(lw_k - max lw), then per coordinate
//     sum_k e_k (loc_kj - x_j) / scale_kj^2 / sum_k e_k; the table (loc,
//     1/scale^2, c) lies in shared memory;
//   wells (DoubleWell, MultiWell): -4 ((x - shift)^2 - sep) (x - shift) on
//     the first n coordinates, shift - x on the rest; elementwise;
//   rings (Rings, d = 2 only): -2 scale (1 - c / (|x| + eps)) x with c the
//     radius nearest |x| (the first on ties), from the row's |x| and c; the
//     radii lie in shared memory;
//   rosenbrock (Rosenbrock): -g_j / flatness with
//     g_j = [j < d-1] (-400 x_j)(x_{j+1} - x_j^2) - 2 (1 - x_j)
//         + [j > 0] 200 (x_j - x_{j-1}^2),
//     which needs the row's neighbours: the row phase writes the whole
//     score row, one (row, coordinate) pair a thread;
//   img (Img, d = 2 only): -(dE/dx, dE/dy) * scale at the pixel
//     p = x * scale + mean, cast to int32 saturating (NaN to 0) and clipped
//     to the inner pixels, by centred differences of the energy table:
//     four gathers into its 700 x 700 floats (1.96 MB), which stay in
//     device memory (L2-resident), read through the read-only cache;
//   given (any target whose score no kernel inlines: Cox, NICE): the score
//     of this step's state, computed before the launch (ops/rollout.py runs
//     one launch per step, T = 1, after the target's own score) and read
//     from device memory.
//
// The row reductions of the rings and Rosenbrock, and the cancel_drift
// form's control, round every operation on its own (__fmul_rn and kin), so
// that nvcc contracts none of them into an fma: the plain twin
// (ops/rollout.py) computes the same roundings.
//
// The target is a template parameter, like the form and d: each instance
// compiles only its own target's code. A runtime switch on a target code,
// uniform per block, was measured against it in one call on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py --phases kernels,timing; PERF.md):
// the funnel's kernel 1 alone took 0.512 ms with the switch and 0.486
// ms templated (kernel 2: 0.666 and 0.618 ms), the switch's registers and
// branches costing 5-8%, while the build from a clean directory took 69 s
// and 128 s in one source. The template keeps the funnel's earlier time
// (0.499 ms) and its bits; compiled in one source per form, side by side,
// its build takes 55 s.
//
// Everything that depends only on the step
// start s = ts[k] is computed before the launch by the wrapper
// (ops/rollout.py) as tables: the FourierMLP time-embedding row folded with
// the input_embed bias (T, C), and six scalars per step (T, 6): drift
// coefficient, diffusion, dt, lerp weight (t / T for the lerp forms; the
// score's scale for cancel_drift), sscore, ctrl scale for EM, or
// a, b2s2, sb, unused, sscore, unused for the exponential integrator.
// sscore is scale_score * clip(score_net(s), clip_model) (0 for a
// ClippedCtrl; clip(score_net(s), clip_model) alone for cancel_drift).
// A score net with one output per coordinate (model=lerp_dim, score_dim:
// TimeEmbed with dim_out = d) makes sscore a row of d per step: its
// instances (kPerCoord, every form with a score net, of kernel 1 and
// kernel 2) read a table of kTab + d columns a step, sscore[j] in column
// kTab + j (column 4 unused), and multiply coordinate j's score term by it; every
// other instance reads column 4 of a kTab-wide table, with the same code
// as before. A row of equal sscores gives the one-output instance's bits.
// xs[k] receives the state before step k (xs[0] = x0) and x_T the state
// after the last step.
//
// Bound on an H100: operations. Per step and row the net does
// 2 * (d*C + H*C*C + C*d) flops (about 19k at d = 10, C = 64, H = 2) while
// the rollout moves only the noise in and the states out (8 bytes per row,
// step and coordinate). B = 2048 rows leave about 16 rows per SM, so a step
// is a short chain of dependent layers on few warps: latency and
// instruction count, not bandwidth, set its time. A given score's one-step
// launch also reads its score: at d = 1600 its bytes (state, noise, score
// in, state out) bound it.
//
// Three bodies of a FourierMLP, chosen here by shape (or on request) and
// reported to the wrapper, which counts the generic and the wide one apart
// (a DenseNet takes a body of its own, rollout_dense_kernel, below):
//
// - rollout_fast_kernel, for width C = 64, H = 2 hidden layers (every model
//   config of the repo) and d = 1..16, all compile-time. One block of 128
//   threads per 8 rows, two blocks per SM. In the C-wide layers a thread
//   owns one channel of 4 rows: its weights (the input_embed and both
//   hidden columns, 138 floats at d = 10) stay in registers for the whole
//   launch, a warp covers 32 channels of the same rows, so the activations
//   are read as warp-uniform float4 broadcasts, and 4 independent sums are
//   in flight per thread. In the C -> d out_layer a thread owns one
//   output of one row, with its 64 weights in registers too, and updates
//   that coordinate at once: a step is four phases between barriers. The
//   per-step tables (T x 70 floats) live in shared memory for the whole
//   launch, and step k+1's noise arrives by cp.async while step k
//   computes: no step waits on device memory. The target's row reductions
//   run before the C-wide input layer (the mixture's log-weights one
//   (row, component) pair a thread), the mixture's exponentials between
//   its barrier and the next, so that the score's sum over components
//   reads them with the out_layer. Each output keeps the tiled bodies' sum
//   order (acc = bias, then fmaf over j = 0..C-1) and all bodies share
//   the target and update code, so they give the same bits.
// - The tiled bodies, for every other shape, share one SGEMM-shaped tiling
//   of the three kinds of layer (tile_fma, below): 256 threads, each
//   owning a register tile of a layer's output, its operands read as
//   float2s and float4s and the next ones loaded before its fmas. Rows a
//   block come from a plan (launch_tiled): the generic body as many blocks
//   as the card holds at once, at most 16 rows each, so that a batch of
//   512 still fills it; the wide body one block an SM, each pass over its
//   streamed weights serving the most rows. The out_layer's tiles update
//   the coordinates they output in place.
//   - rollout_generic_kernel<form, target>, any (C, H, d) whose weights fit
//     shared memory: every weight, the state tile and step 0's noise are
//     staged once by cp.async, later steps' noise arrives while the step
//     before computes; H + 2 barriers a step. For the configs' net (C = 64,
//     H = 2) its register path (128 threads, at most 8 rows a block) keeps
//     each thread's two hidden columns in registers for the whole launch,
//     as the fast body does, and reads no hidden weight in a step.
//   - rollout_wide_kernel<form>, one step of a given score where the
//     generic body would hold fewer than two blocks an SM (d = 196 and up
//     at C = 64; d = 1600, whose input and output layers alone are 2 d C
//     floats, 819 KB, does not fit at all): the hidden layers are staged,
//     the input and output layers' weights stream through a
//     double-buffered cp.async ring of 256-row or -column slices, so its
//     shared memory does not grow with d.
//   Both compute every output as the fast body does and give its bits.
//   TF32 tensor cores would not: the products stay FP32 SIMT.
//
// This header holds the bodies and their launch code. Each control form's
// instances (every target and d) compile in a source of their own
// (rollout_lerp.cu, rollout_lerp_target.cu, rollout_score.cu,
// rollout_clipped.cu, rollout_cancel_drift.cu, rollout_exp.cu,
// rollout_lerp_prior.cu, and the per-coordinate sscore's
// rollout_lerp_dim.cu, rollout_score_dim.cu, rollout_exp_dim.cu,
// rollout_lerp_target_dim.cu, rollout_cancel_drift_dim.cu; the lerp_prior
// form's, of one target, also hold its per-coordinate instances; the
// potential form's bodies, which run the net's backward pass too, live in
// rollout_potential.cu over this header's copies, tiles and plan),
// so that the build runs one nvcc per form side by side; rollout.cu holds
// the C entry points.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace sde_rollout {

constexpr int kTab = 6;    // per-step scalars, see the header

constexpr int kFastRows = 8;         // batch rows per block of the fast body
constexpr int kFastThreads = 128;    // 64 channels x 2 row groups
constexpr int kFastRowsPerThread = 4;
constexpr int kFastC = 64;
constexpr int kFastH = 2;
// padded activation rows: the out_layer's two rows per warp hit other banks
constexpr int kActStride = kFastC + 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit
static_assert(kFastThreads == kFastC * kFastRows / kFastRowsPerThread,
              "one thread per channel and row group");
static_assert(kFastThreads == 16 * kFastRows,
              "one thread per row and out_layer output, for d <= 16");

// The body a launch asks for, and the one it reports.
constexpr int kByShape = 0;
constexpr int kFastBody = 1;
constexpr int kGenericBody = 2;
constexpr int kWideBody = 3;
constexpr int kDenseBody = 4;          // a DenseNet's, its weights in shared memory
constexpr int kDenseStreamedBody = 5;  // a DenseNet's, its weights streamed

// Control form and update of one instance.
constexpr int kLerpEm = 0;     // kernel 1, LerpCtrl (DIS)
constexpr int kScoreEm = 1;    // kernel 1, ScoreCtrl (PIS, EulerDDS)
constexpr int kScoreExp = 2;   // kernel 2, ScoreCtrl (DDS)
constexpr int kClippedEm = 3;  // kernel 1, ClippedCtrl (no score)
constexpr int kLerpTargetEm = 4;  // kernel 1, LerpTargetCtrl (Bridge)
constexpr int kPotentialEm = 5;   // kernel 1, PotentialCtrl (SubtrajBridge)
constexpr int kCancelDriftEm = 6;  // kernel 1, CancelDriftCtrl (langevin_init)
constexpr int kLerpPriorEm = 7;    // kernel 1, LerpPriorCtrl (model=lerp_prior)

// Target whose score an instance inlines.
constexpr int kFunnel = 0;
constexpr int kGmm = 1;       // GMM, Gauss and IsotropicGauss
constexpr int kWells = 2;     // DoubleWell, MultiWell
constexpr int kNoTarget = 3;  // the ClippedCtrl's
constexpr int kRings = 4;     // Rings (d = 2)
constexpr int kRosenbrock = 5;
constexpr int kImg = 6;       // Img (d = 2), its energy table in device memory
constexpr int kGiven = 7;     // any target: its score of this step, given as a tensor

// t0..t3 are the target's scalars: the funnel's first-coordinate variance,
// the wells' number (as a float), separation and shift, the rings'
// scale and eps, the Rosenbrock's flatness, or the image's mean (t0, t1)
// and scale (t2, t3). K is the number of mixture components (0 for the
// other targets); n_tab the floats of the target's table that the bodies
// stage in shared memory: the mixture's K (2 D + 1), the rings' radii,
// else 0 (the image's energy table, tab_h rows of tab_w pixels, is read
// from device memory). prior_loc and prior_var: the lerp forms' prior, its
// D locs and variances in device memory (null in the other forms).
struct Consts {
  float clip_model, clip_score;
  float t0, t1, t2, t3;
  int K, n_tab, tab_w, tab_h;
  const float *prior_loc, *prior_var;
};

// Floats per row of the row reductions in shared memory: the mixture's K
// log-weights and K exponentials, the Rosenbrock's D scores, none for a
// given score (read from device memory), else two (the funnel's, the
// rings' |x| and nearest radius, the image's score).
__host__ __device__ constexpr int row_floats(int target, int K, int D) {
  return target == kGmm ? 2 * K
                        : (target == kRosenbrock ? D : (target == kGiven ? 0 : 2));
}

// Saturating float -> int32 conversion, rounding towards zero, NaN to 0
// (cvt.rzi.s32.f32), as XLA converts.
__device__ __forceinline__ int to_int_saturating(float v) { return __float2int_rz(v); }

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

// NaN-preserving clip to [-c, c] (c = +inf means no clip).
__device__ __forceinline__ float clip(float v, float c) {
  return v < -c ? -c : (v > c ? c : v);
}

// The target score at coordinate j (of D) of a row whose state there is
// x. `row` holds the row's reductions: the funnel's x[:, 0] and
// sum_{i>0} x[:, i]^2, or the mixture's log-weights and their exponentials
// e_k (K each); `gmm` the mixture's table: loc (K, D), 1/scale^2 (K, D),
// log-weight constants (K). The mixture's score is
// sum_k e_k (loc_kj - x) / scale_kj^2 / sum_k e_k.
template <int kTarget>
__device__ __forceinline__ float target_score(float x, int j, int D, const float* row,
                                              const float* gmm, const Consts& cs) {
  if constexpr (kTarget == kFunnel) {
    const float first = row[0], sq = row[1];
    const float inv_var_other = expf(-first);
    return j == 0 ? (-first / cs.t0 - 0.5f * (float)(D - 1)) + 0.5f * sq * inv_var_other
                  : -x * inv_var_other;
  } else if constexpr (kTarget == kGmm) {
    const int K = cs.K;
    const float* e = row + K;
    const float* loc = gmm + j;
    const float* inv_var = gmm + K * D + j;
    float acc = 0.0f, sum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      acc = fmaf(e[k], (loc[k * D] - x) * inv_var[k * D], acc);
      sum += e[k];
    }
    return acc / sum;
  } else if constexpr (kTarget == kWells) {
    if (j < (int)cs.t0) {
      const float xw = x - cs.t2;
      return -4.0f * (xw * xw - cs.t1) * xw;
    }
    return cs.t2 - x;
  } else if constexpr (kTarget == kRings) {
    const float radius = row[0], c = row[1];
    return ((-2.0f * cs.t0) * (1.0f - c / (radius + cs.t1))) * x;
  } else if constexpr (kTarget == kRosenbrock || kTarget == kImg || kTarget == kGiven) {
    return row[j];
  } else {
    return 0.0f;
  }
}

// The row reductions of a tile of `rows` rows (state x, (rows, D)) that the
// target score needs, by threads tid = 0..nt-1 of the block: the funnel's
// (x[:, 0], sum_{i>0} x[:, i]^2), the mixture's K log-weights of each
// (row, component) pair, log w_k - sum_j log scale_kj - 1/2 sum_j
// (x_j - loc_kj)^2 / scale_kj^2, the rings' (|x|, nearest radius), the
// Rosenbrock's score of each (row, coordinate) pair, or the image's score.
// Into row (rows, row_floats). `gmm` is the target's table: in shared
// memory, or for the image its energy table in device memory.
template <int kTarget>
__device__ __forceinline__ void row_phase(const float* x, float* row, const float* gmm,
                                          int rows, int D, int tid, int nt,
                                          const Consts& cs) {
  if constexpr (kTarget == kFunnel) {
    for (int r = tid; r < rows; r += nt) {
      float sq = 0.0f;
      for (int j = 1; j < D; ++j) sq = fmaf(x[r * D + j], x[r * D + j], sq);
      row[2 * r] = x[r * D];
      row[2 * r + 1] = sq;
    }
  } else if constexpr (kTarget == kGmm) {
    const int K = cs.K, RS = row_floats(kGmm, K, 0);
    const float* inv_var = gmm + K * D;
    const float* cst = gmm + 2 * K * D;
    for (int p = tid; p < rows * K; p += nt) {
      const int r = p / K, k = p - r * K;
      float q = 0.0f;
      for (int j = 0; j < D; ++j) {
        const float dl = x[r * D + j] - gmm[k * D + j];
        q = fmaf(dl * dl, inv_var[k * D + j], q);
      }
      row[r * RS + k] = fmaf(-0.5f, q, cst[k]);
    }
  } else if constexpr (kTarget == kRings) {
    for (int r = tid; r < rows; r += nt) {
      float sq = 0.0f;
      for (int j = 0; j < D; ++j) sq = __fadd_rn(sq, __fmul_rn(x[r * D + j], x[r * D + j]));
      const float radius = sqrtf(sq);
      float best = 0.0f, c = 0.0f;
      for (int i = 0; i < cs.n_tab; ++i) {
        const float dl = radius - gmm[i];
        const float dd = __fmul_rn(dl, dl);
        if (i == 0 || dd < best) best = dd, c = gmm[i];
      }
      row[2 * r] = radius;
      row[2 * r + 1] = c;
    }
  } else if constexpr (kTarget == kRosenbrock) {
    for (int p = tid; p < rows * D; p += nt) {
      const int r = p / D, j = p - r * D;
      const float* xr = x + r * D;
      const float xj = xr[j];
      float g = 0.0f;
      if (j < D - 1) {
        const float a = __fmul_rn(__fmul_rn(-400.0f, xj), __fsub_rn(xr[j + 1], __fmul_rn(xj, xj)));
        g = __fsub_rn(a, __fmul_rn(2.0f, __fsub_rn(1.0f, xj)));
      }
      if (j > 0)
        g = __fadd_rn(g, __fmul_rn(200.0f, __fsub_rn(xj, __fmul_rn(xr[j - 1], xr[j - 1]))));
      row[p] = __fdiv_rn(-g, cs.t0);
    }
  } else if constexpr (kTarget == kImg) {
    // the pixel p = x * scale + mean, cast saturating to int and clipped to
    // the inner pixels; the score is -(dE/dx, dE/dy) * scale from centred
    // differences of the energy table there (L2-resident: four gathers)
    const int W = cs.tab_w;
    for (int r = tid; r < rows; r += nt) {
      const float px = __fadd_rn(__fmul_rn(x[r * D], cs.t2), cs.t0);
      const float py = __fadd_rn(__fmul_rn(x[r * D + 1], cs.t3), cs.t1);
      const int ix = min(max(to_int_saturating(px), 1), W - 2);
      const int iy = min(max(to_int_saturating(py), 1), cs.tab_h - 2);
      const float* e = gmm + (size_t)iy * W + ix;
      const float dedx = 0.5f * (__ldg(e + 1) - __ldg(e - 1));
      const float dedy = 0.5f * (__ldg(e + W) - __ldg(e - W));
      row[2 * r] = -dedx * cs.t2;
      row[2 * r + 1] = -dedy * cs.t3;
    }
  }
}

// The mixture's exponentials from the log-weights of row_phase, read after
// a barrier: e_k = exp(lw_k - max_k lw_k), one (row, component) pair a
// thread, beside the log-weights.
template <int kTarget>
__device__ __forceinline__ void exp_phase(float* row, int rows, int tid, int nt,
                                          const Consts& cs) {
  if constexpr (kTarget == kGmm) {
    const int K = cs.K, RS = row_floats(kGmm, K, 0);
    for (int p = tid; p < rows * K; p += nt) {
      const int r = p / K, k = p - r * K;
      const float* lw = row + r * RS;
      float m = lw[0];
#pragma unroll 4
      for (int i = 1; i < K; ++i) m = fmaxf(m, lw[i]);
      row[r * RS + K + k] = expf(lw[k] - m);
    }
  }
}

// Columns of a step's table: kTab, and d more for a per-coordinate sscore.
template <bool kPerCoord>
__host__ __device__ constexpr int tab_cols(int D) {
  return kPerCoord ? kTab + D : kTab;
}

// The sscore of coordinate j from a step's table row st.
template <bool kPerCoord>
__device__ __forceinline__ float step_sscore(const float* st, int j) {
  if constexpr (kPerCoord) {
    return st[kTab + j];
  } else {
    return st[4];
  }
}

// Whether a form reads the Gauss prior (Consts.prior_loc, prior_var).
template <int kForm>
constexpr bool kReadsPrior = kForm == kLerpEm || kForm == kLerpPriorEm;

// The Gauss prior's (loc, variance) at coordinate j: from the pairs that a
// body staged in shared memory once a launch (stage_prior), or ({0, 1},
// unread) in the forms without a prior. The bodies read a pair at every
// update: the fast body ran 2-3% slower at d = 2 with its pair held in
// registers across the steps, or read at an offset computed at run time
// (PERF.md §6).
template <int kForm>
__device__ __forceinline__ float2 prior_at(const float2* pairs, int j) {
  if constexpr (kReadsPrior<kForm>)
    return pairs[j];
  else
    return make_float2(0.0f, 1.0f);
}

// The same from the prior's two arrays in device memory (the wide body's
// one-step launches).
template <int kForm>
__device__ __forceinline__ float2 prior_at(const Consts& cs, int j) {
  if constexpr (kReadsPrior<kForm>)
    return make_float2(cs.prior_loc[j], cs.prior_var[j]);
  else
    return make_float2(0.0f, 1.0f);
}

// Stage the prior's D (loc, variance) pairs in shared memory, before a
// barrier.
template <int kForm>
__device__ __forceinline__ void stage_prior(float2* pairs, const Consts& cs, int D) {
  if constexpr (kReadsPrior<kForm>) {
    for (int j = threadIdx.x; j < D; j += blockDim.x)
      pairs[j] = make_float2(cs.prior_loc[j], cs.prior_var[j]);
  }
}

// The Gauss prior's score at state x from its loc and variance p.
__device__ __forceinline__ float prior_score(float x, float2 p) { return (p.x - x) / p.y; }

// One coordinate's update from its net output `net`, its target score
// `target`, the step's scalars `st`, its sscore and its prior's loc and
// variance p (prior_at).
template <int kForm>
__device__ __forceinline__ float step_update(float x, float net, float target,
                                             const float* st, float sscore, float db,
                                             const Consts& cs, float2 p) {
  const float drift = st[0], diff = st[1], dt = st[2], w = st[3];
  const float cscale = st[5];
  if constexpr (kForm == kLerpEm) {
    const float prior = prior_score(x, p);
    const float lerp = clip(prior + (target - prior) * w, cs.clip_score);
    const float u = clip(net, cs.clip_model) * cscale + diff * (sscore * lerp);
    return x + (drift * x + diff * u) * dt + diff * db;
  } else if constexpr (kForm == kLerpPriorEm) {  // w = 1 - t / T
    const float lerp = clip(w * prior_score(x, p), cs.clip_score);
    const float u = clip(net, cs.clip_model) * cscale + diff * (sscore * lerp);
    return x + (drift * x + diff * u) * dt + diff * db;
  } else if constexpr (kForm == kLerpTargetEm) {
    const float lerp = clip(w * target, cs.clip_score);
    const float u = clip(net, cs.clip_model) * cscale + diff * (sscore * lerp);
    return x + (drift * x + diff * u) * dt + diff * db;
  } else if constexpr (kForm == kClippedEm) {
    const float u = clip(net, cs.clip_model);
    return x + (drift * x + diff * u) * dt + diff * db;
  } else if constexpr (kForm == kCancelDriftEm) {
    // w holds the score's scale, sscore the clipped score net
    const float score = __fmul_rn(__fmul_rn(w, clip(target, cs.clip_score)), sscore);
    const float u = clip(net, cs.clip_model) +
                    __fdiv_rn(__fsub_rn(score, __fmul_rn(drift, x)), diff);
    return x + (drift * x + diff * u) * dt + diff * db;
  } else {
    const float u = clip(net, cs.clip_model) + sscore * clip(target, cs.clip_score);
    if constexpr (kForm == kScoreEm) {
      return x + (drift * x + diff * u) * dt + diff * db;
    } else {
      // drift, diff, dt hold a, beta^2 sigma^2, sigma beta (see header)
      return (x * drift + diff * u) + dt * db;
    }
  }
}

// ---------------------------------------------------------------- shared helpers

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Block-wide copy of n floats into shared memory; 16 bytes at a time where
// both sides allow it.
__device__ __forceinline__ void copy_in(float* dst, const float* src, int n) {
  const size_t addr = reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst);
  if (n % 4 == 0 && (addr & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Block-wide cp.async of `rows` rows of n floats (source rows `ld_src`
// floats apart, destination rows `ld_dst` apart) into shared memory, in the
// caller's commit group; 16 bytes at a time where both sides allow it.
__device__ __forceinline__ void copy_rows_async(float* dst, int ld_dst, const float* src,
                                                size_t ld_src, int rows, int n) {
  const size_t addr = reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst);
  if ((n | ld_dst | (int)(ld_src & 3)) % 4 == 0 && (addr & 15) == 0) {
    const int q = n / 4;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i - r * q);
      cp_async16(dst + r * ld_dst + c, src + r * ld_src + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      cp_async4(dst + r * ld_dst + c, src + r * ld_src + c);
    }
  }
}

// The same for n contiguous floats.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  copy_rows_async(dst, n, src, (size_t)n, 1, n);
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// ---------------------------------------------------------------- tiled bodies

// The generic and the wide body share one tiling of the net's products, an
// SGEMM-shaped register tile (tile_fma): a thread owns TM rows by TN
// adjacent columns of a layer's output (2 by 2 in the C-wide layers and the
// generic body's out_layer, 4 by 4 in the wide body's out_layer). Per 4
// steps of j it reads each of its rows' 4 activations as one float4
// (warp-uniform: a broadcast) and each step's TN weights as one float2 or
// float4 (the lanes' columns adjacent: conflict-free); two groups of
// operands ping-pong, so that a group's loads issue before the previous
// group's fmas. With at most 16 rows a multiprocessor there are 1024
// outputs a C-wide layer: 4 a thread keeps 8 warps busy, two a scheduler,
// which the card needs (a 4 x 2 tile on 4 warps ran 1.5x slower; PERF.md
// §6). Each sum keeps the fast body's order: acc = bias (or the
// time embedding), then fmaf over j = 0..K-1, so every body gives the same
// bits.
constexpr int kTileThreads = 256;
constexpr int kLayerRows = 2;    // a thread's tile in the C-wide layers and the generic
constexpr int kLayerCols = 2;    // body's out_layer: rows, columns
constexpr int kWideInRows = 2;   // a thread's tile in the wide body's input layer
constexpr int kWideInCols = 2;
constexpr int kWideOutRows = 4;  // a thread's tile in the wide body's out_layer
constexpr int kWideOutCols = 4;
constexpr int kMaxRows = 16;     // rows a block at most
constexpr int kWideStages = 2;   // the wide body's ring: a slice computes, the next lands
constexpr int kWideTiles = 2;    // input-layer tiles a wide-body thread holds (C <= 128)

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
static_assert(kWideOutCols == 4, "the wide body's epilogue moves a row's 4 coordinates as a float4");
static_assert(4 % kLayerRows == 0 && 4 % kWideInRows == 0 && 4 % kWideOutRows == 0,
              "the wide body's rows pad to a multiple of 4");

// TN = 2 or 4 adjacent floats from p (aligned to 4 TN bytes) into v.
template <int TN>
__device__ __forceinline__ void ld_cols(float (&v)[TN], const float* p) {
  static_assert(TN == 2 || TN == 4, "a tile is 2 or 4 columns wide");
  if constexpr (TN == 4) {
    const float4 t = ld4(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

// One group of 4 steps of tile_fma: operands `a` (TM rows' float4s) and
// `b` (4 steps' TN weights), and their fmas in the sum order.
template <int TM, int TN>
struct TileGroup {
  float4 a[TM];
  float b[4][TN];

  __device__ __forceinline__ void load(const float* in, int ldi, const float* w, int ldw, int j) {
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) a[rr] = ld4(in + rr * ldi + j);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ld_cols<TN>(b[kk], w + (j + kk) * ldw);
  }

  __device__ __forceinline__ void fma(float (&acc)[TM][TN]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
        const float v = (&a[rr].x)[kk];
#pragma unroll
        for (int cc = 0; cc < TN; ++cc) acc[rr][cc] = fmaf(b[kk][cc], v, acc[rr][cc]);
      }
    }
  }
};

// acc[rr][cc] += w[j][cc] * in[rr][j] for j = 0..K-1 in order (fmaf), over
// the TM rows of `in` (row stride ldi, a multiple of 4, rows 16-byte
// aligned) and the TN columns that start at `w` (aligned to 4 TN bytes,
// row stride ldw a multiple of 4). Two groups of operands ping-pong, so
// that each group's loads issue before the previous group's fmas, with no
// register copies.
template <int TM, int TN>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN], const float* in, int ldi,
                                         const float* w, int ldw, int K) {
  const int K4 = K & ~3;
  if (K4 > 0) {
    TileGroup<TM, TN> g0, g1;
    g0.load(in, ldi, w, ldw, 0);
    int j = 0;
    for (; j + 8 <= K4; j += 8) {
      g1.load(in, ldi, w, ldw, j + 4);
      g0.fma(acc);
      if (j + 8 < K4) g0.load(in, ldi, w, ldw, j + 8);
      g1.fma(acc);
    }
    if (j < K4) g0.fma(acc);  // the last group, loaded above
  }
  for (int j = K4; j < K; ++j) {
    float b[TN];
    ld_cols<TN>(b, w + j * ldw);
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
      const float v = in[rr * ldi + j];
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) acc[rr][cc] = fmaf(b[cc], v, acc[rr][cc]);
    }
  }
}

// out[r][c] = gelu(bias[c] + sum_j w[j][c] in[r][j]) for the RP rows (a
// multiple of kLayerRows) and N columns of a block, a tile a thread at a
// time; w's row stride ldw = pad4(N); `bias` in shared or device memory.
template <int NT = kTileThreads>
__device__ __forceinline__ void dense_gelu(float* out, int ldo, const float* in, int ldi,
                                           const float* w, int ldw, const float* bias, int K,
                                           int N, int RP) {
  constexpr int TM = kLayerRows, TN = kLayerCols;
  const int nq = (N + TN - 1) / TN, tiles = RP / TM * nq;
  for (int t = threadIdx.x; t < tiles; t += NT) {
    const int rt = t / nq, c0 = TN * (t - rt * nq);
    float acc[TM][TN];
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) {
      const float b = bias[min(c0 + cc, N - 1)];
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) acc[rr][cc] = b;
    }
    tile_fma<TM, TN>(acc, in + rt * TM * ldi, ldi, w + c0, ldw, K);
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
      for (int cc = 0; cc < TN; ++cc)
        if (c0 + cc < N) out[(rt * TM + rr) * ldo + c0 + cc] = gelu_exact(acc[rr][cc]);
    }
  }
}

// The hidden layers (weights (H, C, pad4(C)), biases (H, pad4(C))),
// ping-ponging between `in` and `out`, each followed by a barrier; returns
// the buffer of the last activations. `wait_noise`: the last one first
// waits for this step's noise copy (all but the newest cp.async group).
template <int NT = kTileThreads>
__device__ __forceinline__ float* hidden_layers(float* in, float* out, const float* whid,
                                                const float* bhid, int C, int H, int RP,
                                                bool wait_noise) {
  const int CP = pad4(C);
  for (int l = 0; l < H; ++l) {
    dense_gelu<NT>(out, CP, in, CP, whid + (size_t)l * C * CP, CP, bhid + l * CP, C, C, RP);
    if (wait_noise && l == H - 1) cp_async_wait<1>();
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// The generic body's path for the model configs' net (C = 64, H = 2, as the
// fast body's): kRegThreads threads, each owning one channel of 4 rows, its
// two hidden columns in registers for the whole launch (whid, loaded once
// from shared memory), as the fast body keeps them; a warp's 32 channels
// read the same rows, so the activations arrive as float4 broadcasts and
// no weight is read from shared memory in a step. At most kRegRows rows a
// block.
constexpr int kRegThreads = 128;
constexpr int kRegRows = kRegThreads / kFastC * 4;
static_assert(kRegRows == 8, "two row groups of 4 rows");

// Both hidden layers from register-resident weights (the thread's channel
// c, rows 4 rg..4 rg + 3), each followed by a barrier; the last first waits
// for this step's noise copy. Returns the buffer of the last activations.
__device__ __forceinline__ float* hidden_layers_reg(float* in, float* out,
                                                    const float (&whid)[kFastH][kFastC],
                                                    const float (&bhid)[kFastH]) {
  constexpr int CP = kFastC;
  const int c = threadIdx.x % kFastC, r0 = 4 * (threadIdx.x / kFastC);
#pragma unroll
  for (int l = 0; l < kFastH; ++l) {
    float acc[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) acc[rr] = bhid[l];
#pragma unroll
    for (int j0 = 0; j0 < kFastC; j0 += 4) {
      float4 a[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) a[rr] = ld4(in + (r0 + rr) * CP + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[rr] = fmaf(whid[l][j0 + jj], (&a[rr].x)[jj], acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) out[(r0 + rr) * CP + c] = gelu_exact(acc[rr]);
    if (l == kFastH - 1) cp_async_wait<1>();  // this step's noise has landed
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// Float offsets of the generic body's shared memory at R rows a block (RP
// = pad4(R) rows of tiles; kRegRows for the register path, `reg`), each array at a multiple of 4 floats: the
// weights with rows padded to a multiple of 4 floats, two activation
// buffers, the state tile (row stride D, as row_phase reads it, and a copy
// of row stride pad4(D) for the input layer's float4 reads where D % 4 !=
// 0), the noise of two steps, a given score's tile, the row reductions and
// the target's table, and the lerp forms' prior (`prior`: D (loc,
// variance) pairs). `total` is the size in floats, -1 for shapes past any
// block.
struct GenericLayout {
  int win, whid, bhid, wout, bout, a, b, xa, x, db, sc, row, gmm, prior;
  long long total;
};

__host__ __device__ inline GenericLayout generic_layout(int D, int C, int H, int R, int RS,
                                                        int n_tab, bool given, bool reg,
                                                        bool prior) {
  GenericLayout l{};
  if ((long long)D * C > (1 << 24) || (long long)H * C * C > (1 << 24) || D > (1 << 20)) {
    l.total = -1;
    return l;
  }
  const int RP = reg ? kRegRows : pad4(R), CP = pad4(C), DP = pad4(D);
  int o = 0;
  l.win = o, o += D * CP;
  l.whid = o, o += H * C * CP;
  l.bhid = o, o += H * CP;
  l.wout = o, o += C * DP;
  l.bout = o, o += DP;
  l.a = o, o += RP * CP;
  l.b = o, o += RP * CP;
  l.x = o, o += pad4(RP * D);
  l.xa = l.x;
  if (D % 4 != 0) l.xa = o, o += RP * DP;
  l.db = o, o += 2 * pad4(RP * D);
  l.sc = o, o += given ? pad4(RP * D) : 0;
  l.row = o, o += pad4(RP * RS);
  l.gmm = o, o += pad4(n_tab);
  l.prior = o, o += prior ? 2 * DP : 0;  // o stays a multiple of 4: pairs aligned
  l.total = o;
  return l;
}

// The generic body: any (C, H, d) whose weights fit shared memory, every
// target and form, T steps in one launch. R rows a block (the plan's, at
// most kMaxRows). The weights, the state tile, step 0's noise (and a given
// score) are staged once by cp.async; step k+1's noise arrives by cp.async
// while step k computes. A step: the target's row reductions and the input
// layer, the mixture's exponentials and the hidden layers, then the C -> d
// layer, whose tiles update the coordinates they output in place: H + 2
// barriers. A given score (kGiven, T = 1) is staged at the tile's rows:
// `gmm` is the score (B, D) of this step's state.
template <int kForm, int kTarget, bool kPerCoord, bool kReg>
__global__ void __launch_bounds__(kReg ? kRegThreads : kTileThreads) rollout_generic_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ gmm,
    float* __restrict__ xs, float* __restrict__ x_T, int B, int D, int C, int H, int T, int R,
    Consts cs) {
  constexpr int TM = kLayerRows, TN = kLayerCols;
  constexpr int NT = kReg ? kRegThreads : kTileThreads;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int RS = row_floats(kTarget, cs.K, D);
  const GenericLayout L =
      generic_layout(D, C, H, R, RS, cs.n_tab, kTarget == kGiven, kReg, kReadsPrior<kForm>);
  const int RP = kReg ? kRegRows : pad4(R), CP = pad4(C), DP = pad4(D);
  float* s_win = sm + L.win;    // (D, CP) input_embed weight, (in, out)
  float* s_whid = sm + L.whid;  // (H, C, CP)
  float* s_bhid = sm + L.bhid;  // (H, CP)
  float* s_wout = sm + L.wout;  // (C, DP)
  float* s_bout = sm + L.bout;  // (DP)
  float* s_a = sm + L.a;        // (RP, CP) activations, ping
  float* s_b = sm + L.b;        // (RP, CP) activations, pong
  float* s_x = sm + L.x;        // (RP, D) state tile
  float* s_xa = sm + L.xa;      // (RP, DP) the input layer's copy (s_x where D % 4 == 0)
  float* s_db = sm + L.db;      // 2 x (RP, D) noise
  float* s_sc = sm + L.sc;      // (RP, D) a given score
  float* s_row = sm + L.row;    // (RP, RS) the target's row reductions
  float* s_gmm = sm + L.gmm;    // (n_tab) the target's table
  float2* s_prior = reinterpret_cast<float2*>(sm + L.prior);  // (D) the prior's pairs
  const int db_floats = pad4(RP * D);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int nx = nrows * D;  // valid floats of the tile
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  // the image's energy table stays in device memory
  const float* table = kTarget == kImg ? gmm : s_gmm;
  const float* rows = kTarget == kGiven ? s_sc : s_row;
  const int row_stride = kTarget == kGiven ? D : RS;
  // a launch of one step of a given score writes its state before the step
  // where it already lies (xs[k] is x0) only once
  const bool write_xs = xs != x0;

  copy_rows_async(s_win, CP, w_in, (size_t)C, D, C);
  copy_rows_async(s_whid, CP, w_hid, (size_t)C, H * C, C);
  copy_rows_async(s_bhid, CP, b_hid, (size_t)C, H, C);
  copy_rows_async(s_wout, DP, w_out, (size_t)D, C, D);
  copy_async(s_bout, b_out, D);
  if constexpr (kTarget != kImg && kTarget != kGiven) copy_async(s_gmm, gmm, cs.n_tab);
  if constexpr (kTarget == kGiven) copy_async(s_sc, gmm + tile_off, nx);
  stage_prior<kForm>(s_prior, cs, D);
  copy_async(s_x, x0 + tile_off, nx);
  copy_async(s_db, dbs + tile_off, nx);
  for (int i = nx + tid; i < RP * D; i += NT) s_x[i] = 0.0f;  // rows past B
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the register path's hidden columns, for the whole launch
  float wreg[kFastH][kFastC], breg[kFastH];
  if constexpr (kReg) {
    const int c = tid % kFastC;
#pragma unroll
    for (int l = 0; l < kFastH; ++l) {
      breg[l] = s_bhid[l * CP + c];
#pragma unroll
      for (int j = 0; j < kFastC; ++j) wreg[l][j] = s_whid[(l * kFastC + j) * CP + c];
    }
  }
  if (s_xa != s_x) {
    for (int i = tid; i < RP * DP; i += NT) {
      const int r = i / DP, j = i - r * DP;
      s_xa[i] = j < D ? s_x[r * D + j] : 0.0f;
    }
    __syncthreads();
  }

  const int nq = (D + TN - 1) / TN;  // the out_layer's column groups
  const int out_tiles = RP / TM * nq;
  for (int k = 0; k < T; ++k) {
    if (write_xs) {
      float* xs_k = xs + (size_t)k * step_stride + tile_off;
      for (int i = tid; i < nx; i += NT) xs_k[i] = s_x[i];
    }
    if (k + 1 < T)
      copy_async(s_db + ((k + 1) & 1) * db_floats, dbs + (size_t)(k + 1) * step_stride + tile_off,
                 nx);
    cp_async_commit();  // one group per step, empty on the last

    // the target's row reductions of this step's state
    row_phase<kTarget>(s_x, s_row, table, RP, D, tid, NT, cs);

    // input_embed(x) + timestep_embed(s) (bias folded into temb), then GELU
    dense_gelu<NT>(s_a, CP, s_xa, DP, s_win, CP, temb + (size_t)k * C, D, C, RP);
    if (H == 0) cp_async_wait<1>();  // this step's noise has landed
    __syncthreads();
    // the mixture's exponentials, read after the next barrier
    exp_phase<kTarget>(s_row, RP, tid, NT, cs);
    const float* act;
    if constexpr (kReg)
      act = hidden_layers_reg(s_a, s_b, wreg, breg);
    else
      act = hidden_layers<NT>(s_a, s_b, s_whid, s_bhid, C, H, RP, true);
    if (kTarget == kGmm && H == 0) __syncthreads();

    // out_layer, and the update of the coordinates each tile outputs
    const float* st = tab + (size_t)k * tab_cols<kPerCoord>(D);
    const float* db_k = s_db + (k & 1) * db_floats;
    for (int t = tid; t < out_tiles; t += NT) {
      const int rt = t / nq, o0 = TN * (t - rt * nq);
      float acc[TM][TN];
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) {
        const float b = s_bout[o0 + cc];
#pragma unroll
        for (int rr = 0; rr < TM; ++rr) acc[rr][cc] = b;
      }
      tile_fma<TM, TN>(acc, act + rt * TM * CP, CP, s_wout + o0, DP, C);
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) {
        const int r = rt * TM + rr;
#pragma unroll
        for (int cc = 0; cc < TN; ++cc) {
          const int o = o0 + cc;
          if (r >= nrows || o >= D) continue;
          const int i = r * D + o;
          const float target =
              target_score<kTarget>(s_x[i], o, D, rows + r * row_stride, table, cs);
          const float x = step_update<kForm>(s_x[i], acc[rr][cc], target, st,
                                             step_sscore<kPerCoord>(st, o), db_k[i], cs,
                                             prior_at<kForm>(s_prior, o));
          s_x[i] = x;
          s_xa[r * DP + o] = x;
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nx; i += NT) x_T[tile_off + i] = s_x[i];
}

// Float offsets of the wide body's shared memory at R rows a block (RP =
// pad4(R) rows of tiles) and slices of S: the hidden layers, two activation
// buffers and a ring of kWideStages slices, each either an input-layer
// slice (S rows of the (D, C) weight, rows padded to pad4(C), then the
// tile's state at those S coordinates, (RP, S)) or an output-layer slice
// (S columns of the (C, D) weight, (C, S), then their biases).
struct WideLayout {
  int whid, bhid, a, b, ring, stage;
  long long total;
};

__host__ __device__ inline WideLayout wide_layout(int C, int H, int R, int S) {
  WideLayout l{};
  if ((long long)H * C * C > (1 << 24) || C > 4096) {
    l.total = -1;
    return l;
  }
  const int RP = pad4(R), CP = pad4(C);
  const int in_stage = S * CP + RP * S, out_stage = C * S + S;
  int o = 0;
  l.whid = o, o += H * C * CP;
  l.bhid = o, o += H * CP;
  l.a = o, o += RP * CP;
  l.b = o, o += RP * CP;
  l.stage = pad4(in_stage > out_stage ? in_stage : out_stage);
  l.ring = o, o += kWideStages * l.stage;
  l.total = o;
  return l;
}

// The wide body: one step (T = 1) of a given score (`gmm`, the score (B, D)
// of x0), for a state too wide for the generic body to stage (d = 1600:
// the input and output layers alone are 2 d C floats, 819 KB) or whose
// staging would hold fewer than two blocks an SM. The hidden layers are
// staged; the input-layer weight (D, C) and the output-layer weight (C, D)
// stream through a double-buffered ring of S-row or S-column slices by
// cp.async, with the state's columns of each input slice, so that slice
// s + 1 lands while slice s computes and the shared memory does not grow
// with d. The input layer's sums stay in registers across its slices; the
// out_layer's tiles (4 rows, 16 sums a thread) end in the update of the
// coordinates they output, written to x_T (and the state before the step
// to xs). The tile's noise and score are prefetched into L2 at the start,
// and each output tile loads its operands before its fmas. Every sum keeps
// the generic body's order, so the two give the same bits.
template <int kForm, bool kPerCoord>
__global__ void __launch_bounds__(kTileThreads) rollout_wide_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ gmm,
    float* __restrict__ xs, float* __restrict__ x_T, int B, int D, int C, int H, int R, int S,
    Consts cs) {
  constexpr int TM = kWideInRows, TN = kWideInCols, TO = kWideOutRows, TQ = kWideOutCols;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const WideLayout L = wide_layout(C, H, R, S);
  const int RP = pad4(R), CP = pad4(C);
  float* s_whid = sm + L.whid;  // (H, C, CP)
  float* s_bhid = sm + L.bhid;  // (H, CP)
  float* s_a = sm + L.a;        // (RP, CP) activations, ping
  float* s_b = sm + L.b;        // (RP, CP) activations, pong
  float* s_ring = sm + L.ring;  // kWideStages slices

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const size_t tile_off = (size_t)row0 * D;
  const bool write_xs = xs != x0;
  const int n_in = (D + S - 1) / S;  // input slices, then as many output slices
  const int n_slices = 2 * n_in;
  const int nqc = (C + TN - 1) / TN;  // the input layer's column groups
  const int in_tiles = RP / TM * nqc;
  const int nqs = S / TQ;  // an output slice's column groups
  const int out_tiles = RP / TO * nqs;

  // the noise and score of the tile, read by the output slices, into L2
  for (int i = 32 * tid; i < nrows * D; i += 32 * kTileThreads) {
    prefetch_l2(dbs + tile_off + i);
    prefetch_l2(gmm + tile_off + i);
  }
  auto load = [&](int s) {
    float* st = s_ring + (s % kWideStages) * L.stage;
    if (s < n_in) {
      const int j0 = s * S, kk = min(S, D - j0);
      copy_rows_async(st, CP, w_in + (size_t)j0 * C, (size_t)C, kk, C);
      copy_rows_async(st + S * CP, S, x0 + tile_off + j0, (size_t)D, nrows, kk);
    } else {
      const int o0 = (s - n_in) * S, nn = min(S, D - o0);
      copy_rows_async(st, S, w_out + o0, (size_t)D, C, nn);
      copy_async(st + C * S, b_out + o0, nn);
    }
  };
  copy_rows_async(s_whid, CP, w_hid, (size_t)C, H * C, C);
  copy_rows_async(s_bhid, CP, b_hid, (size_t)C, H, C);
  load(0);
  cp_async_commit();

  // the input layer's tiles of this thread, their sums kept across slices
  float acc[kWideTiles][TM][TN];
#pragma unroll
  for (int i = 0; i < kWideTiles; ++i) {
    const int t = tid + i * kTileThreads;
    const int c0 = TN * (t % nqc);
#pragma unroll
    for (int cc = 0; cc < TN; ++cc) {
      const float b = temb[min(c0 + cc, C - 1)];
#pragma unroll
      for (int rr = 0; rr < TM; ++rr) acc[i][rr][cc] = b;
    }
  }
  const float* act = s_a;

  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<0>();  // slice s has landed
    __syncthreads();     // ... for every thread, and slice s - 1 is done
    if (s + 1 < n_slices) load(s + 1);
    cp_async_commit();
    const float* st = s_ring + (s % kWideStages) * L.stage;
    if (s < n_in) {
      // input_embed(x) + timestep_embed(s) (bias folded into temb)
      const int kk = min(S, D - s * S);
#pragma unroll
      for (int i = 0; i < kWideTiles; ++i) {
        const int t = tid + i * kTileThreads;
        if (t >= in_tiles) continue;
        const int rt = t / nqc, c0 = TN * (t - rt * nqc);
        tile_fma<TM, TN>(acc[i], st + S * CP + rt * TM * S, S, st + c0, CP, kk);
      }
      if (s == n_in - 1) {
#pragma unroll
        for (int i = 0; i < kWideTiles; ++i) {
          const int t = tid + i * kTileThreads;
          if (t >= in_tiles) continue;
          const int rt = t / nqc, c0 = TN * (t - rt * nqc);
#pragma unroll
          for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
            for (int cc = 0; cc < TN; ++cc)
              if (c0 + cc < C) s_a[(rt * TM + rr) * CP + c0 + cc] = gelu_exact(acc[i][rr][cc]);
          }
        }
        __syncthreads();
        act = hidden_layers(s_a, s_b, s_whid, s_bhid, C, H, RP, false);
      }
      continue;
    }
    // out_layer on this slice's columns, and the update of each coordinate
    const int o0 = (s - n_in) * S, nn = min(S, D - o0);
    for (int t = tid; t < out_tiles; t += kTileThreads) {
      const int rt = t / nqs, q0 = TQ * (t - rt * nqs);
      float xv[TO][TQ], dv[TO][TQ], sv[TO][TQ];
      // a row's TQ = 4 coordinates as one float4 where they are whole and
      // 16-byte aligned (D % 4 == 0), else one at a time
      const bool vec = (D & 3) == 0 && q0 + TQ <= nn;
#pragma unroll
      for (int rr = 0; rr < TO; ++rr) {
        const int r = rt * TO + rr;
        const size_t i = tile_off + (size_t)r * D + o0 + q0;
        if (vec && r < nrows) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(x0 + i));
          const float4 d4 = __ldg(reinterpret_cast<const float4*>(dbs + i));
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(gmm + i));
          xv[rr][0] = x4.x, xv[rr][1] = x4.y, xv[rr][2] = x4.z, xv[rr][3] = x4.w;
          dv[rr][0] = d4.x, dv[rr][1] = d4.y, dv[rr][2] = d4.z, dv[rr][3] = d4.w;
          sv[rr][0] = s4.x, sv[rr][1] = s4.y, sv[rr][2] = s4.z, sv[rr][3] = s4.w;
          continue;
        }
#pragma unroll
        for (int cc = 0; cc < TQ; ++cc) {
          const bool ok = r < nrows && q0 + cc < nn;
          xv[rr][cc] = ok ? x0[i + cc] : 0.0f;
          dv[rr][cc] = ok ? dbs[i + cc] : 0.0f;
          sv[rr][cc] = ok ? gmm[i + cc] : 0.0f;
        }
      }
      float out[TO][TQ];
#pragma unroll
      for (int cc = 0; cc < TQ; ++cc) {
        const float b = st[C * S + q0 + cc];
#pragma unroll
        for (int rr = 0; rr < TO; ++rr) out[rr][cc] = b;
      }
      tile_fma<TO, TQ>(out, act + rt * TO * CP, CP, st + q0, S, C);
#pragma unroll
      for (int rr = 0; rr < TO; ++rr) {
        const int r = rt * TO + rr;
        if (r >= nrows) continue;
        float x1[TQ];
#pragma unroll
        for (int cc = 0; cc < TQ; ++cc) {
          // the given score of this coordinate (target_score<kGiven> reads row[j])
          const float target =
              target_score<kGiven>(xv[rr][cc], 0, D, &sv[rr][cc], nullptr, cs);
          const int j = min(o0 + q0 + cc, D - 1);
          x1[cc] = step_update<kForm>(xv[rr][cc], out[rr][cc], target, tab,
                                      step_sscore<kPerCoord>(tab, j), dv[rr][cc], cs,
                                      prior_at<kForm>(cs, j));
        }
        const size_t i = tile_off + (size_t)r * D + o0 + q0;
        if (vec) {
          *reinterpret_cast<float4*>(x_T + i) = make_float4(x1[0], x1[1], x1[2], x1[3]);
          if (write_xs)
            *reinterpret_cast<float4*>(xs + i) =
                make_float4(xv[rr][0], xv[rr][1], xv[rr][2], xv[rr][3]);
          continue;
        }
#pragma unroll
        for (int cc = 0; cc < TQ; ++cc) {
          if (q0 + cc >= nn) continue;
          x_T[i + cc] = x1[cc];
          if (write_xs) xs[i + cc] = xv[rr][cc];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- DenseNet body
//
// rollout_dense_kernel<form, target, kPerCoord>: every form but the
// potential one over a ReLU DenseNet (conf/model/base/densenet.yaml, the
// JAX package's models/mlp.py::DenseNet), which the TPU kernel runs through
// the same step functions (`sde_step_fn`, `exp_integrator_step_fn`): with
// h_0 = [t, x], h_{l+1} = [h_l, relu(h_l W_l + b_l)] for each hidden layer
// and the output h_H W_out + b_out, followed by the form's update
// (step_update) as in every other body. The t column is the same for every
// row of a step, so each layer's t W_l[0, :] + b_l comes in a per-step t
// table (T, sum of the widths + D), computed before the launch
// (ops/rollout.py::dense_time_table), and the layers' weights without their
// t row come packed (dense_offset), each (K_l, pad4(N_l)) in (in, out)
// layout: layer l reads K_l = D + sum_{m<l} widths[m] inputs and writes N_l
// outputs (widths[l], D for the out layer).
//
// Bound on an H100: operations, 2 sum_l K_l N_l flops a row and step (about
// 42k multiply-adds a row at d = 2 for [200, 200], 83k at d = 50): at 16
// rows a multiprocessor, 5.2k cycles of FP32 fmas a step at d = 2. What
// keeps a body from that is the shared-memory traffic that feeds the fmas
// (128 bytes a cycle) and the waits between layers. The design:
//
// - A thread's register tile spans TM = 16 rows (a block's rows) by TN = 2
//   adjacent columns, so a step reads each weight
//   from shared memory once, not once per row tile (4-row tiles read it
//   four times). Per group of four inputs a thread reads its four
//   weight rows' two columns (float2s, the lanes' columns adjacent) and
//   each row's four activations (float4s of the row-major activations h),
//   for 128 fmas. A narrow layer (the out layer at small d) takes tiles of
//   4 rows, so that more threads share it.
// - ks lanes of a warp share a tile (split K): the lane of part p sums the
//   groups of four inputs g = p mod ks in order, from the t table's entry
//   (part 0) or 0, and a butterfly of shuffles adds the parts; the lanes
//   then store the tile's rows in turn, each output one predicated store.
//   The parts take the high bits of the lane (dense_lane), so that every
//   quarter-warp reads one activation address. ks depends on the layer's
//   width alone (dense_ks: 4 at 200 outputs, 32 at 2), so both modes and
//   every row count give the same bits.
// - A step is H + 2 phases between barriers: each layer (a hidden layer's
//   ReLU into its columns of h, the out layer's net output into s_out), then
//   the update of the block's own rows, which writes the new state to the
//   head of h. The target's row reductions run in the first layer's phase,
//   the mixture's exponentials in the second's. The next step's row of the
//   t table and its noise arrive by cp.async while a step computes; each
//   layer's figures come from a table made once a launch (DenseLayer).
//
// Two modes, chosen by the plan (launch_dense):
//
// - resident (S = 0): every packed weight is staged once in shared
//   memory, its rows at a stride that spreads the parts' rows over the
//   banks (bank_stride): densenet.yaml's [200, 200] at d = 2 (170 KB) and
//   d = 10 (196 KB);
// - streamed (S > 0): each layer's weights stream from device
//   memory (L2-resident) through a double-buffered cp.async ring of S-row
//   slices of a column chunk (dense_chunk: one pass of the threads over its
//   tiles), slice s + 1 landing while s computes: any d whose activations
//   fit (mw_50d's d = 50: 334 KB of weights; NICE's d = 196: 941 KB).
//   Every block reads all the weights every step.
constexpr int kFourierNet = 0;
constexpr int kDenseNet = 1;
constexpr int kDenseMaxLayers = 8;    // hidden layers at most (ops/build.py DENSE_MAX_LAYERS)
constexpr int kDenseMaxWidth = 1024;  // a hidden layer's width at most
constexpr int kDenseThreads = 512;
constexpr int kDenseTN = 2;           // a tile's columns
constexpr int kDenseWideRows = 16;    // a wide layer's tile rows (a narrow one's: 4)
constexpr int kDenseStages = 2;       // the streamed ring: a slice computes, the next lands
constexpr int kDenseMinSlice = 8;     // the streamed ring's shortest slice
constexpr int kDenseMaxSlice = 128;   // and its longest
constexpr int kDenseMaxChunk = 256;   // the streamed ring's widest column chunk
static_assert(kMaxRows <= kDenseWideRows, "a block's rows fit one wide tile");
static_assert(kDenseMinSlice % 4 == 0, "a slice holds whole groups of four inputs");

// A DenseNet's hidden layers and their widths (a kernel argument).
struct DenseDims {
  int H;
  int w[kDenseMaxLayers];
};

// Layer l's inputs (K) and outputs (N); l = H is the out layer.
__host__ __device__ inline int dense_in(const DenseDims& n, int D, int l) {
  int K = D;
  for (int m = 0; m < l; ++m) K += n.w[m];
  return K;
}

__host__ __device__ inline int dense_out(const DenseDims& n, int D, int l) {
  return l < n.H ? n.w[l] : D;
}

// Floats of the packed weights before layer l (l = H + 1: all of them).
__host__ __device__ inline long long dense_offset(const DenseDims& n, int D, int l) {
  long long o = 0;
  for (int m = 0; m < l; ++m) o += (long long)dense_in(n, D, m) * pad4(dense_out(n, D, m));
  return o;
}

// The lanes that share a tile of a layer of N outputs (a power of two, at
// most a warp): the most that keep the lanes of the 16-row tiles of all
// its column pairs within the block's threads. It depends on N alone.
__host__ __device__ inline int dense_ks(int N) {
  const int nq = (N + kDenseTN - 1) / kDenseTN;
  int ks = 1;
  while (ks < 32 && 2 * nq * ks <= kDenseThreads) ks *= 2;
  return ks;
}

// A tile's rows for `rows` rows by `ncols` columns: 16 where the 16-row
// tiles keep half the threads busy, else 4.
__host__ __device__ inline int dense_tm(int rows, int ncols, int ks) {
  const int nq = (ncols + kDenseTN - 1) / kDenseTN;
  return rows % kDenseWideRows == 0 && 2 * (rows / kDenseWideRows) * nq * ks >= kDenseThreads
             ? kDenseWideRows
             : 4;
}

// A weight row stride of at least n floats for a layer whose tiles split K
// over ks lanes. A warp's parts read weight rows four apart: up to four
// parts, a stride of 4 mod 8 floats puts them in two bank halves; past
// four, 2 mod 4 (still a float2's alignment) spreads them over four bank
// quarters, where a multiple of 8 would put them all in one.
__host__ __device__ inline int bank_stride(int n, int ks) {
  if (ks > 4) return n + (6 - n % 4) % 4;
  const int s = pad4(n);
  return s % 8 == 0 ? s + 4 : s;
}

// The stride of the resident weights of a layer of N outputs.
__host__ __device__ inline int dense_wstride(int N) { return bank_stride(N, dense_ks(N)); }

// Floats of the resident weights, every layer's.
__host__ __device__ inline long long dense_own_floats(const DenseDims& n, int D) {
  long long o = 0;
  for (int l = 0; l <= n.H; ++l)
    o += (long long)dense_in(n, D, l) * dense_wstride(dense_out(n, D, l));
  return o;
}

// The streamed ring's column chunk of a layer of N outputs at `rows` rows
// a block: at most one pass of the threads over its tiles, and at most
// kDenseMaxChunk columns (a multiple of 4 where it holds two pairs).
__host__ __device__ inline int dense_chunk(int rows, int N) {
  const int ks = dense_ks(N);
  const int pairs = min(kDenseMaxChunk / kDenseTN,
                        max(1, kDenseThreads / ks / (rows / dense_tm(rows, N, ks))));
  return pairs >= 2 ? 2 * kDenseTN * (pairs / 2) : kDenseTN;
}

// The streamed ring's row stride: the widest chunk's.
__host__ __device__ inline int dense_ring_cols(const DenseDims& n, int D, int rows) {
  int c = 0;
  for (int l = 0; l <= n.H; ++l) {
    const int N = dense_out(n, D, l);
    c = max(c, bank_stride(min(N, dense_chunk(rows, N)), dense_ks(N)));
  }
  return c;
}

// A layer's figures, computed once a launch (dense_layer_of) into shared
// memory: its inputs K and outputs N, the lanes of a tile ks and a tile's
// rows tm, its weights' stride ldw and offset woff in shared memory
// (resident), the layer's first column of the t table, its streamed column
// chunk and its packed weights' offset in device memory.
struct alignas(16) DenseLayer {
  int K, N, ks, tm, ldw, woff, tcol, chunk;
  long long goff;
};
constexpr int kDenseLayerFloats = (int)(sizeof(DenseLayer) / sizeof(float));
static_assert(sizeof(DenseLayer) % 16 == 0, "the layer table keeps the layout's alignment");

// Float offsets of the DenseNet body's shared memory at R rows a block (RP
// = pad4(R)) and slices of S weight rows (S = 0: resident): the weights
// (S = 0), the activations h of the block's RP rows (stride ldh), its
// state tile and
// its rows' net outputs (RP, D), two steps' rows of the t table (stride tp)
// and of the noise (stride dp), the row reductions, the target's table, the
// lerp forms' prior (`prior`: D (loc, variance) pairs), the layer table and the ring of kDenseStages stages of S x
// dense_ring_cols floats (S > 0). `total` is the size in floats, -1 for
// shapes past any block.
struct DenseLayout {
  int w, h, x, out, t, db, row, gmm, prior, lay, ring, stage, ldh, tp, dp;
  long long total;
};

__host__ __device__ inline DenseLayout dense_layout(int D, const DenseDims& n, int R, int RS,
                                                    int n_tab, int S, bool prior) {
  DenseLayout l{};
  const long long packed = dense_offset(n, D, n.H + 1);
  const long long width = dense_in(n, D, n.H);
  if (D < 1 || D > (1 << 20) || packed > (1LL << 26) || width > (1 << 20) || R < 1 ||
      R > kMaxRows) {
    l.total = -1;
    return l;
  }
  const int RP = pad4(R);
  l.ldh = pad4((int)width);
  long long o = 0;
  l.w = 0;
  if (S == 0) o += (dense_own_floats(n, D) + 3) & ~3LL;  // h's float4 rows stay aligned
  l.h = (int)o, o += (long long)RP * l.ldh;
  l.x = (int)o, o += pad4(RP * D);
  l.out = (int)o, o += pad4(RP * D);
  l.tp = pad4((int)width);
  l.t = (int)o, o += 2LL * l.tp;
  l.dp = pad4(RP * D);
  l.db = (int)o, o += 2LL * l.dp;
  l.row = (int)o, o += pad4(RP * RS);
  l.gmm = (int)o, o += pad4(n_tab);
  l.prior = (int)o, o += prior ? 2 * pad4(D) : 0;
  l.lay = (int)o, o += (long long)(kDenseMaxLayers + 1) * kDenseLayerFloats;
  l.stage = S > 0 ? S * dense_ring_cols(n, D, RP) : 0;
  l.ring = (int)o, o += (long long)kDenseStages * l.stage;
  l.total = o;
  return l;
}

// Layer l's figures at RP rows a block.
__device__ inline DenseLayer dense_layer_of(const DenseDims& n, int D, int l, int RP) {
  DenseLayer y;
  y.K = dense_in(n, D, l);
  y.N = dense_out(n, D, l);
  y.ks = dense_ks(y.N);
  y.ldw = dense_wstride(y.N);
  y.tm = dense_tm(RP, y.N, y.ks);
  y.woff = 0, y.tcol = 0;
  for (int m = 0; m < l; ++m) {
    const int N = dense_out(n, D, m);
    y.woff += dense_in(n, D, m) * dense_wstride(N);
    y.tcol += N;
  }
  y.chunk = dense_chunk(RP, y.N);
  y.goff = dense_offset(n, D, l);
  return y;
}

// A slice of the streamed ring: layer l, column chunk c, weight rows s.
struct DenseItem {
  int l, c, s;
};

// NaN-preserving ReLU, as torch's.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// v at `local` in this block's shared memory, one 4-byte store: a layer's
// columns start at any float (at odd ones for an odd d).
__device__ __forceinline__ void sts_f32(float* local, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"((unsigned)__cvta_generic_to_shared(local)), "f"(v)
               : "memory");
}

// acc[rr][cc] += w[j][cc] in[rr][j] (fmaf) over the groups of four inputs
// j = 4g..4g+3 in [j0, j1) with g = part modulo ks, in order, the last
// group partial where j1 is not a multiple of 4 (the layer's end); `in`
// holds the TM rows (stride ldi, a multiple of 4, 16-byte aligned) indexed
// by j, read four rows at a time, `w` the weight rows from j0 on (stride
// ldw, a multiple of 4; TN = 2 or 4 columns, aligned to 4 TN bytes). j0 is
// a multiple of 4.
template <int TM, int TN>
__device__ __forceinline__ void dense_fma(float (&acc)[TM][TN], const float* in, int ldi,
                                          const float* w, int ldw, int j0, int j1, int part,
                                          int ks) {
  static_assert(TM % 4 == 0, "a tile's rows are read four at a time");
  int g = j0 / 4;
  g += (part - g % ks + ks) % ks;
#pragma unroll 2
  for (; 4 * g + 4 <= j1; g += ks) {
    const int j = 4 * g;
    float b[4][TN];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ld_cols<TN>(b[kk], w + (j - j0 + kk) * ldw);
#pragma unroll
    for (int r4 = 0; r4 < TM; r4 += 4) {
      float4 a[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) a[rr] = ld4(in + (r4 + rr) * ldi + j);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float v = (&a[rr].x)[kk];
#pragma unroll
          for (int cc = 0; cc < TN; ++cc)
            acc[r4 + rr][cc] = fmaf(b[kk][cc], v, acc[r4 + rr][cc]);
        }
      }
    }
  }
  for (int j = 4 * g; j < j1; ++j) {  // the partial last group
    float b[TN];
    ld_cols<TN>(b, w + (j - j0) * ldw);
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
      const float v = in[rr * ldi + j];
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) acc[rr][cc] = fmaf(b[cc], v, acc[rr][cc]);
    }
  }
}

// A tile's sums start at the t table's entry of each column (`bias`, of
// ncols columns from the tile's q0) in part 0, at 0 in the others.
template <int TM, int TN>
__device__ __forceinline__ void dense_init(float (&acc)[TM][TN], const float* bias, int q0,
                                           int ncols, int part) {
#pragma unroll
  for (int cc = 0; cc < TN; ++cc) {
    const float b = part == 0 ? bias[min(q0 + cc, ncols - 1)] : 0.0f;
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) acc[rr][cc] = b;
  }
}

// A thread's tile (of the `slot`-th of a pass) and part under a split of
// ks lanes a tile. The parts take the high bits of the lane, so that each
// quarter-warp's lanes, of one part, read one activation address: an
// LDS.128 whose quarter-warps each read one address costs the SM's
// shared-memory pipe 2.5 cycles, one whose quarter-warps read several 4.0
// (scripts/lds_patterns.cu on the H100; PERF.md §6).
__device__ __forceinline__ void dense_lane(int ks, int& slot, int& part) {
  const int lane = threadIdx.x & 31, g = 32 / ks;
  part = lane / g;
  slot = (int)(threadIdx.x >> 5) * g + lane % g;
}

// The parts' sums, added by a butterfly over the ks lanes of a tile (lanes
// 32 / ks apart; every lane of the warp takes part): each lane then holds
// the whole sums.
template <int TM, int TN>
__device__ __forceinline__ void dense_reduce(float (&acc)[TM][TN], int ks) {
  for (int m = 32 / ks; m < 32; m *= 2) {
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
      for (int cc = 0; cc < TN; ++cc) acc[rr][cc] += __shfl_xor_sync(0xffffffffu, acc[rr][cc], m);
    }
  }
}

// Where a layer's sums go: a hidden layer's ReLU into h (`p`, row stride
// `ld`) from column col0 on; the out layer's net output into s_out (`p`,
// row stride `ld`).
struct DenseDst {
  float* p;
  int ld, col0, hidden;
};

// A tile's sums (rows from r0, the layer's columns col0 + q0 on, those
// below col0 + ncols valid) to d: the lane of part p takes the rows
// rr = p mod ks. One branch a tile picks the kind of store, so that each
// output is one predicated store (a general store at each output made the
// epilogue cost as much as the hidden product; PERF.md §6).
template <int TM, int TN>
__device__ __forceinline__ void dense_store(const float (&acc)[TM][TN], const DenseDst& d,
                                            int r0, int q0, int ncols, int part, int ks) {
  const int mask = ks - 1;
  float* p = d.p + r0 * d.ld + d.col0 + q0;
  if (d.hidden) {
#pragma unroll
    for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
      for (int cc = 0; cc < TN; ++cc)
        if ((rr & mask) == part && q0 + cc < ncols) sts_f32(p + rr * d.ld + cc, relu(acc[rr][cc]));
    }
    return;
  }
#pragma unroll
  for (int rr = 0; rr < TM; ++rr) {
#pragma unroll
    for (int cc = 0; cc < TN; ++cc)
      if ((rr & mask) == part && q0 + cc < ncols) sts_f32(p + rr * d.ld + cc, acc[rr][cc]);
  }
}

// One layer in the resident mode: the ncols columns of the weights w (rows
// 0..K-1, stride ldw) for the
// `rows` rows of h (stride ldh), their sums from bias[o], in passes of the
// threads over the tiles; then to dst.
template <int TM>
__device__ __forceinline__ void dense_tiles(const float* h, int ldh, int rows, const float* w,
                                            int ldw, int K, int ncols, const float* bias,
                                            int ks, const DenseDst& dst) {
  constexpr int TN = kDenseTN;
  const int nq = (ncols + TN - 1) / TN, tiles = rows / TM * nq, per = kDenseThreads / ks;
  int slot, part;
  dense_lane(ks, slot, part);
  for (int t0 = 0; t0 < tiles; t0 += per) {
    const int t = t0 + slot;
    const bool active = t < tiles;
    const int rt = active ? t / nq : 0, q0 = active ? TN * (t - rt * nq) : 0;
    float acc[TM][TN];
    dense_init<TM, TN>(acc, bias, q0, ncols, part);
    if (active) dense_fma<TM, TN>(acc, h + rt * TM * ldh, ldh, w + q0, ldw, 0, K, part, ks);
    dense_reduce<TM, TN>(acc, ks);
    if (active) dense_store<TM, TN>(acc, dst, rt * TM, q0, ncols, part, ks);
  }
}

// One layer of N outputs in the streamed mode: chunks of CC of its columns
// (one pass of the threads over a chunk's tiles), each chunk's weights
// through the ring a slice of S rows at a time, for the `rows` rows of h;
// `load(s)` issues the ring's next slice into stage s once every thread is
// done with it. Then to dst.
template <int TM, typename Load>
__device__ __forceinline__ void dense_stream(const float* h, int ldh, int rows,
                                             const float* ring, int stage_floats, int& stage,
                                             int K, int N, int ks, int CC, const float* bias,
                                             int S, Load& load, const DenseDst& dst) {
  constexpr int TN = kDenseTN;
  int t, part;
  dense_lane(ks, t, part);
  for (int c0 = 0; c0 < N; c0 += CC) {
    const int nc = min(CC, N - c0), nq = (nc + TN - 1) / TN, tiles = rows / TM * nq;
    const int ldw = bank_stride(nc, ks);
    const bool active = t < tiles;
    const int rt = active ? t / nq : 0, q0 = active ? TN * (t - rt * nq) : 0;
    float acc[TM][TN];
    dense_init<TM, TN>(acc, bias + c0, q0, nc, part);
    for (int j0 = 0; j0 < K; j0 += S) {
      cp_async_wait<0>();  // this slice has landed
      __syncthreads();     // ... for every thread; the stage before is done
      load(stage ^ 1);
      if (active)
        dense_fma<TM, TN>(acc, h + rt * TM * ldh, ldh, ring + stage * stage_floats + q0, ldw,
                          j0, min(K, j0 + S), part, ks);
      stage ^= 1;
    }
    dense_reduce<TM, TN>(acc, ks);
    if (active) dense_store<TM, TN>(acc, dst, rt * TM, c0 + q0, c0 + nc, part, ks);
  }
}

// Phase marks of a clock-instrumented build (scripts/dense_phase_split.py
// defines SDE_DENSE_PHASES in a copy of this header): block 0's thread 0
// adds the cycles since its last mark to phase i (0: the row reductions;
// 1 + 2l: layer l, 2 + 2l: its barrier; 2H + 3: the update, 2H + 4: its
// barrier) and prints each phase's cycles a step at the end.
#ifdef SDE_DENSE_PHASES
#define DENSE_PHASES_BEGIN                                      \
  const bool ph_me = blockIdx.x == 0 && threadIdx.x == 0;       \
  long long ph_t[2 * kDenseMaxLayers + 5] = {};                 \
  long long ph_c = clock64();                                   \
  const long long ph_0 = ph_c;
#define DENSE_PHASE(i)                    \
  if (ph_me) {                            \
    const long long ph_n = clock64();     \
    ph_t[i] += ph_n - ph_c;               \
    ph_c = ph_n;                          \
  }
#define DENSE_PHASES_END                                                                 \
  if (ph_me) {                                                                           \
    printf("dense phases D=%d S=%d T=%d R=%d: %lld cycles a step\n", D, S, T, R,         \
           (clock64() - ph_0) / T);                                                      \
    for (int i = 0; i < 2 * H + 5; ++i) printf("dense phase %d: %lld\n", i, ph_t[i] / T); \
  }
#else
#define DENSE_PHASES_BEGIN
#define DENSE_PHASE(i)
#define DENSE_PHASES_END
#endif

template <int kForm, int kTarget, bool kPerCoord>
__global__ void __launch_bounds__(kDenseThreads, 1) rollout_dense_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ ttab,
    const float* __restrict__ wpk, const float* __restrict__ gmm,
    float* __restrict__ xs, float* __restrict__ x_T, int B, int D, int T, int R, int S,
    DenseDims net, Consts cs) {
  constexpr int NT = kDenseThreads, WR = kDenseWideRows;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int RS = row_floats(kTarget, cs.K, D);
  const DenseLayout L = dense_layout(D, net, R, RS, cs.n_tab, S, kReadsPrior<kForm>);
  const int RP = pad4(R), LDH = L.ldh, H = net.H;
  float* s_w = sm + L.w;        // the weights (resident)
  float* s_h = sm + L.h;        // (RP, LDH) the activations of the block's rows
  float* s_x = sm + L.x;        // (RP, D) the block's state tile
  float* s_out = sm + L.out;    // (RP, D) its rows' net outputs
  float* s_t = sm + L.t;        // 2 x (tw) the t table's rows of two steps
  float* s_db = sm + L.db;      // 2 x (RP, D) the noise of two steps
  float* s_row = sm + L.row;    // (RP, RS) the target's row reductions
  float* s_gmm = sm + L.gmm;    // (n_tab) the target's table
  float2* s_prior = reinterpret_cast<float2*>(sm + L.prior);  // (D) the prior's pairs
  float* s_ring = sm + L.ring;  // kDenseStages slices (streamed)
  DenseLayer* s_lay = reinterpret_cast<DenseLayer*>(sm + L.lay);  // the layers' figures
  const int tw = dense_in(net, D, H);  // the t table's columns: the widths, then D

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int nx = nrows * D;
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  // the image's energy table stays in device memory, as does a given score
  const float* table = kTarget == kImg ? gmm : s_gmm;
  const bool write_xs = xs != x0;

  // the streamed ring's next slice into stage `to`: rows j0.. of its
  // chunk's columns (as many as its stride holds where the packed rows hold
  // them); then the slice after it in a step's order (layers, their chunks,
  // their slices), wrapping to the next step's first
  DenseItem next{0, 0, 0};
  auto load = [&](int to) {
    const DenseLayer& y = s_lay[next.l];
    const int NP = pad4(y.N), j0 = next.s * S, c0 = next.c * y.chunk;
    const int nc = min(y.chunk, y.N - c0), ldr = bank_stride(nc, y.ks);
    copy_rows_async(s_ring + to * L.stage, ldr, wpk + y.goff + (size_t)j0 * NP + c0, (size_t)NP,
                    min(S, y.K - j0), min(ldr, NP - c0));
    cp_async_commit();
    if (++next.s * S < y.K) return;
    next.s = 0;
    if (++next.c * y.chunk < y.N) return;
    next.c = 0;
    if (++next.l > H) next.l = 0;
  };
  // step k's rows of the t table and of the noise into buffer k & 1
  auto prefetch = [&](int k) {
    copy_async(s_t + (k & 1) * L.tp, ttab + (size_t)k * tw, tw);
    copy_async(s_db + (k & 1) * L.dp, dbs + (size_t)k * step_stride + tile_off, nx);
  };

  if (tid <= H) s_lay[tid] = dense_layer_of(net, D, tid, RP);
  if (S == 0) {  // every layer's weights
    for (int l = 0; l <= H; ++l) {
      const DenseLayer y = dense_layer_of(net, D, l, RP);
      copy_rows_async(s_w + y.woff, y.ldw, wpk + y.goff, (size_t)pad4(y.N), y.K,
                      min(y.ldw, pad4(y.N)));
    }
  }
  if constexpr (kTarget != kImg && kTarget != kGiven) copy_async(s_gmm, gmm, cs.n_tab);
  stage_prior<kForm>(s_prior, cs, D);
  copy_async(s_x, x0 + tile_off, nx);
  prefetch(0);
  cp_async_commit();
  for (int i = nx + tid; i < RP * D; i += NT) s_x[i] = 0.0f;  // rows past B
  cp_async_wait<0>();
  __syncthreads();
  // the state at the head of h, and xs[0]
  for (int i = tid; i < RP * D; i += NT) {
    const int r = i / D, j = i - r * D;
    s_h[r * LDH + j] = s_x[i];
    if (write_xs && i < nx) xs[tile_off + i] = s_x[i];
  }
  if (S > 0) load(0);
  __syncthreads();

  DENSE_PHASES_BEGIN
  int stage = 0;
  for (int k = 0; k < T; ++k) {
    const float* tk = s_t + (k & 1) * L.tp;
    const float* st = tab + (size_t)k * tab_cols<kPerCoord>(D);
    const float* db_k = s_db + (k & 1) * L.dp;
    // the next step's rows land while this one computes
    if (k + 1 < T) prefetch(k + 1);
    cp_async_commit();
    // the target's row reductions, read by the update after H + 1 barriers
    row_phase<kTarget>(s_x, s_row, table, RP, D, tid, NT, cs);
    DENSE_PHASE(0)
    for (int l = 0; l <= H; ++l) {
      // the mixture's exponentials, one barrier after its log-weights
      if (l == 1) exp_phase<kTarget>(s_row, RP, tid, NT, cs);
      const DenseLayer y = s_lay[l];
      const int K = y.K;
      // a hidden layer's ReLU into its columns of h; the out layer's net
      // output into s_out
      const int hidden = l < H;
      const DenseDst dst{hidden ? s_h : s_out, hidden ? LDH : D, hidden ? K : 0, hidden};
      if (S == 0) {
        const float* w = s_w + y.woff;
        const float* bias = tk + y.tcol;
        if (y.tm == WR)
          dense_tiles<WR>(s_h, LDH, RP, w, y.ldw, K, y.N, bias, y.ks, dst);
        else
          dense_tiles<4>(s_h, LDH, RP, w, y.ldw, K, y.N, bias, y.ks, dst);
      } else if (y.tm == WR) {
        dense_stream<WR>(s_h, LDH, RP, s_ring, L.stage, stage, K, y.N, y.ks, y.chunk,
                         tk + y.tcol, S, load, dst);
      } else {
        dense_stream<4>(s_h, LDH, RP, s_ring, L.stage, stage, K, y.N, y.ks, y.chunk,
                        tk + y.tcol, S, load, dst);
      }
      DENSE_PHASE(1 + 2 * l)
      __syncthreads();
      DENSE_PHASE(2 + 2 * l)
    }
    if (H == 0) {  // no second layer: the exponentials here
      exp_phase<kTarget>(s_row, RP, tid, NT, cs);
      __syncthreads();
    }
    // the update of the block's rows; the new state into xs[k + 1] (x_T
    // after the last step) and the head of h
    float* dst = (k + 1 < T ? xs + (size_t)(k + 1) * step_stride : x_T) + tile_off;
    for (int i = tid; i < nx; i += NT) {
      const int r = i / D, o = i - r * D;
      const float x = s_x[i];
      float target;
      if constexpr (kTarget == kGiven)
        target = __ldg(gmm + tile_off + i);
      else
        target = target_score<kTarget>(x, o, D, s_row + r * RS, table, cs);
      const float xn = step_update<kForm>(x, s_out[i], target, st, step_sscore<kPerCoord>(st, o),
                                          db_k[i], cs,
                                          prior_at<kForm>(s_prior, o));
      s_x[i] = xn;
      dst[i] = xn;
      if (k + 1 < T) s_h[r * LDH + o] = xn;
    }
    DENSE_PHASE(2 * H + 3)
    cp_async_wait<0>();  // the next step's rows have landed
    __syncthreads();
    DENSE_PHASE(2 * H + 4)
  }
  DENSE_PHASES_END
}

// ---------------------------------------------------------------- fast

// Floats of shared memory the fast body needs at a given D and T, with RS
// floats of row reductions a row, a target table of n_tab floats, TS
// columns of the per-step table and, with `prior`, the prior's D (loc,
// variance) pairs first (fast_prior_floats).
__host__ __device__ constexpr int fast_prior_floats(int D, bool prior) {
  return prior ? pad4(2 * D) : 0;
}

__host__ __device__ constexpr size_t fast_smem_floats(int D, int T, int RS, int n_tab, int TS,
                                                      bool prior) {
  return fast_prior_floats(D, prior) + (size_t)T * kFastC + (size_t)T * TS +
         2 * kFastRows * kActStride + D + 3 * (size_t)kFastRows * D + (size_t)kFastRows * RS +
         (size_t)n_tab;
}

template <int kForm, int kTarget, int D, bool kPerCoord>
__global__ void __launch_bounds__(kFastThreads, 2) rollout_fast_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ gmm,
    float* __restrict__ xs, float* __restrict__ x_T, int B, int T, Consts cs) {
  constexpr int C = kFastC, H = kFastH, AS = kActStride, NT = kFastThreads;
  constexpr int RT = kFastRowsPerThread;
  constexpr int R = kFastRows;
  constexpr int TS = tab_cols<kPerCoord>(D);
  const int RS = row_floats(kTarget, cs.K, D);
  extern __shared__ float4 sm4[];
  // the prior's pairs at offset 0 (see prior_at), then float4-read arrays,
  // each at a multiple of 4 floats
  float2* s_prior = reinterpret_cast<float2*>(sm4);  // (D) the prior's pairs
  float* s_temb =                                    // (T, C)
      reinterpret_cast<float*>(sm4) + fast_prior_floats(D, kReadsPrior<kForm>);
  float* s_a = s_temb + (size_t)T * C;            // (R, AS) activations, ping
  float* s_b = s_a + R * AS;                      // (R, AS) activations, pong
  float* s_tab = s_b + R * AS;                    // (T, TS)
  float* s_bout = s_tab + (size_t)T * TS;         // (D)
  float* s_x = s_bout + D;                        // (R, D) state tile
  float* s_db = s_x + R * D;                      // 2 x (R, D) noise
  float* s_row = s_db + 2 * R * D;                // (R, RS) the target's row reductions
  float* s_gmm = s_row + R * RS;                  // (n_tab) the target's table
  // the image's energy table stays in device memory
  const float* table = kTarget == kImg ? gmm : s_gmm;
  static_assert(kTarget != kGiven, "a given score takes the generic or wide body");

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nx = min(R, B - row0) * D;  // valid floats of the tile
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;

  // this thread's channel c of the C-wide layers and its RT rows from r0:
  // a warp covers 32 channels of the same rows, so activation reads are
  // warp-uniform broadcasts
  const int warp = tid >> 5, lane = tid & 31;
  const int c = 32 * (warp & 1) + lane;
  const int r0 = RT * (warp >> 1);

  // the weights of channel c stay in registers for the whole launch
  float win[D], whid[H][C], bhid[H];
#pragma unroll
  for (int j = 0; j < D; ++j) win[j] = w_in[j * C + c];
#pragma unroll
  for (int l = 0; l < H; ++l) {
    bhid[l] = b_hid[l * C + c];
#pragma unroll
    for (int j = 0; j < C; ++j) whid[l][j] = w_hid[(l * C + j) * C + c];
  }

  copy_in(s_temb, temb, T * C);
  copy_in(s_tab, tab, T * TS);
  copy_in(s_bout, b_out, D);
  copy_in(s_gmm, gmm, cs.n_tab);
  stage_prior<kForm>(s_prior, cs, D);
  for (int i = tid; i < R * D; i += NT) {
    s_x[i] = i < nx ? x0[tile_off + i] : 0.0f;
    if (i >= nx) s_db[i] = s_db[R * D + i] = 0.0f;  // rows past B
  }
  // step k's noise goes to buffer k & 1 (4-byte copies: a ragged B leaves
  // the tile unaligned)
  auto prefetch = [&](int k) {
    const float* src = dbs + (size_t)k * step_stride + tile_off;
    float* dst = s_db + (k & 1) * R * D;
    for (int i = tid; i < nx; i += NT) cp_async4(dst + i, src + i);
  };
  prefetch(0);
  cp_async_commit();
  __syncthreads();

  // this thread's coordinate of the C -> D layer and of the update
  const int o_row = tid >> 4, o_col = tid & 15;
  const bool o_valid = o_col < D;
  const int o_c = o_valid ? o_col : 0;  // clamped for the loads
  float wout[C];  // its out_layer weights, in registers too
#pragma unroll
  for (int j = 0; j < C; ++j) wout[j] = w_out[j * D + o_c];

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    for (int i = tid; i < nx; i += NT) xs_k[i] = s_x[i];
    if (k + 1 < T) prefetch(k + 1);
    cp_async_commit();  // one group per step, empty on the last

    // the target's row reductions of this step's state
    row_phase<kTarget>(s_x, s_row, table, R, D, tid, NT, cs);

    // input_embed(x) + timestep_embed(s) (bias folded into temb), then GELU
    float acc[RT];
    {
      const float t = s_temb[(size_t)k * C + c];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = t;
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
          acc[rr] = fmaf(win[j], s_x[(r0 + rr) * D + j], acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) s_a[(r0 + rr) * AS + c] = gelu_exact(acc[rr]);
    }
    __syncthreads();
    // the mixture's exponentials, read after the next barrier
    exp_phase<kTarget>(s_row, R, tid, NT, cs);

    float* in = s_a;
    float* out = s_b;
#pragma unroll
    for (int l = 0; l < H; ++l) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = bhid[l];
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        float4 a[RT];
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) a[rr] = ld4(in + (r0 + rr) * AS + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int rr = 0; rr < RT; ++rr)
            acc[rr] = fmaf(whid[l][j0 + jj], (&a[rr].x)[jj], acc[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) out[(r0 + rr) * AS + c] = gelu_exact(acc[rr]);
      if (l == H - 1) cp_async_wait<1>();  // this step's noise has landed
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }

    // out_layer, and the update of the coordinate it outputs
    {
      float o = s_bout[o_c];
#pragma unroll
      for (int j0 = 0; j0 < C; j0 += 4) {
        const float4 a = ld4(in + o_row * AS + j0);
        o = fmaf(wout[j0], a.x, o);
        o = fmaf(wout[j0 + 1], a.y, o);
        o = fmaf(wout[j0 + 2], a.z, o);
        o = fmaf(wout[j0 + 3], a.w, o);
      }
      const int i = o_row * D + o_col;
      if (o_valid && i < nx) {
        const float target =
            target_score<kTarget>(s_x[i], o_col, D, s_row + o_row * RS, table, cs);
        const float* st = s_tab + k * TS;
        s_x[i] = step_update<kForm>(s_x[i], o, target, st, step_sscore<kPerCoord>(st, o_col),
                                    s_db[(k & 1) * R * D + i], cs, prior_at<kForm>(s_prior, o_col));
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nx; i += NT) x_T[tile_off + i] = s_x[i];
}

// What a launch plans: rows a block, blocks, shared memory in bytes and the
// wide or streamed body's slice (0 for the other bodies).
struct Plan {
  int rows, blocks, smem, slice;
};

struct Args {
  const float *x0, *dbs, *tab, *temb, *w_in, *w_hid, *b_hid, *w_out, *b_out, *gmm;
  float *xs, *x_T;
  int B, D, C, H, T, target;
  bool per_coord;  // a per-coordinate sscore: the table has kTab + D columns
  Consts cs;
  cudaStream_t stream;
  int rows;     // rows a block of the tiled bodies asked for (0: the plan's)
  bool dry;     // plan only: launch nothing
  Plan* plan;   // receives the plan (may be null)
  int net;      // kFourierNet, or kDenseNet: `temb` its t table, `w_in` its packed weights
  DenseDims dense;  // a DenseNet's hidden layers (H) and widths
};

// The multiprocessors of the current device.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// Rows a block: as many blocks as every multiprocessor holds (`occupancy`
// of them at once, at least one) before any holds more, at most
// `max_rows`. The wide body plans one block a multiprocessor
// (occupancy 1): each pass over its streamed weights then serves the most
// rows.
inline int plan_rows(int B, int occupancy, int max_rows) {
  const int slots = sm_count() * (occupancy > 1 ? occupancy : 1);
  return min(max_rows, max(1, (B + slots - 1) / slots));
}

// Whether the generic body takes its register path: the model configs' net.
inline bool reg_path(const Args& a) { return a.C == kFastC && a.H == kFastH; }

// Shared memory (bytes) of the generic and the wide body at R rows a block
// (-1 past any block).
inline long long generic_smem(const Args& a, int R) {
  const GenericLayout l = generic_layout(a.D, a.C, a.H, R, row_floats(a.target, a.cs.K, a.D),
                                         a.cs.n_tab, a.target == kGiven, reg_path(a),
                                         a.cs.prior_loc != nullptr);
  return l.total < 0 ? -1 : (long long)sizeof(float) * l.total;
}

inline long long wide_bytes(const Args& a, int R, int S) {
  const WideLayout l = wide_layout(a.C, a.H, R, S);
  return l.total < 0 ? -1 : (long long)sizeof(float) * l.total;
}

inline bool smem_fits(long long bytes) { return bytes >= 0 && bytes <= (long long)kMaxSmem; }

// The wide body's slice: the longest of 256, 128 and 64 rows or columns
// whose ring fits at kMaxRows rows a block (0 if none).
inline int wide_slice(const Args& a) {
  for (int S = 256; S >= 64; S /= 2)
    if (smem_fits(wide_bytes(a, kMaxRows, S))) return S;
  return 0;
}

inline long long wide_smem(const Args& a, int R) {
  const int S = wide_slice(a);
  return S > 0 ? wide_bytes(a, R, S) : -1;
}

// The most rows a block (up to `cap`) whose shared memory fits, 0 if none.
template <typename Smem>
int max_rows(const Args& a, Smem smem, int cap = kMaxRows) {
  for (int R = cap; R >= 1; R -= (R > 4 ? 4 : 1))
    if (smem_fits(smem(a, R))) return R;
  return 0;
}

// The generic body takes any shape whose weights fit shared memory; the
// wide body one step of a given score whose input-layer tiles at kMaxRows
// rows its threads hold.
inline int generic_cap(const Args& a) { return reg_path(a) ? kRegRows : kMaxRows; }

inline bool generic_fits(const Args& a) { return max_rows(a, generic_smem, generic_cap(a)) > 0; }

inline bool wide_fits(const Args& a) {
  return a.target == kGiven && a.T == 1 && a.C >= 1 &&
         kMaxRows / kWideInRows * ((a.C + kWideInCols - 1) / kWideInCols) <=
             kWideTiles * kTileThreads &&
         max_rows(a, wide_smem) > 0;
}

// By shape, a given score takes the wide body where the generic body would
// hold fewer than two blocks a multiprocessor (d = 196 and up at C = 64).
inline bool wide_by_shape(const Args& a) {
  const long long generic = generic_smem(a, generic_cap(a));
  return generic < 0 || !smem_fits(2 * generic + 2048);
}

// A tiled body's attributes, set once, and its occupancy at the largest
// tile, read once per shared-memory size.
struct TileCache {
  cudaError_t attr;
  long long bytes;
  int occupancy;
};

template <typename Kernel>
TileCache tile_cache(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return TileCache{err, -1, 1};
}

// Launch (or only plan) `kernel`, one of the tiled bodies, of `threads`
// threads a block and at most `cap` rows, over the rows of a.B: rows a
// block from the plan (or a.rows), `go(blocks, rows, smem)` launching it.
// `slice` > 0: the wide body, one block a multiprocessor. The plan's rows
// round up to a multiple of `granule`, within the rows that fit.
template <typename Kernel, typename Smem, typename Launch>
cudaError_t launch_tiled(const Args& a, Kernel kernel, TileCache& cache, Smem smem, int slice,
                         int threads, int cap, Launch go, int granule = 1) {
  if (cache.attr != cudaSuccess) return cache.attr;
  const int fit = max_rows(a, smem, cap);
  if (fit == 0) return cudaErrorInvalidValue;
  int rows = a.rows > 0 ? min(a.rows, fit) : 0;
  if (rows == 0 && slice > 0) rows = plan_rows(a.B, 1, fit);
  if (rows == 0) {
    const long long bytes = smem(a, fit);
    if (bytes != cache.bytes) {
      int occupancy = 0;
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel,
                                                                      threads, bytes);
      if (err != cudaSuccess) return err;
      cache.occupancy = occupancy, cache.bytes = bytes;
    }
    rows = plan_rows(a.B, cache.occupancy, fit);
    rows = min(fit, (rows + granule - 1) / granule * granule);
  }
  const long long bytes = smem(a, rows);
  const int blocks = (a.B + rows - 1) / rows;
  if (a.plan != nullptr) *a.plan = Plan{rows, blocks, (int)bytes, slice};
  if (a.dry) return cudaSuccess;
  go(blocks, rows, (size_t)bytes);
  return cudaGetLastError();
}

template <int kForm, int kTarget, int D, bool kPerCoord>
cudaError_t launch_fast(const Args& a) {
  const size_t smem =  // fast_fits
      sizeof(float) * fast_smem_floats(D, a.T, row_floats(kTarget, a.cs.K, D), a.cs.n_tab,
                                       tab_cols<kPerCoord>(D), a.cs.prior_loc != nullptr);
  const int blocks = (a.B + kFastRows - 1) / kFastRows;
  if (a.plan != nullptr) *a.plan = Plan{kFastRows, blocks, (int)smem, 0};
  if (a.dry) return cudaSuccess;
  auto kernel = rollout_fast_kernel<kForm, kTarget, D, kPerCoord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // room for two blocks per SM (B = 2048 gives 256 blocks for 132 SMs)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFastThreads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.gmm,
      a.xs, a.x_T, a.B, a.T, a.cs);
  return cudaGetLastError();
}

template <int kForm, int kTarget, bool kPerCoord, bool kReg>
cudaError_t launch_generic_path(const Args& a) {
  auto kernel = rollout_generic_kernel<kForm, kTarget, kPerCoord, kReg>;
  static TileCache cache = tile_cache(kernel);
  constexpr int threads = kReg ? kRegThreads : kTileThreads;
  return launch_tiled(a, kernel, cache, generic_smem, 0, threads, kReg ? kRegRows : kMaxRows,
                      [&](int blocks, int rows, size_t smem) {
                        kernel<<<blocks, threads, smem, a.stream>>>(
                            a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out,
                            a.b_out, a.gmm, a.xs, a.x_T, a.B, a.D, a.C, a.H, a.T, rows, a.cs);
                      });
}

// The generic body: its register path for the model configs' net, else the
// tiled hidden layers.
template <int kForm, int kTarget, bool kPerCoord>
cudaError_t launch_generic(const Args& a) {
  return reg_path(a) ? launch_generic_path<kForm, kTarget, kPerCoord, true>(a)
                     : launch_generic_path<kForm, kTarget, kPerCoord, false>(a);
}

template <int kForm, bool kPerCoord>
cudaError_t launch_wide(const Args& a) {
  auto kernel = rollout_wide_kernel<kForm, kPerCoord>;
  static TileCache cache = tile_cache(kernel);
  const int S = wide_slice(a);
  return launch_tiled(a, kernel, cache, wide_smem, S, kTileThreads, kMaxRows,
                      [&](int blocks, int rows, size_t smem) {
                        kernel<<<blocks, kTileThreads, smem, a.stream>>>(
                            a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out,
                            a.b_out, a.gmm, a.xs, a.x_T, a.B, a.D, a.C, a.H, rows, S, a.cs);
                      });
}

// The DenseNet body's shared memory (bytes) at R rows a block and slices of
// S rows (0: resident), -1 past any block.
inline long long dense_smem(const Args& a, int R, int S) {
  const DenseLayout l = dense_layout(a.D, a.dense, R, row_floats(a.target, a.cs.K, a.D),
                                     a.cs.n_tab, S, a.cs.prior_loc != nullptr);
  return l.total < 0 ? -1 : (long long)sizeof(float) * l.total;
}

// The streamed body's slice: the most rows a block that fit with the
// shortest slice, then the longest of 128, 64, 32, 16 and 8 rows that fits
// there (0 if none).
inline int dense_slice(const Args& a) {
  const int rows = max_rows(a, [](const Args& b, int R) { return dense_smem(b, R, kDenseMinSlice); });
  if (rows == 0) return 0;
  for (int S = kDenseMaxSlice; S >= kDenseMinSlice; S /= 2)
    if (smem_fits(dense_smem(a, rows, S))) return S;
  return 0;
}

// A DenseNet (a.net == kDenseNet) in the DenseNet body: kDenseBody asks for
// its weights resident in shared memory, kDenseStreamedBody for the
// streamed ring; by shape, resident where its layout fits at the rows the
// plan gives one block a multiprocessor, else streamed. Each mode asked for
// outside its shapes fails. *used receives the mode launched (or planned).
template <int kForm, int kTarget, bool kPerCoord>
int launch_dense(const Args& a, int body, int* used) {
  const DenseDims& n = a.dense;
  if (n.H < 0 || n.H > kDenseMaxLayers) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n.H; ++l)
    if (n.w[l] < 1 || n.w[l] > kDenseMaxWidth) return (int)cudaErrorInvalidValue;
  if (body != kByShape && body != kDenseBody && body != kDenseStreamedBody)
    return (int)cudaErrorInvalidValue;
  auto kernel = rollout_dense_kernel<kForm, kTarget, kPerCoord>;
  static TileCache cache = tile_cache(kernel);
  if (cache.attr != cudaSuccess) return (int)cache.attr;
  auto resident_smem = [](const Args& b, int R) { return dense_smem(b, R, 0); };
  // rows a block at one block a multiprocessor (or as asked)
  const int R = a.rows > 0 ? min(a.rows, kMaxRows) : plan_rows(a.B, 1, kMaxRows);
  int mode = body;
  if (body == kByShape) mode = smem_fits(resident_smem(a, R)) ? kDenseBody : kDenseStreamedBody;
  const int S = mode == kDenseBody ? 0 : dense_slice(a);
  if (mode == kDenseBody ? max_rows(a, resident_smem) == 0 : S == 0)
    return (int)cudaErrorInvalidValue;
  *used = mode;
  return launch_tiled(a, kernel, cache, [S](const Args& b, int r) { return dense_smem(b, r, S); },
                      S, kDenseThreads, kMaxRows, [&](int blocks, int rows, size_t smem) {
                        kernel<<<blocks, kDenseThreads, smem, a.stream>>>(
                            a.x0, a.dbs, a.tab, a.temb, a.w_in, a.gmm, a.xs, a.x_T, a.B, a.D,
                            a.T, rows, S, a.dense, a.cs);
                      });
}

// The fast body takes C = 64, H = 2, D = 1..16 and tables that fit shared
// memory; never a given score.
inline bool fast_fits(const Args& a) {
  return a.C == kFastC && a.H == kFastH && a.D >= 1 && a.D <= 16 && a.target != kGiven &&
         sizeof(float) * fast_smem_floats(a.D, a.T, row_floats(a.target, a.cs.K, a.D),
                                          a.cs.n_tab, a.per_coord ? kTab + a.D : kTab,
                                          a.cs.prior_loc != nullptr) <=
             kMaxSmem;
}

// `body`: kByShape takes the fast body where it fits; else, for a given
// score, the wide body where it fits and the generic body would hold fewer
// than two blocks a multiprocessor (wide_by_shape); else the generic body.
// kFastBody, kGenericBody or kWideBody asks for one (each fails on a shape
// it does not take). *used receives the body launched (or planned). kOnlyD
// > 0 instantiates the fast body at that D alone (a target of one
// dimension) and no wide body; kOnlyD < 0 instantiates no fast body (a
// given score) and the wide one. kPerCoord: the instances of a
// per-coordinate sscore (a.per_coord). A DenseNet (a.net == kDenseNet)
// takes the DenseNet body (launch_dense) whatever kOnlyD.
template <int kForm, int kTarget, int kOnlyD = 0, bool kPerCoord = false>
int launch(const Args& a, int body, int* used) {
  if (a.B <= 0 || a.T <= 0 || used == nullptr || a.per_coord != kPerCoord)
    return (int)cudaErrorInvalidValue;
  if (a.net == kDenseNet) return launch_dense<kForm, kTarget, kPerCoord>(a, body, used);
  if (a.net != kFourierNet) return (int)cudaErrorInvalidValue;
  if (body != kByShape && body != kFastBody && body != kGenericBody && body != kWideBody)
    return (int)cudaErrorInvalidValue;
  const bool fits = kOnlyD >= 0 && fast_fits(a);
  const bool wide_ok = kOnlyD < 0 && wide_fits(a);
  const bool generic_ok = generic_fits(a);
  if ((body == kFastBody && !fits) || (body == kWideBody && !wide_ok) ||
      (body == kGenericBody && !generic_ok))
    return (int)cudaErrorInvalidValue;
  int chosen = body;
  if (body == kByShape) {
    if (fits)
      chosen = kFastBody;
    else if (wide_ok && (!generic_ok || wide_by_shape(a)))
      chosen = kWideBody;
    else if (generic_ok)
      chosen = kGenericBody;
    else
      return (int)cudaErrorInvalidValue;
  }
  *used = chosen;
  if (chosen == kGenericBody) return (int)launch_generic<kForm, kTarget, kPerCoord>(a);
  if constexpr (kOnlyD < 0) {
    return (int)launch_wide<kForm, kPerCoord>(a);
  } else if constexpr (kOnlyD > 0) {
    return a.D == kOnlyD ? (int)launch_fast<kForm, kTarget, kOnlyD, kPerCoord>(a)
                         : (int)cudaErrorInvalidValue;
  } else {
    switch (a.D) {
#define SDE_CASE(DD) \
  case DD:           \
    return (int)launch_fast<kForm, kTarget, DD, kPerCoord>(a);
      SDE_CASE(1) SDE_CASE(2) SDE_CASE(3) SDE_CASE(4) SDE_CASE(5) SDE_CASE(6)
      SDE_CASE(7) SDE_CASE(8) SDE_CASE(9) SDE_CASE(10) SDE_CASE(11)
      SDE_CASE(12) SDE_CASE(13) SDE_CASE(14) SDE_CASE(15) SDE_CASE(16)
#undef SDE_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

// The instance of a form with a score for the target of a launch: a
// mixture needs its table (K >= 1); the wells' count must lie in 1..D; the
// rings need d = 2 and their radii; the image d = 2 and its energy table
// (at least 3 x 3 pixels); a given score its tensor.
template <int kForm, bool kPerCoord = false>
int launch_target(const Args& a, int body, int* used) {
  const Consts& cs = a.cs;
  switch (a.target) {
    case kFunnel:
      return launch<kForm, kFunnel, 0, kPerCoord>(a, body, used);
    case kGmm:
      if (cs.K < 1 || a.gmm == nullptr) return (int)cudaErrorInvalidValue;
      return launch<kForm, kGmm, 0, kPerCoord>(a, body, used);
    case kWells:
      if (cs.t0 < 1.0f || cs.t0 > (float)a.D) return (int)cudaErrorInvalidValue;
      return launch<kForm, kWells, 0, kPerCoord>(a, body, used);
    case kRings:
      if (a.D != 2 || cs.n_tab < 1 || a.gmm == nullptr) return (int)cudaErrorInvalidValue;
      return launch<kForm, kRings, 2, kPerCoord>(a, body, used);
    case kRosenbrock:
      return launch<kForm, kRosenbrock, 0, kPerCoord>(a, body, used);
    case kImg:
      if (a.D != 2 || cs.tab_w < 3 || cs.tab_h < 3 || cs.n_tab != 0 || a.gmm == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch<kForm, kImg, 2, kPerCoord>(a, body, used);
    case kGiven:  // one step a launch (a plan needs no score)
      if ((a.gmm == nullptr && !a.dry) || cs.n_tab != 0 || a.T != 1)
        return (int)cudaErrorInvalidValue;
      return launch<kForm, kGiven, -1, kPerCoord>(a, body, used);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The instances of one form, each compiled in its own source; the
// per-coordinate sscore's (`_dim`) in sources of their own.
int launch_lerp(const Args& a, int body, int* used);
int launch_lerp_dim(const Args& a, int body, int* used);
int launch_lerp_target(const Args& a, int body, int* used);
int launch_score(const Args& a, int body, int* used);
int launch_score_dim(const Args& a, int body, int* used);
int launch_clipped(const Args& a, int body, int* used);
int launch_potential(const Args& a, int body, int* used);
int launch_cancel_drift(const Args& a, int body, int* used);
int launch_lerp_target_dim(const Args& a, int body, int* used);
int launch_cancel_drift_dim(const Args& a, int body, int* used);
int launch_lerp_prior(const Args& a, int body, int* used);
int launch_lerp_prior_dim(const Args& a, int body, int* used);
int launch_exp(const Args& a, int body, int* used);
int launch_exp_dim(const Args& a, int body, int* used);

}  // namespace sde_rollout
