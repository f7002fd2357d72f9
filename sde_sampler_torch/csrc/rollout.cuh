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
// the state through. The IsotropicGauss prior score (loc - x) / scale^2 and
// the target scores are inline device functions:
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
// instances (kPerCoord, the lerp and score forms of kernel 1 and kernel 2)
// read a table of kTab + d columns a step, sscore[j] in column kTab + j
// (column 4 unused), and multiply coordinate j's score term by it; every
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
// instruction count, not bandwidth, set its time.
//
// Two bodies, chosen here by shape (or on request) and reported to the
// wrapper, which counts the generic one apart:
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
//   reads them with the out_layer. Each output keeps the generic body's
//   sum order (acc = bias, then fmaf over j = 0..C-1) and both bodies share
//   the target and update code, so they give the same bits.
// - rollout_generic_kernel<form, target, false>, any (C, H, d) whose
//   weights fit shared memory: one block per 16 rows, threads over (row,
//   channel) pairs, one dependent chain per output, tables read from device
//   memory each step.
// - rollout_generic_kernel<form, target, true>, the wide body, for a given
//   score too wide for that (d = 1600: the input and output layers alone
//   are 2 d C floats, 819 KB): 8 rows a block, the input and output
//   layers' weights read from device memory. It computes every output as
//   the generic body does and gives its bits.
//
// This header holds both bodies and their launch code. Each control form's
// instances (every target and d) compile in a source of their own
// (rollout_lerp.cu, rollout_lerp_target.cu, rollout_score.cu,
// rollout_clipped.cu, rollout_cancel_drift.cu, rollout_exp.cu, and the
// per-coordinate sscore's rollout_lerp_dim.cu, rollout_score_dim.cu,
// rollout_exp_dim.cu; the
// potential form's two bodies, which
// run the net's backward pass too, live whole in rollout_potential.cu),
// so that the build runs one nvcc per form side by side; rollout.cu holds
// the C entry points.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace sde_rollout {

constexpr int kRows = 16;  // batch rows per block of the generic body
constexpr int kWideRows = 8;  // batch rows per block of the wide body
constexpr int kTab = 6;    // per-step scalars, see the header

constexpr int kGenericThreads = 256;
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

// Control form and update of one instance.
constexpr int kLerpEm = 0;     // kernel 1, LerpCtrl (DIS)
constexpr int kScoreEm = 1;    // kernel 1, ScoreCtrl (PIS, EulerDDS)
constexpr int kScoreExp = 2;   // kernel 2, ScoreCtrl (DDS)
constexpr int kClippedEm = 3;  // kernel 1, ClippedCtrl (no score)
constexpr int kLerpTargetEm = 4;  // kernel 1, LerpTargetCtrl (Bridge)
constexpr int kPotentialEm = 5;   // kernel 1, PotentialCtrl (SubtrajBridge)
constexpr int kCancelDriftEm = 6;  // kernel 1, CancelDriftCtrl (langevin_init)

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
// from device memory).
struct Consts {
  float clip_model, clip_score, prior_loc, prior_var;
  float t0, t1, t2, t3;
  int K, n_tab, tab_w, tab_h;
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

// One coordinate's update from its net output `net`, its target score
// `target`, the step's scalars `st` and its sscore.
template <int kForm>
__device__ __forceinline__ float step_update(float x, float net, float target,
                                             const float* st, float sscore, float db,
                                             const Consts& cs) {
  const float drift = st[0], diff = st[1], dt = st[2], w = st[3];
  const float cscale = st[5];
  if constexpr (kForm == kLerpEm) {
    const float prior = (cs.prior_loc - x) / cs.prior_var;
    const float lerp = clip(prior + (target - prior) * w, cs.clip_score);
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

// ---------------------------------------------------------------- generic

// Floats of shared memory the generic body (wide = false) or the wide body
// (wide = true) needs: the weights (the wide body keeps the input and output
// layers' in device memory), and per row of its tile the state, net output,
// two activation rows and the target's row reductions.
__host__ __device__ constexpr size_t generic_smem_floats(int D, int C, int H, int RS, int n_tab,
                                                         bool wide) {
  return (wide ? 0 : (size_t)D * C + (size_t)C * D + D) + (size_t)H * C * C + (size_t)H * C +
         (size_t)(wide ? kWideRows : kRows) * (2 * D + 2 * C + RS) + (size_t)n_tab;
}

// A weight of the generic (kGlobal = false: shared memory) or the wide body
// (kGlobal = true: device memory, read through the read-only cache).
template <bool kGlobal>
__device__ __forceinline__ float ldw(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// kWide = false, the generic body: kRows rows a block, every weight staged
// in shared memory. kWide = true, the wide body, for a state too wide for
// that (the given-score targets at d = 1600: the input and output layers
// alone take 2 d C floats): kWideRows rows a block, the input and output
// layers' weights read from device memory, where they stay L2-resident.
// Both compute every output the same way (acc = bias, then fmaf over j in
// order), so they give the same bits. A given score (kGiven) is read from
// device memory at the tile's rows: `gmm` is the score (B, D) of this
// step's state.
template <int kForm, int kTarget, bool kWide, bool kPerCoord>
__global__ void __launch_bounds__(kGenericThreads) rollout_generic_kernel(
    const float* __restrict__ x0, const float* __restrict__ dbs,
    const float* __restrict__ tab, const float* __restrict__ temb,
    const float* __restrict__ w_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, const float* __restrict__ gmm,
    float* __restrict__ xs, float* __restrict__ x_T, int B, int D, int C, int H, int T,
    Consts cs) {
  constexpr int R = kWide ? kWideRows : kRows;
  extern __shared__ float sm[];
  const int RS = row_floats(kTarget, cs.K, D);
  const int n_gmm = cs.n_tab;
  float* s_win = sm;                                    // (D, C) input_embed weight, (in, out)
  float* s_whid = s_win + (kWide ? 0 : D * C);          // (H, C, C)
  float* s_bhid = s_whid + H * C * C;                   // (H, C)
  float* s_wout = s_bhid + H * C;                       // (C, D)
  float* s_bout = s_wout + (kWide ? 0 : C * D);         // (D)
  float* s_x = s_bout + (kWide ? 0 : D);                // (R, D) state tile
  float* s_a = s_x + R * D;                             // (R, C) activations, ping
  float* s_b = s_a + R * C;                             // (R, C) activations, pong
  float* s_out = s_b + R * C;                           // (R, D) net output
  float* s_row = s_out + R * D;                         // (R, RS) the target's row reductions
  float* s_gmm = s_row + R * RS;                        // (n_tab) the target's table
  const float* win = kWide ? w_in : s_win;
  const float* wout = kWide ? w_out : s_wout;
  const float* bout = kWide ? b_out : s_bout;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const size_t step_stride = (size_t)B * D;
  const size_t tile_off = (size_t)row0 * D;
  // the image's energy table stays in device memory; a given score is read
  // at this tile's rows, D floats a row
  const float* table = kTarget == kImg ? gmm : s_gmm;
  const float* rows = kTarget == kGiven ? gmm + tile_off : s_row;
  const int row_stride = kTarget == kGiven ? D : RS;
  // a launch of one step of a given score writes its state before the step
  // where it already lies (xs[k] is x0) only once
  const bool write_xs = xs != x0;

  if constexpr (!kWide) {
    for (int i = tid; i < D * C; i += kGenericThreads) s_win[i] = w_in[i];
    for (int i = tid; i < C * D; i += kGenericThreads) s_wout[i] = w_out[i];
    for (int i = tid; i < D; i += kGenericThreads) s_bout[i] = b_out[i];
  }
  for (int i = tid; i < H * C * C; i += kGenericThreads) s_whid[i] = w_hid[i];
  for (int i = tid; i < H * C; i += kGenericThreads) s_bhid[i] = b_hid[i];
  for (int i = tid; i < n_gmm; i += kGenericThreads) s_gmm[i] = gmm[i];
  for (int i = tid; i < R * D; i += kGenericThreads)
    s_x[i] = i < nrows * D ? x0[tile_off + i] : 0.0f;
  __syncthreads();

  for (int k = 0; k < T; ++k) {
    float* xs_k = xs + (size_t)k * step_stride + tile_off;
    if (write_xs)
      for (int i = tid; i < nrows * D; i += kGenericThreads) xs_k[i] = s_x[i];

    // the target's row reductions of this step's state
    row_phase<kTarget>(s_x, s_row, table, R, D, tid, kGenericThreads, cs);

    // input_embed(x) + timestep_embed(s) (bias folded into temb), then GELU
    const float* temb_k = temb + (size_t)k * C;
    for (int i = tid; i < R * C; i += kGenericThreads) {
      const int r = i / C, c = i - r * C;
      float acc = temb_k[c];
      for (int j = 0; j < D; ++j) acc = fmaf(ldw<kWide>(win + j * C + c), s_x[r * D + j], acc);
      s_a[i] = gelu_exact(acc);
    }
    __syncthreads();

    float* in = s_a;
    float* out = s_b;
    for (int l = 0; l < H; ++l) {
      const float* W = s_whid + (size_t)l * C * C;
      const float* bias = s_bhid + l * C;
      for (int i = tid; i < R * C; i += kGenericThreads) {
        const int r = i / C, c = i - r * C;
        const float* a = in + r * C;
        float acc = bias[c];
        for (int j = 0; j < C; ++j) acc = fmaf(W[j * C + c], a[j], acc);
        out[i] = gelu_exact(acc);
      }
      __syncthreads();
      float* tmp = in;
      in = out;
      out = tmp;
    }

    for (int i = tid; i < R * D; i += kGenericThreads) {
      const int r = i / D, c = i - r * D;
      const float* a = in + r * C;
      float acc = ldw<kWide>(bout + c);
      for (int j = 0; j < C; ++j) acc = fmaf(ldw<kWide>(wout + j * D + c), a[j], acc);
      s_out[i] = acc;
    }
    exp_phase<kTarget>(s_row, R, tid, kGenericThreads, cs);
    __syncthreads();

    const float* db_k = dbs + (size_t)k * step_stride + tile_off;
    const float* st = tab + (size_t)k * tab_cols<kPerCoord>(D);
    for (int i = tid; i < nrows * D; i += kGenericThreads) {
      const int r = i / D, j = i - r * D;
      const float target =
          target_score<kTarget>(s_x[i], j, D, rows + r * row_stride, table, cs);
      s_x[i] = step_update<kForm>(s_x[i], s_out[i], target, st,
                                  step_sscore<kPerCoord>(st, j), db_k[i], cs);
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * D; i += kGenericThreads) x_T[tile_off + i] = s_x[i];
}

// ---------------------------------------------------------------- fast

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

// Floats of shared memory the fast body needs at a given D and T, with RS
// floats of row reductions a row, a target table of n_tab floats and TS
// columns of the per-step table.
__host__ __device__ constexpr size_t fast_smem_floats(int D, int T, int RS, int n_tab, int TS) {
  return (size_t)T * kFastC + (size_t)T * TS + 2 * kFastRows * kActStride + D +
         3 * (size_t)kFastRows * D + (size_t)kFastRows * RS + (size_t)n_tab;
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
  // float4-read arrays first, each at a multiple of 4 floats
  float* s_temb = reinterpret_cast<float*>(sm4);  // (T, C)
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
                                    s_db[(k & 1) * R * D + i], cs);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nx; i += NT) x_T[tile_off + i] = s_x[i];
}

struct Args {
  const float *x0, *dbs, *tab, *temb, *w_in, *w_hid, *b_hid, *w_out, *b_out, *gmm;
  float *xs, *x_T;
  int B, D, C, H, T, target;
  bool per_coord;  // a per-coordinate sscore: the table has kTab + D columns
  Consts cs;
  cudaStream_t stream;
};

template <int kForm, int kTarget, int D, bool kPerCoord>
cudaError_t launch_fast(const Args& a) {
  const size_t smem =  // fast_fits
      sizeof(float) * fast_smem_floats(D, a.T, row_floats(kTarget, a.cs.K, D), a.cs.n_tab,
                                       tab_cols<kPerCoord>(D));
  auto kernel = rollout_fast_kernel<kForm, kTarget, D, kPerCoord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // room for two blocks per SM (B = 2048 gives 256 blocks for 132 SMs)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = (a.B + kFastRows - 1) / kFastRows;
  kernel<<<blocks, kFastThreads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.gmm,
      a.xs, a.x_T, a.B, a.T, a.cs);
  return cudaGetLastError();
}

template <int kForm, int kTarget, bool kWide, bool kPerCoord>
cudaError_t launch_generic(const Args& a) {
  const size_t smem = sizeof(float) * generic_smem_floats(
      a.D, a.C, a.H, row_floats(kTarget, a.cs.K, a.D), a.cs.n_tab, kWide);
  auto kernel = rollout_generic_kernel<kForm, kTarget, kWide, kPerCoord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = kWide ? kWideRows : kRows;
  const int blocks = (a.B + rows - 1) / rows;
  kernel<<<blocks, kGenericThreads, smem, a.stream>>>(
      a.x0, a.dbs, a.tab, a.temb, a.w_in, a.w_hid, a.b_hid, a.w_out, a.b_out, a.gmm,
      a.xs, a.x_T, a.B, a.D, a.C, a.H, a.T, a.cs);
  return cudaGetLastError();
}

// The fast body takes C = 64, H = 2, D = 1..16 and tables that fit shared
// memory; never a given score.
inline bool fast_fits(const Args& a) {
  return a.C == kFastC && a.H == kFastH && a.D >= 1 && a.D <= 16 && a.target != kGiven &&
         sizeof(float) * fast_smem_floats(a.D, a.T, row_floats(a.target, a.cs.K, a.D),
                                          a.cs.n_tab, a.per_coord ? kTab + a.D : kTab) <=
             kMaxSmem;
}

// The generic (wide = false) or wide body's shared memory fits a block.
inline bool generic_fits(const Args& a, bool wide) {
  return sizeof(float) * generic_smem_floats(a.D, a.C, a.H, row_floats(a.target, a.cs.K, a.D),
                                             a.cs.n_tab, wide) <= kMaxSmem;
}

// `body`: kByShape takes the fast body where it fits, else the generic one
// where it fits, else the wide one; kFastBody, kGenericBody or kWideBody
// asks for one (each fails on a shape it does not take). *used receives the
// body launched. kOnlyD > 0 instantiates the fast body at that D alone (a
// target of one dimension) and no wide body; kOnlyD < 0 instantiates no
// fast body (a given score) and the wide one. kPerCoord: the instances of a
// per-coordinate sscore (a.per_coord).
template <int kForm, int kTarget, int kOnlyD = 0, bool kPerCoord = false>
int launch(const Args& a, int body, int* used) {
  if (a.B <= 0 || a.T <= 0 || used == nullptr || a.per_coord != kPerCoord)
    return (int)cudaErrorInvalidValue;
  if (body != kByShape && body != kFastBody && body != kGenericBody && body != kWideBody)
    return (int)cudaErrorInvalidValue;
  const bool fits = kOnlyD >= 0 && fast_fits(a);
  const bool wide_ok = kOnlyD < 0 && generic_fits(a, true);
  if ((body == kFastBody && !fits) || (body == kWideBody && !wide_ok))
    return (int)cudaErrorInvalidValue;
  int chosen = body;
  if (body == kByShape)
    chosen = fits ? kFastBody
                  : (generic_fits(a, false) || !wide_ok ? kGenericBody : kWideBody);
  *used = chosen;
  if (chosen == kGenericBody) return (int)launch_generic<kForm, kTarget, false, kPerCoord>(a);
  if constexpr (kOnlyD < 0) {
    return (int)launch_generic<kForm, kTarget, true, kPerCoord>(a);
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
    case kGiven:
      if (a.gmm == nullptr || cs.n_tab != 0) return (int)cudaErrorInvalidValue;
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
int launch_exp(const Args& a, int body, int* used);
int launch_exp_dim(const Args& a, int body, int* used);

}  // namespace sde_rollout
