// The C entry point of the rollout kernels (rollout.cuh): kernel 1, the
// EM rollout, in its LerpCtrl, ScoreCtrl, ClippedCtrl, LerpTargetCtrl,
// PotentialCtrl, CancelDriftCtrl and LerpPriorCtrl forms, and kernel 2, the
// exponential integrator of a ScoreCtrl; every form with a score net also
// with a per-coordinate one; each over a GELU FourierMLP or, in every form
// but the PotentialCtrl's, a ReLU DenseNet.
#include "rollout.cuh"

using namespace sde_rollout;

// Floats of the target's table that the bodies stage in shared memory: the
// mixture's loc, 1/scale^2 and constants, or the rings' K radii (the
// image's energy table and a given score stay in device memory).
static int table_floats(int target, int K, int D) {
  return target == kGmm ? K * (2 * D + 1) : (target == kRings ? K : 0);
}

// One launch, as the wrapper (ops/rollout.py) fills it; a ctypes structure
// of the same fields mirrors it (ops/build.py::RolloutLaunch), so that the
// given score's one launch a step sets only the pointers that move.
//
// update 0 is kernel 1, the EM rollout: form 0 is the LerpCtrl (DIS)
// instance, 1 the ScoreCtrl one, 3 the ClippedCtrl one (target kNoTarget),
// 4 the LerpTargetCtrl one (Bridge; the prior fields unused), 5 the
// PotentialCtrl one (target kNoTarget; w_out (C, 1), b_out (1)), 6 the
// CancelDriftCtrl one, 7 the LerpPriorCtrl one (target kNoTarget). The
// prior of forms 0 and 7: its D locs and variances in device memory
// (prior_loc, prior_var; unused by the other forms). update 1 is kernel 2,
// the exponential integrator of a ScoreCtrl (DDS; form and prior unused).
// target and t0..t3 as in Consts;
// `gmm` the target's table (the mixture's, the rings' radii, the image's
// energy table of tab_h rows of tab_w pixels) or a given score (B, D), K
// its count (the mixture's components, or the radii). A given score's
// launch runs one step (T = 1); where xs is x0, the state before the step
// is not written again. score_cols is the columns of sscore a step: 1, or D
// for a per-coordinate score net (every form with a score net), whose
// table `tab` then has kTab + D columns a step. `body` as for `launch`;
// `rows`, rows a block of the generic or wide body (0: the plan's). `dry`:
// plan only, launch nothing. Out: `used`, the body, and the plan. `net`:
// kFourierNet, or kDenseNet, whose t table (T, sum of the widths + D) goes
// as `temb`, its packed weights (dense_offset) as `w_in`, its hidden layers
// as H and their widths in `widths` (C, w_hid, b_hid, w_out and b_out
// unused).
struct RolloutLaunch {
  const float *x0, *dbs, *tab, *temb, *w_in, *w_hid, *b_hid, *w_out, *b_out, *gmm;
  float *xs, *x_T;
  void* stream;
  int B, D, C, H, T, K, tab_w, tab_h, score_cols;
  int update, form, target, body, rows, dry;
  float clip_model, clip_score, t0, t1, t2, t3;
  int used, plan_rows, plan_blocks, plan_smem, plan_slice;
  int net;
  int widths[kDenseMaxLayers];
  const float *prior_loc, *prior_var;
};

extern "C" int rollout_launch(RolloutLaunch* p) {
  const int D = p->D, form = p->form, target = p->target;
  if (p->score_cols != 1 && (p->score_cols != D || D < 2)) return (int)cudaErrorInvalidValue;
  if (p->update != 0 && p->update != 1) return (int)cudaErrorInvalidValue;
  if (p->net != kFourierNet && (p->net != kDenseNet || form == kPotentialEm))
    return (int)cudaErrorInvalidValue;
  const bool prior = p->update == 0 && (form == kLerpEm || form == kLerpPriorEm);
  if (prior && (p->prior_loc == nullptr || p->prior_var == nullptr))
    return (int)cudaErrorInvalidValue;
  DenseDims dense{};
  dense.H = p->H;
  for (int l = 0; l < kDenseMaxLayers; ++l) dense.w[l] = p->widths[l];
  const bool per_coord = p->score_cols != 1;
  const bool exp = p->update == 1;
  Plan plan{0, 0, 0, 0};
  const Args a{p->x0, p->dbs, p->tab, p->temb, p->w_in, p->w_hid, p->b_hid, p->w_out, p->b_out,
               p->gmm, p->xs, p->x_T, p->B, D, p->C, p->H, p->T, target, per_coord,
               {p->clip_model, p->clip_score, p->t0, p->t1, p->t2, p->t3,
                target == kGmm ? p->K : 0, table_floats(target, p->K, D), p->tab_w, p->tab_h,
                prior ? p->prior_loc : nullptr, prior ? p->prior_var : nullptr},
               (cudaStream_t)p->stream, p->rows, p->dry != 0, &plan, p->net, dense};
  int used = 0, code = (int)cudaErrorInvalidValue;
  if (exp) {
    code = per_coord ? launch_exp_dim(a, p->body, &used) : launch_exp(a, p->body, &used);
  } else if (per_coord) {
    if (form == kLerpEm) code = launch_lerp_dim(a, p->body, &used);
    if (form == kScoreEm) code = launch_score_dim(a, p->body, &used);
    if (form == kLerpTargetEm) code = launch_lerp_target_dim(a, p->body, &used);
    if (form == kCancelDriftEm) code = launch_cancel_drift_dim(a, p->body, &used);
    if (form == kLerpPriorEm && target == kNoTarget)
      code = launch_lerp_prior_dim(a, p->body, &used);
  } else if (form == kLerpEm) {
    code = launch_lerp(a, p->body, &used);
  } else if (form == kScoreEm) {
    code = launch_score(a, p->body, &used);
  } else if (form == kLerpTargetEm) {
    code = launch_lerp_target(a, p->body, &used);
  } else if (form == kClippedEm && target == kNoTarget) {
    code = launch_clipped(a, p->body, &used);
  } else if (form == kPotentialEm && target == kNoTarget) {
    code = launch_potential(a, p->body, &used);
  } else if (form == kCancelDriftEm) {
    code = launch_cancel_drift(a, p->body, &used);
  } else if (form == kLerpPriorEm && target == kNoTarget) {
    code = launch_lerp_prior(a, p->body, &used);
  }
  p->used = used;
  p->plan_rows = plan.rows, p->plan_blocks = plan.blocks;
  p->plan_smem = plan.smem, p->plan_slice = plan.slice;
  return code;
}
