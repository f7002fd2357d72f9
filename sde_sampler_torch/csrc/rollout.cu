// The C entry points of the rollout kernels (rollout.cuh): kernel 1, the
// EM rollout, in its LerpCtrl, ScoreCtrl, ClippedCtrl, LerpTargetCtrl,
// PotentialCtrl and CancelDriftCtrl forms, and kernel 2, the exponential
// integrator of a ScoreCtrl; the LerpCtrl and ScoreCtrl forms of both also
// with a per-coordinate score net.
#include "rollout.cuh"

using namespace sde_rollout;

// Floats of the target's table that the bodies stage in shared memory: the
// mixture's loc, 1/scale^2 and constants, or the rings' K radii (the
// image's energy table and a given score stay in device memory).
static int table_floats(int target, int K, int D) {
  return target == kGmm ? K * (2 * D + 1) : (target == kRings ? K : 0);
}

// Kernel 1, the EM rollout: form 0 is the LerpCtrl (DIS) instance, 1 the
// ScoreCtrl one, 3 the ClippedCtrl one (target kNoTarget), 4 the
// LerpTargetCtrl one (Bridge; the prior arguments unused), 5 the
// PotentialCtrl one (target kNoTarget; w_out (C, 1), b_out (1)), 6 the
// CancelDriftCtrl one; target and t0..t3 as in Consts; `gmm` the target's
// table (the mixture's, the rings' radii, the image's energy table of
// tab_h rows of tab_w pixels) or a given score (B, D), K its count (the
// mixture's components, or the radii); `body` and `used` as for `launch`.
// A given score's launch runs one step (T = 1); where xs is x0, the state
// before the step is not written again. score_cols is the columns of sscore
// a step: 1, or D for a per-coordinate score net (the lerp and score forms
// only), whose table `tab` then has kTab + D columns a step.
extern "C" int rollout_launch(
    const float* x0, const float* dbs, const float* tab, const float* temb,
    const float* w_in, const float* w_hid, const float* b_hid,
    const float* w_out, const float* b_out, const float* gmm, float* xs, float* x_T,
    int B, int D, int C, int H, int T, int K, int tab_w, int tab_h, int score_cols,
    float clip_model, float clip_score, float prior_loc, float prior_var, float t0, float t1,
    float t2, float t3, int form, int target, int body, int* used, void* stream) {
  if (score_cols != 1 && (score_cols != D || D < 2)) return (int)cudaErrorInvalidValue;
  const bool per_coord = score_cols != 1;
  const Args a{x0, dbs, tab, temb, w_in, w_hid, b_hid, w_out, b_out, gmm, xs, x_T,
               B, D, C, H, T, target, per_coord,
               {clip_model, clip_score, prior_loc, prior_var, t0, t1, t2, t3,
                target == kGmm ? K : 0, table_floats(target, K, D), tab_w, tab_h},
               (cudaStream_t)stream};
  if (per_coord) {
    if (form == kLerpEm) return launch_lerp_dim(a, body, used);
    if (form == kScoreEm) return launch_score_dim(a, body, used);
    return (int)cudaErrorInvalidValue;
  }
  if (form == kLerpEm) return launch_lerp(a, body, used);
  if (form == kScoreEm) return launch_score(a, body, used);
  if (form == kLerpTargetEm) return launch_lerp_target(a, body, used);
  if (form == kClippedEm && target == kNoTarget) return launch_clipped(a, body, used);
  if (form == kPotentialEm && target == kNoTarget) return launch_potential(a, body, used);
  if (form == kCancelDriftEm) return launch_cancel_drift(a, body, used);
  return (int)cudaErrorInvalidValue;
}

// Kernel 2, the exponential-integrator rollout of a ScoreCtrl (DDS);
// score_cols as for kernel 1.
extern "C" int rollout_exp_launch(
    const float* x0, const float* noise, const float* tab, const float* temb,
    const float* w_in, const float* w_hid, const float* b_hid,
    const float* w_out, const float* b_out, const float* gmm, float* xs, float* x_T,
    int B, int D, int C, int H, int T, int K, int tab_w, int tab_h, int score_cols,
    float clip_model, float clip_score, float t0, float t1, float t2, float t3, int target,
    int body, int* used, void* stream) {
  if (score_cols != 1 && (score_cols != D || D < 2)) return (int)cudaErrorInvalidValue;
  const bool per_coord = score_cols != 1;
  const Args a{x0, noise, tab, temb, w_in, w_hid, b_hid, w_out, b_out, gmm, xs, x_T,
               B, D, C, H, T, target, per_coord,
               {clip_model, clip_score, 0.0f, 1.0f, t0, t1, t2, t3, target == kGmm ? K : 0,
                table_floats(target, K, D), tab_w, tab_h},
               (cudaStream_t)stream};
  return per_coord ? launch_exp_dim(a, body, used) : launch_exp(a, body, used);
}
