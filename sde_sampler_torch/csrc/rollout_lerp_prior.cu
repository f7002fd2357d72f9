// The rollout instances of the LerpPriorCtrl form (model=lerp_prior), with a score net
// of one output and of one per coordinate, for every d; the form reads no target
// (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_lerp_prior(const Args& a, int body, int* used) {
  return launch<kLerpPriorEm, kNoTarget>(a, body, used);
}

int launch_lerp_prior_dim(const Args& a, int body, int* used) {
  return launch<kLerpPriorEm, kNoTarget, 0, true>(a, body, used);
}

}  // namespace sde_rollout
