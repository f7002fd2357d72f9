// The rollout instances of the LerpTargetCtrl form (the Bridge's generative control)
// with a per-coordinate score net (model=lerp_dim, score_dim under solver=bridge), for
// every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_lerp_target_dim(const Args& a, int body, int* used) {
  return launch_target<kLerpTargetEm, true>(a, body, used);
}

}  // namespace sde_rollout
