// The rollout instances of the LerpTargetCtrl form (the Bridge's generative
// control), for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_lerp_target(const Args& a, int body, int* used) {
  return launch_target<kLerpTargetEm>(a, body, used);
}

}  // namespace sde_rollout
