// The rollout instances of the LerpCtrl form (DIS) with a per-coordinate score net
// (model=lerp_dim), for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_lerp_dim(const Args& a, int body, int* used) {
  return launch_target<kLerpEm, true>(a, body, used);
}

}  // namespace sde_rollout
