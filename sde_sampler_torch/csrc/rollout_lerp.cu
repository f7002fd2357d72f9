// The rollout instances of the LerpCtrl form (DIS), for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_lerp(const Args& a, int body, int* used) {
  return launch_target<kLerpEm>(a, body, used);
}

}  // namespace sde_rollout
