// The rollout instances of the CancelDriftCtrl form of kernel 1 (model=langevin_init),
// for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_cancel_drift(const Args& a, int body, int* used) {
  return launch_target<kCancelDriftEm>(a, body, used);
}

}  // namespace sde_rollout
