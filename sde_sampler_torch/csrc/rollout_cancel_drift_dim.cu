// The rollout instances of the CancelDriftCtrl form of kernel 1 (model=langevin_init)
// with a per-coordinate score net, whose column replaces the clipped score net in the
// sscore slot, for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_cancel_drift_dim(const Args& a, int body, int* used) {
  return launch_target<kCancelDriftEm, true>(a, body, used);
}

}  // namespace sde_rollout
