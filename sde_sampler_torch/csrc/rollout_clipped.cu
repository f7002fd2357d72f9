// The rollout instances of the ClippedCtrl form (DIS and PIS without a score), for
// every d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_clipped(const Args& a, int body, int* used) {
  return launch<kClippedEm, kNoTarget>(a, body, used);
}

}  // namespace sde_rollout
