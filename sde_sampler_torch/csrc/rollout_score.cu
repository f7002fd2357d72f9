// The rollout instances of the ScoreCtrl form of kernel 1 (PIS, EulerDDS), for every
// target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_score(const Args& a, int body, int* used) {
  return launch_target<kScoreEm>(a, body, used);
}

}  // namespace sde_rollout
