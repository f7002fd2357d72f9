// The rollout instances of the ScoreCtrl form of kernel 1 (PIS, EulerDDS) with a
// per-coordinate score net (model=score_dim), for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_score_dim(const Args& a, int body, int* used) {
  return launch_target<kScoreEm, true>(a, body, used);
}

}  // namespace sde_rollout
