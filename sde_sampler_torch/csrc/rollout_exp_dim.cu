// The rollout instances of kernel 2, the exponential integrator of a ScoreCtrl (DDS),
// with a per-coordinate score net (model=score_dim), for every target and d
// (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_exp_dim(const Args& a, int body, int* used) {
  return launch_target<kScoreExp, true>(a, body, used);
}

}  // namespace sde_rollout
