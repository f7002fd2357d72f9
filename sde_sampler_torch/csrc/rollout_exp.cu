// The rollout instances of kernel 2, the exponential integrator of a ScoreCtrl (DDS),
// for every target and d (rollout.cuh).
#include "rollout.cuh"

namespace sde_rollout {

int launch_exp(const Args& a, int body, int* used) {
  return launch_target<kScoreExp>(a, body, used);
}

}  // namespace sde_rollout
