"""Untrained Langevin (ULA) baseline solver.

Port of `sde_sampler_tpu/solver/langevin.py`: prior samples, a rollout of
the overdamped Langevin SDE by the configured integrator over the output
grid `eval_timesteps`, then the burn-in-discarded time averages of the
expectation functions. There is nothing to train: the results carry no
weights and no log Z estimates. With `n_devices` > 1 the chains are
sharded over the ranks, as the JAX package shards them over its mesh: each
rank integrates its block of the chains, drawing every normal at the
global shape (`eq/integrator.py`), and the expectations are taken over the
chains gathered on every rank.
"""
from __future__ import annotations

import time

from sde_sampler_torch.distr.base import EXPECTATION_FNS
from sde_sampler_torch.eq.integrator import Integrator
from sde_sampler_torch.eq.sdes import LangevinSDE
from sde_sampler_torch.solver.base import Solver
from sde_sampler_torch.utils.common import Results
from sde_sampler_torch.utils.config import instantiate
from sde_sampler_torch.utils.device import sync


class LangevinSolver(Solver):
    save_attrs: list[str] = []

    def __init__(self, cfg: dict):
        super().__init__(cfg=cfg)
        self.integrator: Integrator = instantiate(cfg["integrator"])
        self.sde: LangevinSDE = instantiate(cfg["sde"], target_score=self.target.score)
        self.prior = instantiate(cfg["prior"]).to(self.device)
        self.eval_ts = instantiate(cfg["eval_timesteps"], device=self.device)()
        self.burn_steps = cfg.get("eval_expectation_burn", 0)
        if self.burn_steps >= len(self.eval_ts):
            raise ValueError("Specify more eval_steps than burn_steps.")

    def run(self) -> Results:
        start_time = time.time()
        x = self.prior.sample((self.cfg["eval_batch_size"],), generator=self.generator)
        ts = self.eval_ts
        sharded = {} if self.group is None else {"group": self.group}
        xs = self.integrator.integrate(self.sde, ts=ts, x_init=x, generator=self.generator,
                                       **sharded)
        sync(self.device)
        metrics = {"eval/sample_time": time.time() - start_time}

        exp_samples = xs[self.burn_steps:].reshape(-1, self.target.dim)
        expectation_preds = {
            name: float(fn(exp_samples).mean()) for name, fn in EXPECTATION_FNS.items()
        }
        return Results(
            samples=xs[-1],
            weights=None,
            log_norm_const_preds=None,
            ts=ts,
            xs=xs,
            metrics=metrics,
            expectation_preds=expectation_preds,
        )
