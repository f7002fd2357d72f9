"""Diffusion solvers: TrainableDiff, Bridge (DIS), SubtrajBridge, PIS, DDS
and EulerDDS.

Port of `TrainableDiff`, `Bridge`, `SubtrajBridge`, `PIS`, `DDS` and
`EulerDDS` from `sde_sampler_tpu/solver/oc.py`; Bridge with or without a
learned inference control (`solver=bridge_diff_init`, `bridge`; DIS), and
its log-variance training over random subtrajectories (`solver=dis_subtraj`,
`bridge_subtraj`). Evaluation computes both log Z estimators (with and
without the Ito integral) from one rollout. DDS has no SDE (`sde` is None):
its exponential integrator takes α and σ from the loss. With
`plot_results`, an evaluation also rolls out `traj_batch_size` (default
512) trajectories for the evolution plots and, for a solver with an
inference SDE and a target with a sampler, plots that SDE's trajectories
from target samples (`_inference_plots`, on rank 0 alone).

With a data-parallel group (`n_devices` > 1) the solver draws the whole
training, evaluation, trajectory and subtrajectory batches, as on one
device, and the loss keeps this rank's rows of them and of every draw, and
gathers the evaluation's rollout (`losses/oc.py`): the JAX package's
`shard_batch` calls of `compute_loss_traced`, `_eval_impl` and the
subtrajectory step land in the loss's `_enter`. Phase 1 keeps the fused
rollout on each rank's rows, where the JAX package's mesh run takes its
scan (it never wired its Pallas kernel under pjit, and the port's kernels
work row by row).

The subtrajectory window. The JAX package runs a subtrajectory on a
power-of-two bucket of the time grid, clipped to [ts[idx_init],
ts[idx_end]] so that the steps outside the window have dt = 0; those no-op
steps exist only for its compile cache (one trace per bucket length). A
dt = 0 step adds nothing to the cost or the Ito sum and leaves the state
as it is, so the port runs exactly the steps idx_init, ..., idx_end - 1 of
the grid: one rollout of that length, one kernel launch on the card.
`bucket_subtraj` is accepted and has no effect.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from sde_sampler_torch.distr.base import Distribution, sample_uniform
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.gauss import Gauss
from sde_sampler_torch.eq.integrator import EulerIntegrator
from sde_sampler_torch.eq.sdes import OU, ControlledSDE
from sde_sampler_torch.eval.plots import get_plots
from sde_sampler_torch.losses.oc import BaseOCLoss
from sde_sampler_torch.solver.base import Trainable
from sde_sampler_torch.utils.common import Results, clip_norm
from sde_sampler_torch.utils.config import instantiate
from sde_sampler_torch.utils.device import sync


class TrainableDiff(Trainable):
    """Shared plumbing for diffusion solvers."""

    def __init__(self, cfg: dict):
        super().__init__(cfg=cfg)
        self.train_batch_size: int = cfg["train_batch_size"]
        self.train_ts = instantiate(cfg["train_timesteps"], device=self.device)()
        self.eval_ts = instantiate(cfg["eval_timesteps"], device=self.device)()
        self.clip_target = cfg.get("clip_target")
        self.eval_batch_size: int = cfg["eval_batch_size"]
        self.traj_batch_size: int = min(cfg.get("traj_batch_size", 512), self.eval_batch_size)
        self.eval_integrator = EulerIntegrator()

    # -- models ---------------------------------------------------------------
    def setup_models(self):
        cfg = self.cfg
        self.prior: Distribution = instantiate(cfg["prior"]).to(self.device)
        self.sde: OU | None = instantiate(cfg.get("sde"))
        self.generative_ctrl = instantiate(
            cfg["generative_ctrl"],
            sde=self.sde,
            prior_score=self.prior.score,
            target_score=self.target.score,
        ).to(self.device)
        self.modules["generative_ctrl"] = self.generative_ctrl
        self.register_scheduled_clips("generative_ctrl", self.generative_ctrl)
        self.inference_ctrl = None

    def bound_loss(self, clips) -> BaseOCLoss:
        """The loss with the controls (and their current clips) bound."""
        ctrl = self.generative_ctrl
        gen_clips = clips.get("generative_ctrl")
        ctrls = dict(
            generative_ctrl=lambda t, x: ctrl(t, x, clips=gen_clips),
            ctrl_module=ctrl,
            ctrl_clips=gen_clips,
            group=self.group,
        )
        if self.inference_ctrl is not None:
            inference, inf_clips = self.inference_ctrl, clips.get("inference_ctrl")
            ctrls["inference_ctrl"] = lambda t, x: inference(t, x, clips=inf_clips)
        return self.loss.with_ctrls(**ctrls)

    def clipped_target_unnorm_log_prob(self, x):
        return clip_norm(self.target.unnorm_log_prob(x), self.clip_target)

    # -- loss -----------------------------------------------------------------
    def _call_loss(self, loss: BaseOCLoss, ts, x, dbs):
        raise NotImplementedError

    def _call_loss_eval(self, loss: BaseOCLoss, ts, x, return_traj=False):
        raise NotImplementedError

    def compute_loss(self, clips, x0=None, dbs=None):
        if x0 is None:
            x0 = self.prior.sample((self.train_batch_size,), generator=self.generator)
        return self._call_loss(self.bound_loss(clips), self.train_ts, x0, dbs)

    # -- evaluation -----------------------------------------------------------
    @torch.no_grad()
    def compute_results(self) -> Results:
        loss = self.bound_loss(self.current_clips())
        start_time = time.perf_counter()
        x0 = self.prior.sample((self.eval_batch_size,), generator=self.generator)
        result = self._call_loss_eval(loss, self.eval_ts, x0)
        stats = BaseOCLoss.compute_results_arrays(
            result.rnd, result.rnd_no_ito, max_rnd=loss.max_rnd
        )
        sync(self.device)
        sample_time = time.perf_counter() - start_time

        log_norm_const_preds = {
            name: float(stats[name])
            for name in (
                "log_norm_const_lb_ito",
                "log_norm_const_is",
                "log_norm_const_lb",
                "log_norm_const_lb_ito_finite",
                "log_norm_const_lb_finite",
                "log_norm_const_lb_ito_filtered",
                "log_norm_const_lb_filtered",
            )
        }
        metrics = {
            "eval/sample_time": sample_time,
            "eval/lv_loss": float(stats["lv_loss"]),
            "eval/n_nonfinite_rnd": float(stats["n_nonfinite_rnd"]),
            "eval/n_filtered_rnd": float(stats["n_filtered_rnd"]),
        }
        xs = ts = None
        if self.plot_results:  # the trajectories of the evolution plots
            x0 = self.prior.sample((self.traj_batch_size,), generator=self.generator)
            xs, ts = self._call_loss_eval(loss, self.eval_ts, x0, return_traj=True).xs, self.eval_ts
        results = Results(
            samples=result.samples,
            weights=stats["weights"],
            log_norm_const_preds=log_norm_const_preds,
            ts=ts,
            xs=xs,
            metrics=metrics,
        )
        if (self.plot_results and getattr(self, "inference_sde", None) is not None
                and hasattr(self.target, "sample")):
            results.plots.update(self.on_rank0(self._inference_plots, {}))
        return results

    def _inference_plots(self) -> dict:
        """The inference SDE's trajectories from `traj_batch_size` target
        samples (controlled by the inference control where there is one),
        plotted against the prior; keys suffixed `_inference`."""
        x_target = self.target.sample((self.traj_batch_size,), generator=self.generator)
        sde = self.inference_sde
        if self.inference_ctrl is not None:
            ctrl, clips = self.inference_ctrl, self.current_clips().get("inference_ctrl")
            sde = ControlledSDE(sde=self.inference_base_sde,
                                ctrl=lambda t, x: ctrl(t, x, clips=clips))
        xs = self.eval_integrator.integrate(sde=sde, ts=self.eval_ts, x_init=x_target,
                                            generator=self.generator, timesteps=self.eval_ts)
        plots = get_plots(
            distr=self.prior,
            samples=xs[-1],
            ts=self.eval_ts,
            xs=xs,
            marginal_dims=self.eval_marginal_dims,
            domain=self.target.domain,
            generator=self.generator,
        )
        return {f"{k}_inference": v for k, v in plots.items()}


class Bridge(TrainableDiff):
    """Time-reversal solver: DIS without an inference control, the Bridge
    with a learned one (trained beside the generative control, in its own
    parameter group)."""

    def setup_models(self):
        super().setup_models()
        cfg = self.cfg
        self.inference_base_sde: OU = instantiate(cfg["sde"], generative=False)
        self.inference_sde = self.inference_base_sde
        if cfg.get("inference_ctrl"):
            self.inference_ctrl = instantiate(
                cfg["inference_ctrl"],
                sde=self.sde,
                prior_score=self.prior.score,
                target_score=self.target.score,
            ).to(self.device)
            self.modules["inference_ctrl"] = self.inference_ctrl
            self.register_scheduled_clips("inference_ctrl", self.inference_ctrl)
            # bound to the live inference control at evaluation
            # (_inference_plots)
            self.inference_sde = ControlledSDE(sde=self.inference_base_sde, ctrl=None)
        elif not isinstance(self.prior, Gauss):
            raise ValueError("Can only be used with Gaussian prior.")
        self.loss: BaseOCLoss = instantiate(
            cfg["loss"],
            generative_ctrl=None,
            sde=self.sde,
            inference_ctrl=None,
            filter_samples=getattr(self.target, "filter", None),
        )

    def _call_loss(self, loss, ts, x, dbs):
        return loss(
            ts, x,
            self.clipped_target_unnorm_log_prob,
            initial_log_prob=self.prior.log_prob,
            dbs=dbs,
            generator=self.generator,
        )

    def _call_loss_eval(self, loss, ts, x, return_traj=False):
        return loss.eval(
            ts, x,
            self.clipped_target_unnorm_log_prob,
            initial_log_prob=self.prior.log_prob,
            return_traj=return_traj,
            generator=self.generator,
        )


class SubtrajBridge(Bridge):
    """Log-variance training over random subtrajectories.

    With probability `subtraj_prob` a step trains on the window [idx_init,
    idx_end] of the grid (host-side draws from numpy's generator at seed + 1,
    in the JAX package's order) and otherwise on the whole trajectory. A
    window starts from uniform samples on the domain (lerped from the
    prior's toward the target's at t_init / T with `lerp_domain`); its end
    log-densities are the learned potentials (`PotentialCtrl.unnorm_log_prob`,
    the generative and inference ones summed), the initial one with
    gradients and the terminal one detached, except the prior at t = 0 and
    the clipped target at t = T. The loss is scaled by the window's share
    of the grid's points. The window is run exactly (module docstring).
    """

    def __init__(self, cfg: dict):
        super().__init__(cfg=cfg)
        if not hasattr(self.generative_ctrl, "unnorm_log_prob"):
            raise ValueError("Needs an unnormalized log density.")
        if self.loss.method not in ["lv", "lv_traj"]:
            raise ValueError("Can only be used with log-variance loss.")
        if self.target.domain is None:
            raise ValueError("Need a domain for sampling.")
        self.subtraj_prob = cfg.get("subtraj_prob", 0.5)
        self.fix_terminal = cfg.get("fix_terminal", False)
        self.subtraj_steps = cfg.get("subtraj_steps")
        if self.fix_terminal and self.subtraj_steps is not None:
            raise ValueError(
                "Cannot fix subtrajectory steps with fixed terminal time."
            )
        self.lerp_domain = cfg.get("lerp_domain", True)
        self._rng = np.random.default_rng(int(cfg.get("seed", 0)) + 1)
        # the window of the step being taken (None: the whole trajectory),
        # and every window taken so far
        self._window: tuple[int, int] | None = None
        self.windows: list[tuple[int, int]] = []

    def _potential_log_prob(self, clips, t, x, detach: bool):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not detach):
            out = self.generative_ctrl.unnorm_log_prob(
                t, x, clips=clips.get("generative_ctrl"))
            if self.inference_ctrl is not None:
                out = out + self.inference_ctrl.unnorm_log_prob(
                    t, x, clips=clips.get("inference_ctrl"))
        return out

    def draw_window(self) -> tuple[int, int] | None:
        """The next step's window (idx_init, idx_end), or None for the whole
        trajectory: the JAX package's draws in its order."""
        if self._rng.random() > self.subtraj_prob:
            return None
        ts_len = self.train_ts.shape[0]
        idx_init = int(self._rng.integers(0, ts_len - 1))
        if self.fix_terminal:
            idx_end = ts_len - 1
        elif self.subtraj_steps is not None:
            idx_end = min(idx_init + int(self.subtraj_steps), ts_len - 1)
        else:
            idx_end = int(self._rng.integers(idx_init + 1, ts_len))
        return idx_init, idx_end

    def compute_subtraj_loss(self, clips, idx_init: int, idx_end: int, x0=None, dbs=None):
        """The loss of the window [idx_init, idx_end]; x0 and dbs (the
        window's idx_end - idx_init increments) override the drawn ones."""
        ts = self.train_ts
        n = ts.shape[0]
        t_init, t_end = ts[idx_init], ts[idx_end]
        if x0 is None:
            domain = self.target.domain
            if self.lerp_domain:
                w = t_init / self.sde.terminal_t
                domain = self.prior.domain + (domain - self.prior.domain) * w
            x0 = sample_uniform(domain, self.train_batch_size, generator=self.generator)

        def initial_log_prob(x):
            if idx_init == 0:
                return self.prior.log_prob(x)
            return self._potential_log_prob(clips, t_init, x, detach=False)

        def terminal_log_prob(x):
            if idx_end == n - 1:
                return self.clipped_target_unnorm_log_prob(x)
            return self._potential_log_prob(clips, t_end, x, detach=True)

        loss, metrics = self.bound_loss(clips)(
            ts[idx_init : idx_end + 1], x0, terminal_log_prob,
            initial_log_prob=initial_log_prob, dbs=dbs, generator=self.generator,
        )
        return loss * (idx_end - idx_init + 1) / n, metrics

    def compute_loss(self, clips, x0=None, dbs=None):
        if self._window is None:
            return super().compute_loss(clips, x0=x0, dbs=dbs)
        return self.compute_subtraj_loss(clips, *self._window, x0=x0, dbs=dbs)

    def step(self, x0=None, dbs=None) -> dict:
        """One optimizer step (the base step's guard, EMA and schedulers) on
        the whole trajectory or on a drawn window."""
        self._window = self.draw_window()
        if self._window is not None:
            self.windows.append(self._window)
        try:
            return super().step(x0=x0, dbs=dbs)
        finally:
            self._window = None


class PIS(TrainableDiff):
    """Path integral sampler: Dirac prior and the analytic reference
    control of the uncontrolled SDE's marginal."""

    def setup_models(self):
        super().setup_models()
        if not isinstance(self.prior, Delta):
            raise ValueError("Can only be used with dirac delta prior.")
        self.reference_distr = self.sde.marginal_distr(
            t=self.sde.terminal_t, x_init=self.prior.loc
        )
        self.loss: BaseOCLoss = instantiate(
            self.cfg["loss"],
            generative_ctrl=None,
            sde=self.sde,
            filter_samples=getattr(self.target, "filter", None),
        )
        inference_base = instantiate(self.cfg["sde"], generative=False)
        self.inference_sde = ControlledSDE(
            sde=inference_base, ctrl=self.analytic_inference_ctrl
        )

    def analytic_inference_ctrl(self, t, x):
        loc, var = self.sde.marginal_params(t, self.prior.loc)
        score = (loc - x) / var
        return self.sde.diff(t, x) * score.clamp(max=1e5)

    def _call_loss(self, loss, ts, x, dbs):
        return loss(
            ts, x,
            self.clipped_target_unnorm_log_prob,
            self.reference_distr.log_prob,
            dbs=dbs,
            generator=self.generator,
        )

    def _call_loss_eval(self, loss, ts, x, return_traj=False):
        return loss.eval(
            ts, x,
            self.clipped_target_unnorm_log_prob,
            self.reference_distr.log_prob,
            return_traj=return_traj,
            generator=self.generator,
        )


class DDS(TrainableDiff):
    """Denoising diffusion sampler with the exponential integrator."""

    def setup_models(self):
        super().setup_models()
        if not isinstance(self.prior, Gauss):
            raise ValueError("Can only be used with Gaussian prior.")
        self.reference_distr = self.prior
        self.loss: BaseOCLoss = instantiate(
            self.cfg["loss"],
            generative_ctrl=None,
            sde=self.sde,
            filter_samples=getattr(self.target, "filter", None),
        )

    _call_loss = PIS._call_loss
    _call_loss_eval = PIS._call_loss_eval


class EulerDDS(TrainableDiff):
    """DDS objectives with a plain Euler-Maruyama integrator."""

    def setup_models(self):
        super().setup_models()
        if not isinstance(self.prior, Gauss):
            raise ValueError("Can only be used with Gaussian prior.")
        self.inference_sde = instantiate(self.cfg["sde"], generative=False)
        self.reference_distr = self.sde.marginal_distr(
            self.sde.terminal_t,
            x_init=self.prior.loc,
            var_init=self.prior.scale**2,
        )
        if not (
            np.allclose(self.reference_distr.loc.cpu(), self.prior.loc.cpu())
            and np.allclose(self.reference_distr.scale.cpu(), self.prior.scale.cpu())
        ):
            raise ValueError(
                "Make sure that the Gaussian is the invariant distribution "
                "of the SDE."
            )
        self.loss: BaseOCLoss = instantiate(
            self.cfg["loss"],
            generative_ctrl=None,
            sde=self.sde,
            reference_ctrl=self.reference_ctrl,
            filter_samples=getattr(self.target, "filter", None),
        )

    def reference_ctrl(self, t, x):
        return self.sde.diff(t, x) * self.prior.score(x)

    _call_loss = PIS._call_loss
    _call_loss_eval = PIS._call_loss_eval
