"""SDEs: overdamped Langevin, the OU family (ConstOU, ScaledBM, VP) and
controlled SDEs.

Port of `sde_sampler_tpu/eq/sdes.py`. Coefficients are functions of time
built from Python-float hyperparameters; `t` may be a Python float or a
tensor (for example a (T, 1, 1) column of step times in the batched
phase-2 control evaluation), and drifts and diffusions broadcast over the
state. The `generative` flag flips the drift sign between the generative
and the inference direction.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from sde_sampler_torch.utils.common import clip_norm


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _exp(v):
    return torch.exp(v) if isinstance(v, torch.Tensor) else math.exp(v)


class SDE:
    noise_type: str = "diagonal"

    def __init__(self, terminal_t: float = 1.0):
        self.terminal_t = float(terminal_t)

    def drift(self, t, x):
        raise NotImplementedError

    def diff(self, t, x):
        raise NotImplementedError


class LangevinSDE(SDE):
    """dX = clip(σ²/2 · ∇log ρ(X)) dt + σ dW (overdamped Langevin); the
    clip is elementwise."""

    def __init__(
        self,
        target_score: Callable,
        diff_coeff: float = 1.0,
        clip_score: float | None = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.target_score = target_score
        self.diff_coeff = float(diff_coeff)
        self.clip_score = clip_score

    def drift(self, t, x):
        drift = self.target_score(x) * self.diff_coeff**2 / 2.0
        return clip_norm(drift, self.clip_score)

    def diff(self, t, x):
        return self.diff_coeff


class OU(SDE):
    """Linear-drift SDE dX = c(t)·X dt + σ(t) dW with closed-form marginals."""

    def __init__(self, generative: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.generative = generative
        self.sign = 1.0 if generative else -1.0

    def drift_coeff_t(self, t):
        raise NotImplementedError

    def diff_coeff_t(self, t):
        raise NotImplementedError

    def drift_div(self, t, x):
        return self.drift_coeff_t(t) * x.shape[-1]

    def drift_div_int(self, s, t, x):
        return self.int_drift_coeff_t(s, t) * x.shape[-1]

    def drift(self, t, x):
        return self.drift_coeff_t(t) * x

    def diff(self, t, x):
        return self.diff_coeff_t(t)

    def int_drift_coeff_t(self, s, t):
        raise NotImplementedError

    def int_diff_coeff_sq_t(self, s, t):
        raise NotImplementedError

    def marginal_params(self, t, x_init, var_init=None):
        """Mean and variance of X_t | X_0 = x_init."""
        raise NotImplementedError

    def marginal_distr(self, t, x_init, var_init=None):
        """The Gaussian law of X_t | X_0 ~ N(x_init, var_init) on x_init's device."""
        from sde_sampler_torch.distr.gauss import Gauss

        loc, var = self.marginal_params(t, x_init, var_init=var_init)
        var = torch.as_tensor(var, dtype=loc.dtype, device=loc.device)
        scale = torch.broadcast_to(torch.sqrt(var), loc.shape)
        return Gauss(
            dim=x_init.shape[-1], loc=loc, scale=scale, domain_tol=None
        ).to(loc.device)


class ConstOU(OU):
    """Constant coefficients: dX = ±a·X dt + σ dW."""

    def __init__(self, drift_coeff: float = 2.0, diff_coeff: float = 2.0, **kwargs):
        if drift_coeff < 0 or diff_coeff <= 0:
            raise ValueError("Choose non-negative drift_coeff and positive diff_coeff.")
        super().__init__(**kwargs)
        self.drift_coeff = float(drift_coeff)
        self.diff_coeff = float(diff_coeff)

    def drift_coeff_t(self, t):
        return self.sign * self.drift_coeff

    def diff_coeff_t(self, t):
        return self.diff_coeff

    def int_drift_coeff_t(self, s, t):
        return self.sign * self.drift_coeff * (t - s)

    def int_diff_coeff_sq_t(self, s, t):
        return self.diff_coeff**2 * (t - s)

    def marginal_params(self, t, x_init, var_init=None):
        drift_coeff = self.sign * self.drift_coeff
        loc = _exp(drift_coeff * t)
        var = (
            -self.diff_coeff**2
            / (2 * drift_coeff)
            * (1 - _exp(2 * drift_coeff * t))
        )
        if var_init is not None:
            var = var + loc**2 * var_init
        return loc * x_init, var


class ScaledBM(ConstOU):
    """Driftless scaled Brownian motion: dX = σ dW."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, drift_coeff=0.0, **kwargs)

    def marginal_params(self, t, x_init, var_init=None):
        var = self.diff_coeff**2 * t
        if var_init is not None:
            var = var + var_init
        return x_init, var


class VP(OU):
    """Variance-preserving SDE with a linear β-schedule; the generative
    direction runs the schedule from β_max down to β_min."""

    def __init__(
        self,
        diff_coeff_sq_min: float = 0.1,
        diff_coeff_sq_max: float = 20.0,
        scale_diff_coeff: float = 1.0,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.scale_diff_coeff = float(scale_diff_coeff)
        self.diff_coeff_sq_min = float(diff_coeff_sq_min)
        self.diff_coeff_sq_max = float(diff_coeff_sq_max)

    def _diff_coeff_sq_t(self, t):
        frac = t / self.terminal_t
        if self.generative:
            lo, hi = self.diff_coeff_sq_max, self.diff_coeff_sq_min
        else:
            lo, hi = self.diff_coeff_sq_min, self.diff_coeff_sq_max
        return lo + (hi - lo) * frac

    def drift_coeff_t(self, t):
        return self.sign * 0.5 * self._diff_coeff_sq_t(t)

    def diff_coeff_t(self, t):
        return self.scale_diff_coeff * _sqrt(self._diff_coeff_sq_t(t))

    def int_drift_coeff_t(self, s, t):
        # the trapezoid rule is exact for the linear schedule
        return (
            self.sign
            * 0.25
            * (self._diff_coeff_sq_t(t) + self._diff_coeff_sq_t(s))
            * (t - s)
        )

    def int_diff_coeff_sq_t(self, s, t):
        return (
            0.5
            * self.scale_diff_coeff**2
            * (self._diff_coeff_sq_t(t) + self._diff_coeff_sq_t(s))
            * (t - s)
        )

    def marginal_params(self, t, x_init, var_init=None):
        int_drift = self.int_drift_coeff_t(0.0, t)
        loc = _exp(int_drift)
        var = (1 - _exp(2 * int_drift)) * self.scale_diff_coeff**2
        if var_init is not None:
            var = var + loc**2 * var_init
        return loc * x_init, var


class ControlledSDE(SDE):
    """Adds σ(t)·u(t, x) to the drift of a base SDE. For an inference-
    direction base SDE the control is queried at the time-reversed instant."""

    def __init__(self, sde: OU, ctrl: Callable | None, **kwargs):
        super().__init__(terminal_t=sde.terminal_t, **kwargs)
        self.sde = sde
        self.noise_type = sde.noise_type
        self.ctrl = ctrl

    def drift(self, t, x):
        return self.f_and_g(t, x)[0]

    def diff(self, t, x):
        return self.sde.diff(t, x)

    def f_and_g(self, t, x):
        sde_diff = self.sde.diff(t, x)
        sde_drift = self.sde.drift(t, x)
        if self.ctrl is not None:
            t_ctrl = t
            if not self.sde.generative:
                t_ctrl = self.terminal_t - t
            sde_drift = sde_drift + sde_diff * self.ctrl(t_ctrl, x)
        return sde_drift, torch.broadcast_to(
            torch.as_tensor(sde_diff, dtype=x.dtype, device=x.device), x.shape
        )
