"""Reparametrized controls: ClippedCtrl, ScoreCtrl, CancelDriftCtrl,
LerpCtrl and its one-sided forms LerpPriorCtrl and LerpTargetCtrl, and
PotentialCtrl.

Port of `sde_sampler_tpu/models/reparam.py`. Every wrapper is an
`nn.Module` called as `ctrl(t, x, clips=None)`. Clip thresholds may be
overridden per call through the `clips` dict (keys `clip_model`,
`clip_score`), so the MultiStepParams scheduler changes them without
rebuilding anything. Note that `clip_model` clips the score-net output too.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from sde_sampler_torch.models.mlp import broadcast_time_rows


def _clip(value, max_norm):
    if max_norm is None:
        return value
    return value.clamp(-max_norm, max_norm)


def _pick(clips: dict | None, key: str, default):
    if clips is not None and clips.get(key) is not None:
        return clips[key]
    return default


class ClippedCtrl(nn.Module):
    """Plain clipped backbone control."""

    def __init__(
        self,
        base_model: nn.Module,
        clip_model: float | None = None,
        sde: Any = None,
        prior_score: Callable | None = None,
        target_score: Callable | None = None,
        **kwargs,
    ):
        super().__init__()
        self.base_model = base_model
        self.clip_model = clip_model
        self.sde = sde
        self.prior_score = prior_score
        self.target_score = target_score

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for child in self.children():
            child.reset_parameters(generator)

    def clipped_base_model(self, t, x, clips=None):
        out = self.base_model(t, x)
        return _clip(out, _pick(clips, "clip_model", self.clip_model))

    def forward(self, t, x, clips=None):
        return self.clipped_base_model(t, x, clips)


class ScoreCtrl(ClippedCtrl):
    """NN control plus scaled target score modulated by a learned t-net."""

    def __init__(
        self,
        base_model: nn.Module,
        score_model: nn.Module | None = None,
        detach_score: bool = True,
        scale_score: float = 1.0,
        clip_score: float | None = None,
        **kwargs,
    ):
        super().__init__(base_model, **kwargs)
        self.score_model = score_model
        self.detach_score = detach_score
        self.scale_score = scale_score
        self.clip_score = clip_score

    def clipped_target_score(self, t, x, clips=None):
        x = x.detach() if self.detach_score else x
        out = self.target_score(x)
        return _clip(out, _pick(clips, "clip_score", self.clip_score))

    def clipped_score_model(self, t, x, clips=None):
        out = broadcast_time_rows(self.score_model(t, x), x)
        return _clip(out, _pick(clips, "clip_model", self.clip_model))

    def forward(self, t, x, clips=None):
        ctrl = self.clipped_base_model(t, x, clips)
        score = self.scale_score * self.clipped_target_score(t, x, clips)
        if self.score_model is not None:
            score = score * self.clipped_score_model(t, x, clips)
        return ctrl + score


class CancelDriftCtrl(ScoreCtrl):
    """u = NN + (scale·score − drift)/σ; langevin_init ties scale to σ²/2,
    so that the controlled SDE starts as the Langevin dynamics of the
    target."""

    def __init__(self, base_model: nn.Module, langevin_init: bool = False, **kwargs):
        super().__init__(base_model, **kwargs)
        self.langevin_init = langevin_init

    def forward(self, t, x, clips=None):
        ctrl = self.clipped_base_model(t, x, clips)
        sde_diff = self.sde.diff(t, x)
        scale = sde_diff**2 / 2 if self.langevin_init else self.scale_score
        score = scale * self.clipped_target_score(t, x, clips)
        if self.score_model is not None:
            score = score * self.clipped_score_model(t, x, clips)
        return ctrl + (score - self.sde.drift(t, x)) / sde_diff


class LerpCtrl(ScoreCtrl):
    """u = NN + σ·lerp(prior score, target score; t/T) (DIS init)."""

    def __init__(
        self,
        base_model: nn.Module,
        hard_constrain: bool = False,
        **kwargs,
    ):
        super().__init__(base_model, **kwargs)
        self.hard_constrain = hard_constrain

    def clipped_interpolated_score(self, t, x, clips=None):
        x = x.detach() if self.detach_score else x
        target = self.target_score(x)
        prior = self.prior_score(x)
        w = t / self.sde.terminal_t
        out = prior + (target - prior) * w
        return _clip(out, _pick(clips, "clip_score", self.clip_score))

    def constrain(self, output, t):
        T = self.sde.terminal_t
        return 4 * output * (T - t) * t / T**2

    def forward(self, t, x, clips=None):
        ctrl = self.clipped_base_model(t, x, clips)
        if self.hard_constrain:
            ctrl = self.constrain(ctrl, t)
        score = self.scale_score * self.clipped_interpolated_score(t, x, clips)
        if self.score_model is not None:
            score_model = self.clipped_score_model(t, x, clips)
            if self.hard_constrain:
                score_model = self.constrain(score_model, t)
            score = score * score_model
        return ctrl + self.sde.diff(t, x) * score


class LerpPriorCtrl(LerpCtrl):
    """One-sided lerp toward the prior score (the Bridge's inference control)."""

    def clipped_interpolated_score(self, t, x, clips=None):
        x = x.detach() if self.detach_score else x
        out = (1.0 - t / self.sde.terminal_t) * self.prior_score(x)
        return _clip(out, _pick(clips, "clip_score", self.clip_score))

    def constrain(self, output, t):
        return 2 * output * t / self.sde.terminal_t


class LerpTargetCtrl(LerpCtrl):
    """One-sided lerp toward the target score (the Bridge's generative control)."""

    def clipped_interpolated_score(self, t, x, clips=None):
        x = x.detach() if self.detach_score else x
        out = t / self.sde.terminal_t * self.target_score(x)
        return _clip(out, _pick(clips, "clip_score", self.clip_score))

    def constrain(self, output, t):
        return 2 * output * (1.0 - t / self.sde.terminal_t)


class PotentialCtrl(ClippedCtrl):
    """u = σ(t)·∇ₓΦ(t, x) for the learned scalar potential Φ = clip(net).

    `unnorm_log_prob` exposes Φ, which the subtrajectory losses treat as an
    unnormalised intermediate log-density. ∇ₓΦ is a `torch.func.grad` of
    Φ's sum (the clamp's gradient is 0 where |net| > clip_model, as
    `jnp.clip`'s), so it composes with the forward-mode divergence of
    `losses.oc.divx_exact` (forward over reverse), runs under
    `torch.no_grad`, and autograd still reaches the parameters through it.
    """

    def unnorm_log_prob(self, t, x, clips=None):
        return self.clipped_base_model(t, x, clips)

    def forward(self, t, x, clips=None):
        grad = torch.func.grad(lambda xx: self.clipped_base_model(t, xx, clips).sum())(x)
        return self.sde.diff(t, x) * grad
