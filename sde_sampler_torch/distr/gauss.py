"""Gaussian-family targets and priors: GMM, Gauss and IsotropicGauss.

Port of `sde_sampler_tpu/distr/gauss.py`: the mixture of diagonal
Gaussians with its named presets (heart, dist, fab, multi, grid, circle),
analytic log-densities, scores and sampling, and the single Gaussians as
one-component mixtures (`Gauss` with its own densities, `IsotropicGauss`
with quartile truncation). The rollout kernel (`ops/rollout.py`,
`csrc/rollout.cuh`) inlines the mixture score.
"""
from __future__ import annotations

import logging
import math
from numbers import Number

import numpy as np
import torch

from .base import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


def gmm_params(name: str = "heart", dim: int = 2):
    """Named mixture presets: (loc (K, dim), scale (K, dim), weights (K,))."""
    if name == "heart":
        loc = 1.5 * np.array(
            [
                [-0.5, -0.25],
                [0.0, -1],
                [0.5, -0.25],
                [-1.0, 0.5],
                [-0.5, 1.0],
                [0.0, 0.5],
                [0.5, 1.0],
                [1.0, 0.5],
            ]
        )
        factor = 1 / len(loc)
    elif name == "dist":
        loc = np.array([[0.0, 0.0], [2, 0.0], [0.0, 3.0], [-4, 0.0], [0.0, -5]])
        factor = math.sqrt(0.2)
    elif name in ["fab", "multi"]:
        n_mixes, loc_scaling = (40, 40) if name == "fab" else (80, 80)
        # the mode locations of the published FAB benchmark: a torch
        # generator seeded at 42
        generator = torch.Generator().manual_seed(42)
        loc = ((torch.rand((n_mixes, 2), generator=generator) - 0.5) * 2 * loc_scaling).numpy()
        factor = math.log1p(math.e)  # softplus(1.0)
    elif name == "grid":
        x_coords = np.linspace(-5, 5, 3)
        loc = np.array([[a, b] for a in x_coords for b in x_coords])
        factor = math.sqrt(0.3)
    elif name == "circle":
        freq = 2 * np.pi * np.arange(1, 9) / 8
        loc = np.stack([4.0 * np.cos(freq), 4.0 * np.sin(freq)], axis=1)
        factor = math.sqrt(0.3)
    else:
        raise ValueError("Unknown mode for the Gaussian mixture.")

    if dim > 2:
        loc = np.concatenate([loc, np.zeros((loc.shape[0], dim - 2))], axis=1)
    scale = factor * np.ones_like(loc)
    weights = np.ones(loc.shape[0])
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return f32(loc), f32(scale), f32(weights)


class GMM(Distribution):
    """Mixture of diagonal Gaussians with analytic log-prob, score and sampling."""

    def __init__(
        self,
        dim: int = 2,
        loc=None,
        scale=None,
        mixture_weights=None,
        n_reference_samples: int = int(1e7),
        name: str | None = None,
        log_norm_const: float = 0.0,
        domain_scale: float = 5,
        domain_tol: float | None = 1e-5,
        **kwargs,
    ):
        super().__init__(
            dim=dim,
            log_norm_const=log_norm_const,
            n_reference_samples=n_reference_samples,
            **kwargs,
        )
        if name is not None:
            if any(t is not None for t in [loc, scale, mixture_weights]):
                logging.warning(
                    "Ignoring loc, scale, and mixture weights since name is specified."
                )
            loc, scale, mixture_weights = gmm_params(name, dim=dim)

        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        loc, scale = torch.atleast_2d(f32(loc)), torch.atleast_2d(f32(scale))
        n_mixtures = loc.shape[0]
        if not loc.shape == scale.shape == (n_mixtures, self.dim):
            raise ValueError("Shape mismatch between loc and scale.")
        if mixture_weights is None:
            if n_mixtures > 1:
                raise ValueError("Require mixture weights.")
            mixture_weights = torch.ones(1)
        mixture_weights = f32(mixture_weights)
        if mixture_weights.shape != (n_mixtures,):
            raise ValueError("Shape mismatch for the mixture weights.")

        self.loc = loc
        self.scale = scale
        self.mixture_weights = mixture_weights
        self.log_mix_weights = torch.log(mixture_weights / mixture_weights.sum())

        if self.domain is None:
            deviation = domain_scale * self.scale.max(dim=0).values
            self.set_domain(
                torch.stack(
                    [self.loc.min(dim=0).values - deviation,
                     self.loc.max(dim=0).values + deviation],
                    dim=-1,
                )
            )
        if domain_tol is not None and (self.pdf(self.domain.T) > domain_tol).any():
            raise ValueError("domain does not satisfy tolerance at the boundary.")

    @property
    def stddevs(self):
        if self._stddevs is not None:
            return self._stddevs
        # the mixture's: E[var_k] + Var[mean_k] under the normalised weights
        w = torch.exp(self.log_mix_weights)[:, None]
        mean = (w * self.loc).sum(dim=0)
        var = (w * (self.scale**2 + self.loc**2)).sum(dim=0) - mean**2
        return torch.sqrt(var)

    @stddevs.setter
    def stddevs(self, value):
        self._stddevs = value

    def _component_log_probs(self, x: torch.Tensor) -> torch.Tensor:
        # x: (..., d) -> (..., K)
        diff = (x[..., None, :] - self.loc) / self.scale
        log_det = torch.log(self.scale).sum(dim=-1)
        return (
            -0.5 * (diff**2).sum(dim=-1)
            - log_det
            - 0.5 * self.dim * _LOG_2PI
            + self.log_mix_weights
        )

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        comp = self._component_log_probs(x)
        return torch.logsumexp(comp, dim=-1, keepdim=True) + self.log_norm_const

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        resp = torch.softmax(self._component_log_probs(x), dim=-1)  # (..., K)
        per_comp_score = (self.loc - x[..., None, :]) / self.scale**2
        return (resp[..., None] * per_comp_score).sum(dim=-2)

    def marginal(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        x = torch.as_tensor(x).reshape(-1, 1)
        w = torch.exp(self.log_mix_weights)[None]
        comp = (
            -0.5 * ((x - self.loc[None, :, dim]) / self.scale[None, :, dim]) ** 2
            - torch.log(self.scale[None, :, dim])
            - 0.5 * _LOG_2PI
        )
        return (w * torch.exp(comp)).sum(dim=-1, keepdim=True)

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        # the component by inverse CDF of the normalised weights
        cdf = torch.cumsum(torch.exp(self.log_mix_weights), dim=0)
        u = torch.rand(shape, generator=generator, device=self.device)
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(max=cdf.shape[0] - 1)
        eps = torch.randn((*shape, self.dim), generator=generator, device=self.device)
        return self.loc[idx] + self.scale[idx] * eps


class Gauss(GMM):
    """Single diagonal Gaussian with analytic log-prob, score and sampling."""

    def __init__(self, dim: int = 1, loc=0.0, scale=1.0, **kwargs):
        super().__init__(
            dim=dim,
            loc=self._prepare_input(loc, dim),
            scale=self._prepare_input(scale, dim),
            **kwargs,
        )
        self.stddevs = self.scale[0]

    @staticmethod
    def _prepare_input(param, dim: int = 1) -> torch.Tensor:
        if isinstance(param, Number):
            return torch.full((1, dim), float(param))
        param = torch.atleast_2d(torch.as_tensor(param, dtype=torch.float32))
        if param.numel() == 1:
            param = param.reshape(1, 1).repeat(1, dim)
        return param

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        log_det = torch.log(self.scale).sum(dim=-1)
        return (
            -0.5 * (z**2).sum(dim=-1, keepdim=True)
            - log_det
            - 0.5 * self.dim * _LOG_2PI
            + self.log_norm_const
        )

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return (self.loc - x) / self.scale**2

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        eps = torch.randn(
            (*shape, self.dim), generator=generator, device=self.device
        )
        return self.loc[0] + self.scale[0] * eps


class IsotropicGauss(Gauss):
    """Isotropic Gaussian prior with optional quartile truncation."""

    def __init__(
        self,
        dim: int = 1,
        loc: float = 0.0,
        scale: float = 1.0,
        truncate_quartile: float | None = None,
        **kwargs,
    ):
        loc_t, scale_t = (self._prepare_input(p, dim) for p in (loc, scale))
        if not (
            torch.allclose(loc_t, loc_t[0, 0])
            and torch.allclose(scale_t, scale_t[0, 0])
        ):
            raise ValueError("IsotropicGauss needs a scalar loc and scale.")
        # host floats: the densities and scores never read a device scalar
        self.loc0 = float(loc_t[0, 0])
        self.scale0 = float(scale_t[0, 0])
        super().__init__(dim=dim, loc=loc_t, scale=scale_t, **kwargs)

        if truncate_quartile is not None:
            # normal inverse CDF at the two quartiles, in float32 as in JAX
            quartiles = torch.tensor(
                [truncate_quartile / 2, 1 - truncate_quartile / 2]
            )
            icdf = self.loc0 + self.scale0 * math.sqrt(2.0) * torch.special.erfinv(
                2 * quartiles - 1
            )
            truncate_quartile = [float(icdf[0]), float(icdf[1])]
        self.truncate_quartile = truncate_quartile

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = self.scale0**2
        norm_const = -0.5 * self.dim * math.log(2.0 * math.pi * var)
        norm_const += self.log_norm_const
        sq_sum = ((x - self.loc0) ** 2).sum(dim=-1, keepdim=True)
        return norm_const - 0.5 * sq_sum / var

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return (self.loc0 - x) / self.scale0**2

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        if self.truncate_quartile is None:
            return super().sample(shape, generator)
        # inverse-CDF truncated normal, the construction of
        # jax.random.truncated_normal
        lower, upper = (
            (b - self.loc0) / self.scale0 for b in self.truncate_quartile
        )
        a = math.erf(lower / math.sqrt(2.0))
        b = math.erf(upper / math.sqrt(2.0))
        u = torch.rand(
            (*shape, self.dim), generator=generator, device=self.device
        )
        z = math.sqrt(2.0) * torch.special.erfinv(a + (b - a) * u)
        z = z.clamp(
            math.nextafter(lower, math.inf), math.nextafter(upper, -math.inf)
        )
        return self.loc0 + self.scale0 * z
