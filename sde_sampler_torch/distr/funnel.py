"""Neal's funnel target (d=10 default).

Port of `sde_sampler_tpu/distr/funnel.py`: x₀ ~ N(0, σ²),
x_i | x₀ ~ N(0, exp(x₀)); analytic score, exact sampler, domain and
marginals.
The rollout kernel (`ops/rollout.py`, `csrc/rollout.cuh`) inlines the same
score formula.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution
from .gauss import IsotropicGauss

_LOG_2PI = math.log(2.0 * math.pi)


class Funnel(Distribution):
    def __init__(
        self,
        dim: int = 10,
        variance: float | None = None,
        n_reference_samples: int = int(1e7),
        log_norm_const: float = 0.0,
        domain_first_scale: float = 5.0,
        domain_other_scale: float = 5.0,
        domain_tol: float | None = 1e-5,
        **kwargs,
    ):
        super().__init__(
            dim=dim,
            log_norm_const=log_norm_const,
            n_reference_samples=n_reference_samples,
            **kwargs,
        )
        self.variance = variance if variance is not None else self.dim - 1
        self.distr_first = IsotropicGauss(
            dim=1,
            scale=math.sqrt(self.variance),
            domain_scale=domain_first_scale,
            domain_tol=domain_tol,
        )

        if self.domain is None:
            first = self.distr_first.domain
            domain_other = torch.sign(first) * torch.exp(
                first.abs() / domain_other_scale
            )
            self.set_domain(
                torch.cat([first, domain_other.repeat(self.dim - 1, 1)])
            )
        if domain_tol is not None and (self.pdf(self.domain.T) > domain_tol).any():
            raise ValueError("Domain does not satisfy tolerance at the boundary.")

    @staticmethod
    def log_prob_other(x_other: torch.Tensor, x_first: torch.Tensor) -> torch.Tensor:
        norm_const = -x_other.shape[-1] * (x_first + _LOG_2PI) / 2.0
        x_sq_sum = (x_other**2).sum(dim=-1, keepdim=True)
        return norm_const - 0.5 * x_sq_sum * torch.exp(-x_first)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x_first = x[:, 0:1]
        log_prob_first = self.distr_first.unnorm_log_prob(x_first)
        log_prob_other = Funnel.log_prob_other(x[:, 1:], x_first)
        return log_prob_first + log_prob_other + self.log_norm_const

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        x_first = x[..., 0:1]
        x_other = x[..., 1:]
        inv_var_other = torch.exp(-x_first)
        score_first = self.distr_first.score(x_first) - 0.5 * x_other.shape[-1]
        score_first = score_first + 0.5 * (x_other**2).sum(
            dim=-1, keepdim=True
        ) * inv_var_other
        score_other = -x_other * inv_var_other
        return torch.cat([score_first, score_other], dim=-1)

    def marginal(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The density of coordinate `dim` at x (Q points): exact for the
        first, a Monte Carlo mean over min(n_reference_samples, 1e6) draws
        of the first coordinate (from a generator seeded 0) for the others."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, 1)
        if dim == 0:
            return self.distr_first.marginal(x)
        n_mc = min(self.n_reference_samples or 10**6, 10**6)
        generator = torch.Generator(device=self.device).manual_seed(0)
        # (n_mc, 1, 1): broadcasts against the (Q, 1) query points
        samples_first = self.distr_first.sample((n_mc, 1), generator=generator)
        return torch.exp(Funnel.log_prob_other(x, samples_first)).mean(dim=0)

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        samples_first = self.distr_first.sample(shape, generator)
        samples_other = torch.randn(
            (*shape, self.dim - 1), generator=generator, device=self.device
        )
        return torch.cat(
            (samples_first, samples_other * torch.exp(0.5 * samples_first)),
            dim=-1,
        )
