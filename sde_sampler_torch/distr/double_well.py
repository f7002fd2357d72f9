"""Double-well and product multi-well targets.

Port of `sde_sampler_tpu/distr/double_well.py`: the 1-d quartic well
exp(-((x - shift)² - separation)²) with its analytic score, statistics by
Boole quadrature and a GMM-proposal rejection sampler, and MultiWell =
(n double wells) ⊗ (d - n unit Gaussians at the shift) with factorised
statistics. The rollout kernel (`ops/rollout.py`, `csrc/rollout.cuh`)
inlines the same score. `DoubleWell.plots` draws the rejection sampler's
diagnostic.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution, rejection_sampling
from .gauss import GMM, IsotropicGauss


class DoubleWell(Distribution):
    def __init__(
        self,
        dim: int = 1,
        separation: float = 2.0,
        shift: float = 0.0,
        grid_points: int = 2001,
        rejection_sampling_scaling: float = 3.0,
        domain_delta: float = 2.5,
        **kwargs,
    ):
        if not dim == 1:
            raise ValueError("`dim` needs to be `1`. Consider using `MultiWell`.")
        super().__init__(dim=1, grid_points=grid_points, **kwargs)
        self.rejection_sampling_scaling = rejection_sampling_scaling
        self.separation = float(separation)
        self.shift = float(shift)

        if self.domain is None:
            half_width = math.sqrt(self.separation) + domain_delta
            self.set_domain(self.shift + half_width * torch.tensor([[-1.0, 1.0]]))

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = x - self.shift
        return -((x**2 - self.separation) ** 2)

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        x = x - self.shift
        return -4.0 * (x**2 - self.separation) * x

    def marginal(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.pdf(x)

    def get_proposal_distr(self) -> GMM:
        root = math.sqrt(self.separation)
        loc = self.shift + root * torch.tensor([[-1.0], [1.0]])
        scale = (1.0 / root) * torch.ones((2, 1))
        return GMM(
            dim=1, loc=loc, scale=scale, mixture_weights=torch.ones(2), domain_tol=None
        ).to(self.device)

    def sample(self, shape=None, generator: torch.Generator | None = None):
        return rejection_sampling(
            tuple(shape or ()),
            target=self,
            proposal=self.get_proposal_distr(),
            scaling=self.rejection_sampling_scaling,
            generator=generator,
        )

    def plots(self, samples, nbins: int = 100) -> dict:
        """Rejection-sampling diagnostic: the histogram of as many exact
        samples (from a generator seeded 0) against the density and the
        scaled proposal."""
        import numpy as np

        from sde_sampler_torch.eval.plots import plot_marginal, to_numpy

        generator = torch.Generator(device=self.device).manual_seed(0)
        gt = self.sample((samples.shape[0],), generator=generator)
        pdf = lambda x, **kw: self.pdf(torch.as_tensor(x, dtype=torch.float32,
                                                       device=self.device))
        fig = plot_marginal(x=gt, marginal=pdf, dim=0, nbins=nbins, domain=self.domain)
        ax = fig.axes[0]
        x = np.linspace(*to_numpy(self.domain)[0], nbins)
        proposal = self.get_proposal_distr().pdf(
            torch.as_tensor(x[:, None], dtype=torch.float32, device=self.device))
        y = to_numpy(proposal) * self.rejection_sampling_scaling
        ax.plot(x, y.squeeze(-1), "r--", label="proposal")
        ax.legend()
        return {"plots/rejection_sampling": fig}


class MultiWell(Distribution):
    """Product of `n_double_wells` quartic wells and (d - n) unit Gaussians."""

    def __init__(
        self,
        dim: int = 2,
        n_double_wells: int = 1,
        separation: float = 2.0,
        shift: float = 0.0,
        domain_dw_delta: float = 2.5,
        domain_gauss_scale: float = 5.0,
        **kwargs,
    ):
        super().__init__(dim=dim, **kwargs)
        self.separation = separation
        if n_double_wells > dim or n_double_wells == 0:
            raise ValueError(f"Please specify between 1 and {dim} double wells.")
        self.n_double_wells = n_double_wells
        self.n_gauss = self.dim - self.n_double_wells

        self.double_well = DoubleWell(
            separation=separation, shift=shift, domain_delta=domain_dw_delta
        )
        domain = self.double_well.domain.repeat(self.n_double_wells, 1)
        self.gauss = None
        if self.n_gauss > 0:
            self.gauss = IsotropicGauss(
                dim=self.n_gauss,
                loc=shift,
                log_norm_const=0.5 * math.log(2.0 * math.pi) * self.n_gauss,
                domain_scale=domain_gauss_scale,
            )
            domain = torch.cat([domain, self.gauss.domain])
        self.set_domain(domain)

    def compute_stats(self, generator: torch.Generator | None = None):
        self.double_well.compute_stats()
        self.log_norm_const = self.double_well.log_norm_const * self.n_double_wells
        self.expectations = {
            name: exp * self.n_double_wells
            for name, exp in self.double_well.expectations.items()
        }
        self.stddevs = torch.cat([self.double_well.stddevs] * self.n_double_wells)
        if self.gauss is not None:
            self.gauss.compute_stats(generator)
            self.log_norm_const += self.gauss.log_norm_const
            for name in self.expectations:
                # the expectation functions sum over coordinates, so they add
                self.expectations[name] += self.gauss.expectations[name]
            self.stddevs = torch.cat([self.stddevs, self.gauss.stddevs])
        if not (self.pdf(self.domain.T) < 1e-5).all():
            raise ValueError("domain does not satisfy tolerance at the boundary.")

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_double_wells
        log_prob = self.double_well.unnorm_log_prob(x[..., :n]).sum(dim=-1, keepdim=True)
        if self.gauss is not None:
            log_prob = log_prob + self.gauss.unnorm_log_prob(x[..., n:])
        return log_prob

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        n = self.n_double_wells
        score = self.double_well.score(x[..., :n])
        if self.gauss is not None:
            score = torch.cat([score, self.gauss.score(x[..., n:])], dim=-1)
        return score

    def marginal(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if dim < self.n_double_wells:
            return self.double_well.marginal(x)
        return self.gauss.marginal(x)

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        samples = self.double_well.sample(
            shape + (self.n_double_wells,), generator
        ).squeeze(-1)
        if self.gauss is not None:
            samples = torch.cat([samples, self.gauss.sample(shape, generator)], dim=-1)
        return samples
