"""Distribution protocol for targets and priors.

Port of `sde_sampler_tpu/distr/base.py`: unnormalized log-probability,
score (analytic override or autograd fallback), domain boxes, reference
statistics from exact sampling or Boole quadrature, and the uniform and
rejection samplers. Sampling takes an explicit `torch.Generator`; tensors
live on `self.device` (see `to`).
"""
from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Callable

import torch

EXPECTATION_FNS: dict[str, Callable] = {
    "square": lambda x: (x**2).sum(dim=-1, keepdim=True),
    "abs": lambda x: x.abs().sum(dim=-1, keepdim=True),
    "sum": lambda x: x.sum(dim=-1, keepdim=True),
    "square_minus_sum": lambda x: (x**2 - x).sum(dim=-1, keepdim=True),
}

# the port's own copies of the targets' data files (the repo's data/ is the
# JAX package's; tests/test_torch_port_img.py holds the copies equal to it)
DATA_DIR = Path(__file__).parents[1] / "data"


class Distribution:
    """Base class: subclasses implement `unnorm_log_prob` ((B,d)->(B,1)).

    Optionally: `score`, `sample(shape, generator)`, `filter`.
    """

    def __init__(
        self,
        dim: int,
        log_norm_const: float | None = None,
        domain=None,
        n_reference_samples: int | None = None,
        grid_points: int | None = None,
    ):
        self.dim = dim
        self.device = torch.device("cpu")
        self.n_reference_samples = n_reference_samples
        self.grid_points = grid_points
        self.domain = None
        self.set_domain(domain)
        self.log_norm_const = log_norm_const
        self.stddevs = None
        self.expectations: dict[str, float] = {}

    def to(self, device) -> "Distribution":
        """Move every tensor attribute (and nested distribution) to device."""
        self.device = torch.device(device)
        for name, value in vars(self).items():
            if isinstance(value, torch.Tensor):
                setattr(self, name, value.to(self.device))
            elif isinstance(value, Distribution):
                value.to(self.device)
        return self

    # -- domain ------------------------------------------------------------
    def set_domain(self, d=None):
        if d is not None:
            d = torch.as_tensor(d, dtype=torch.float32, device=self.device)
            if d.ndim == 0:
                d = torch.stack([-d, d], dim=-1)
            if d.ndim == 1:
                d = d[None, :]
            if d.shape == (1, 2):
                d = d.repeat(self.dim, 1)
            if d.shape != (self.dim, 2):
                raise ValueError(f"domain must have shape ({self.dim}, 2)")
        self.domain = d

    # -- reference statistics ---------------------------------------------
    def compute_stats_sampling(self, generator: torch.Generator | None = None):
        samples = self.sample((self.n_reference_samples,), generator=generator)
        for name, fn in EXPECTATION_FNS.items():
            if name not in self.expectations:
                self.expectations[name] = float(fn(samples).mean())
        if self.stddevs is None:
            # unbiased, as the reference's torch .std computes them
            self.stddevs = samples.std(dim=0)

    def compute_stats_integration(self):
        from sde_sampler_torch.utils import quad

        def integrate(fn):
            return quad.integrate(
                fn, dim=self.dim, N=self.grid_points, integration_domain=self.domain
            )

        if self.log_norm_const is None:
            self.log_norm_const = math.log(float(integrate(self.unnorm_pdf)))
        for name, fn in EXPECTATION_FNS.items():
            if name not in self.expectations:
                self.expectations[name] = float(integrate(lambda x: fn(x) * self.pdf(x)))
        if self.stddevs is None:
            means = torch.atleast_1d(integrate(lambda x: x * self.pdf(x)))
            self.stddevs = torch.sqrt(
                torch.atleast_1d(integrate(lambda x: (x - means) ** 2 * self.pdf(x)))
            )

    def compute_stats(self, generator: torch.Generator | None = None):
        if hasattr(self, "sample") and self.n_reference_samples is not None:
            self.compute_stats_sampling(generator)
        elif self.grid_points is not None and self.domain is not None:
            self.compute_stats_integration()
        else:
            logging.warning(
                "Cannot compute statistics for distribution `%s`",
                self.__class__.__name__,
            )

    # -- densities ---------------------------------------------------------
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        if self.log_norm_const is None:
            raise NotImplementedError
        return self.unnorm_log_prob(x) - self.log_norm_const

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_prob(x))

    def unnorm_pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.unnorm_log_prob(x))

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """∇ₓ log ρ(x) by autograd (subclasses override analytically)."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self.unnorm_log_prob(xx).sum(), xx)
        return grad

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.unnorm_log_prob(x)


def sample_uniform(
    domain: torch.Tensor, batchsize: int = 1, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Uniform samples (batchsize, dim) on the box `domain` ((dim, 2))."""
    diam = domain[:, 1] - domain[:, 0]
    rand = torch.rand(
        (batchsize, domain.shape[0]), generator=generator, device=domain.device
    )
    return domain[:, 0] + rand * diam


@torch.no_grad()
def rejection_sampling(
    shape: tuple,
    proposal: Distribution,
    target: Distribution,
    scaling: float,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Rejection sampler: proposals x ~ proposal are kept where
    u * scaling * proposal.pdf(x) < target.pdf(x), u ~ U(0, 1); rounds of
    prod(shape) * ceil(scaling) * 10 proposals until enough are kept."""
    n_samples = math.prod(shape)
    collected: list[torch.Tensor] = []
    n_collected = 0
    while n_collected < n_samples:
        n_prop = n_samples * int(math.ceil(scaling)) * 10
        samples = proposal.sample((n_prop,), generator=generator)
        unif = torch.rand(
            (samples.shape[0], 1), generator=generator, device=samples.device
        )
        unif = unif * scaling * proposal.pdf(samples)
        accepted = samples[(unif < target.pdf(samples)).squeeze(-1)]
        collected.append(accepted)
        n_collected += accepted.shape[0]
    out = torch.cat(collected)[:n_samples]
    return out.reshape(*shape, -1)
