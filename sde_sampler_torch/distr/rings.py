"""Concentric-rings 2-d target.

Port of `sde_sampler_tpu/distr/rings.py`: density
exp(-scale · min_i (|x| − r_i)²), its analytic score, statistics and
marginals by Boole quadrature on the domain, and a boundary-tolerance check
of the domain. It has no sampler. The score (`rings_score`, which the
rollout kernel's plain twin calls too) rounds every operation on its own,
as the rollout kernel (`csrc/rollout.cuh`) computes it inline.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution


def rings_score(x: torch.Tensor, radii: torch.Tensor, scale: float, eps: float) -> torch.Tensor:
    """-2·scale·(1 − c/(|x| + eps))·x with c the radius nearest |x| (the
    first on ties), over any leading batch shape; |x|² summed coordinate by
    coordinate."""
    sq = x[..., 0] * x[..., 0]
    for j in range(1, x.shape[-1]):
        sq = sq + x[..., j] * x[..., j]
    radius = torch.sqrt(sq)[..., None]
    nearest = torch.square(radius - radii).argmin(dim=-1, keepdim=True)
    return (-2.0 * scale) * (1.0 - radii[nearest] / (radius + eps)) * x


class Rings(Distribution):
    def __init__(
        self,
        dim: int = 2,
        lower_rad: float = 1.0,
        upper_rad: float = 5.0,
        num_rad: int = 3,
        scale: float = 100.0,
        grid_points: int = 2001**2,
        scale_domain: float = 10.0,
        domain_tol: float | None = 1e-5,
        eps: float = 1e-8,
        **kwargs,
    ):
        if dim != 2:
            raise ValueError("The rings should be two-dimensional.")
        super().__init__(dim=dim, grid_points=grid_points, **kwargs)
        self.r_centers = torch.linspace(lower_rad, upper_rad, num_rad)
        self.scale = scale
        self.eps = eps

        self.domain_tol = domain_tol
        if self.domain is None:
            self.set_domain(
                float(self.r_centers.max()) + scale_domain / math.sqrt(self.scale / 2)
            )

    def compute_stats(self, generator: torch.Generator | None = None):
        super().compute_stats(generator)
        if self.domain_tol is not None and (self.pdf(self.domain.T) > self.domain_tol).any():
            raise ValueError("Domain does not satisfy tolerance at the boundary.")

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        radius = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return -self.scale * torch.square(radius - self.r_centers).min(
            dim=-1, keepdim=True).values

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return rings_score(x, self.r_centers, self.scale, self.eps)

    def marginal(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        from sde_sampler_torch.utils import quad

        x = torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(-1, 1)

        def integrand(y: torch.Tensor) -> torch.Tensor:
            # y (B, 1), the integration variable, paired with each query point
            xs = x[None].expand(y.shape[0], -1, -1)
            ys = y[:, None, :].expand(-1, x.shape[0], -1)
            grid = torch.cat([xs, ys] if dim == 0 else [ys, xs], dim=-1)
            return self.pdf(grid.reshape(-1, 2)).reshape(y.shape[0], x.shape[0])

        integral = quad.integrate(
            integrand, dim=1, N=2001, integration_domain=self.domain[dim][None]
        )
        return integral.reshape(-1, 1)
