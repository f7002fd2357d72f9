"""Rosenbrock global-optimisation target.

Port of `sde_sampler_tpu/distr/rosenbrock.py`: density
exp(−rosenbrock(x) / flatness) · scale with the `objective` hook, by which
the evaluation logs the objective's average and minimum over the samples.
It has no domain, sampler or reference statistics. The JAX class takes its
score by `jax.grad`; here it is analytic (`rosenbrock_score`, which the
rollout kernel's plain twin calls too), with the arithmetic that the
rollout kernel (`csrc/rollout.cuh`) inlines:

    g_j = [j < d−1] (−400 x_j)(x_{j+1} − x_j²) − 2(1 − x_j)
        + [j > 0] 200 (x_j − x_{j−1}²),        score_j = −g_j / flatness.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution


def rosenbrock_score(x: torch.Tensor, flatness: float) -> torch.Tensor:
    """∇ₓ of −rosenbrock(x) / flatness over the last axis."""
    head, tail = x[..., :-1], x[..., 1:]
    g = torch.zeros_like(x)
    g[..., :-1] = (-400.0 * head) * (tail - head * head) - 2.0 * (1.0 - head)
    g[..., 1:] = g[..., 1:] + 200.0 * (tail - head * head)
    return -g / flatness


class Rosenbrock(Distribution):
    def __init__(self, dim: int = 5, flatness: float = 1.0, scale: float = 1.0):
        super().__init__(dim=dim)
        self.flatness = float(flatness)
        self.scale = float(scale)

    @staticmethod
    def objective(x: torch.Tensor) -> torch.Tensor:
        return (
            100 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2
        ).sum(dim=-1, keepdim=True)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -Rosenbrock.objective(x) / self.flatness + math.log(self.scale)

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return rosenbrock_score(x, self.flatness)
