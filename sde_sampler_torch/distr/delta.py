"""Dirac-delta prior, approximated by a Gaussian of tiny scale.

Port of `sde_sampler_tpu/distr/delta.py` (the prior of the PIS solver):
densities and scores are those of N(loc, approx_scale²); sampling returns
the point `loc` itself.
"""
from __future__ import annotations

import torch

from .gauss import Gauss


class Delta(Gauss):
    def __init__(
        self,
        dim: int = 1,
        loc=0.0,
        approx_scale: float = 1e-3,
        domain_scale: float = 10,
        **kwargs,
    ):
        super().__init__(
            dim=dim,
            loc=loc,
            scale=approx_scale,
            domain_scale=domain_scale,
            **kwargs,
        )

    def sample(self, shape=None, generator: torch.Generator | None = None):
        shape = tuple(shape or ())
        if not shape:
            return self.loc[0].clone()
        return self.loc.repeat(*shape, 1)
