"""Boole's-rule grid quadrature on a box.

Port of `sde_sampler_tpu/utils/quad.py`: the composite Boole rule on a
tensor-product grid of m = 4k + 1 points per dimension, in float32. The
distributions use it for their reference statistics (normalising
constants, expectations, standard deviations) on their domain boxes. Large
grids are evaluated in chunks, so that a multi-million-point 2-d grid never
lies in memory at once.
"""
from __future__ import annotations

from typing import Callable

import torch

_BOOLE_W = torch.tensor([7.0, 32.0, 12.0, 32.0, 7.0]) * 2.0 / 45.0


def _points_per_dim(n_total: int, dim: int) -> int:
    """About n_total ** (1 / dim) points per dimension, at least 5 and
    snapped up to the next m with (m - 1) % 4 == 0."""
    m = int(round(n_total ** (1.0 / dim)))
    m = max(m, 5)
    if (m - 1) % 4 != 0:
        m = m + (4 - (m - 1) % 4)
    return m


def _boole_weights_1d(m: int, h: float, device=None) -> torch.Tensor:
    """Composite Boole weights for m = 4k + 1 points with spacing h: the
    panels' weights, added where two panels share a point."""
    w = torch.zeros(m, device=device)
    n_panels = (m - 1) // 4
    base = _BOOLE_W.to(device)
    for offset in range(5):
        w[offset : offset + 4 * n_panels : 4] += base[offset]
    return w * h


def integrate(
    fn: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    N: int,
    integration_domain: torch.Tensor,
    chunk: int = 1 << 18,
) -> torch.Tensor:
    """Integrate fn over the box `integration_domain` ((dim, 2)).

    fn maps (B, dim) -> (B,), (B, 1) or (B, k); returns a scalar (or (k,)).
    """
    domain = torch.as_tensor(integration_domain, dtype=torch.float32)
    if domain.shape != (dim, 2):
        raise ValueError(f"integration_domain must have shape ({dim}, 2)")
    device = domain.device
    m = _points_per_dim(N, dim)
    grids, weights = [], []
    for d in range(dim):
        a, b = float(domain[d, 0]), float(domain[d, 1])
        grids.append(torch.linspace(a, b, m, device=device))
        weights.append(_boole_weights_1d(m, (b - a) / (m - 1), device))
    if dim == 1:
        x, w = grids[0][:, None], weights[0]
    else:
        x = torch.stack([g.reshape(-1) for g in torch.meshgrid(*grids, indexing="ij")], -1)
        wmesh = torch.meshgrid(*weights, indexing="ij")
        w = wmesh[0]
        for d in range(1, dim):
            w = w * wmesh[d]
        w = w.reshape(-1)

    total = None
    for start in range(0, x.shape[0], chunk):
        xc, wc = x[start : start + chunk], w[start : start + chunk]
        vals = fn(xc).reshape(xc.shape[0], -1)
        part = (wc[:, None] * vals).sum(dim=0)
        total = part if total is None else total + part
    return total.squeeze()
