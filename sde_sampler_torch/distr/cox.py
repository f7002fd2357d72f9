"""Log-Gaussian Cox process posterior on the 40 x 40 pine-sapling grid.

Port of `sde_sampler_tpu/distr/cox.py`: the 1600-d target of the DDS
paper, an exponential-kernel Gram matrix whose Cholesky factor L and its
inverse are computed once on the host in float64 and kept in float32, the
whitened and unwhitened posterior densities, their analytic scores and the
reference log Z = 512.6 of a long SMC run. It has no sampler.

The score is two (B, d) x (d, d) products, in the JAX package's order:
the unwhitened prior's -L^-T L^-1 (x - mu) multiplies by L^-1 first, then
by L^-T; the two are never folded into one precision matrix. Any leading
batch shape is taken.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from .base import DATA_DIR, Distribution


def read_points(file_path) -> np.ndarray:
    """The (n, 2) points of the `data_x`, `data_y` columns of a csv file
    with a quoted header (pines.csv)."""
    with open(file_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r["data_x"]), float(r["data_y"])] for r in rows])


def get_bin_counts(points: np.ndarray, num_bins_per_dim: int) -> np.ndarray:
    idx = np.floor(points * num_bins_per_dim).astype(int)
    # points exactly on the upper edge belong to the last bin
    idx = np.minimum(idx, num_bins_per_dim - 1)
    counts = np.zeros((num_bins_per_dim, num_bins_per_dim))
    np.add.at(counts, (idx[:, 0], idx[:, 1]), 1.0)
    return counts


def get_bin_vals(num_bins: int) -> np.ndarray:
    grid = np.arange(num_bins)
    return np.array([[a, b] for a in grid for b in grid], dtype=np.float64)


def exponential_kernel(
    x: np.ndarray, y: np.ndarray, signal_variance: float,
    num_grid_per_dim: int, raw_length_scale: float,
) -> np.ndarray:
    dist = np.linalg.norm(x[:, None, :] - y[None, :, :], axis=2)
    dist = dist / (num_grid_per_dim * raw_length_scale)
    return signal_variance * np.exp(-dist)


class Cox(Distribution):
    def __init__(
        self,
        dim: int = 1600,
        data_path: str | Path = DATA_DIR / "pines.csv",
        use_whitened: bool = False,
    ):
        # log Z of a long SMC run (the DDS paper)
        super().__init__(dim=dim, log_norm_const=512.6)
        self.use_whitened = use_whitened
        self.num_bins_per_dim = int(np.sqrt(dim))
        if self.num_bins_per_dim**2 != self.dim:
            raise ValueError(f"the dimension {dim} is not a square")

        self.signal_variance = 1.91
        self._poisson_a = 1.0 / self.dim
        self._beta = 1.0 / 33
        self.white_gaussian_log_normalizer = float(-0.5 * self.dim * np.log(2.0 * np.pi))
        self.mu_zero = float(np.log(126.0) - 0.5 * self.signal_variance)

        bin_counts = get_bin_counts(read_points(Path(data_path)), self.num_bins_per_dim)
        bin_vals = get_bin_vals(self.num_bins_per_dim)
        gram = exponential_kernel(
            bin_vals, bin_vals, self.signal_variance, self.num_bins_per_dim, self._beta,
        )
        cholesky = np.linalg.cholesky(gram)  # float64 on the host
        self.cholesky_gram = torch.as_tensor(cholesky, dtype=torch.float32)
        self.cholesky_inv = torch.as_tensor(np.linalg.inv(cholesky), dtype=torch.float32)
        self.flat_bin_counts = torch.as_tensor(bin_counts.flatten(), dtype=torch.float32)
        half_log_det = float(np.sum(np.log(np.abs(np.diag(cholesky)))))
        self.unwhitened_gaussian_log_normalizer = (
            -0.5 * self.dim * float(np.log(2.0 * np.pi)) - half_log_det
        )

    # -- density pieces ----------------------------------------------------
    def _latents_from_white(self, white: torch.Tensor) -> torch.Tensor:
        return white @ self.cholesky_gram.T + self.mu_zero

    def _white_from_latents(self, latents: torch.Tensor) -> torch.Tensor:
        # w = L^-1 (x - mu) as rows: (x - mu) @ L^-T
        return (latents - self.mu_zero) @ self.cholesky_inv.T

    def _poisson_log_likelihood(self, latent: torch.Tensor) -> torch.Tensor:
        first = latent * self.flat_bin_counts
        second = -self._poisson_a * torch.exp(latent)
        return (first + second).sum(dim=-1)

    def whitened_posterior_log_density(self, white: torch.Tensor) -> torch.Tensor:
        prior = self.white_gaussian_log_normalizer + -0.5 * (white**2).sum(dim=-1)
        return prior + self._poisson_log_likelihood(self._latents_from_white(white))

    def unwhitened_posterior_log_density(self, latents: torch.Tensor) -> torch.Tensor:
        white = self._white_from_latents(latents)
        prior = -0.5 * (white * white).sum(dim=-1) + self.unwhitened_gaussian_log_normalizer
        return prior + self._poisson_log_likelihood(latents)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_whitened:
            return self.whitened_posterior_log_density(x)[..., None]
        return self.unwhitened_posterior_log_density(x)[..., None]

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """The analytic score."""
        if self.use_whitened:
            # -white + (counts - a exp(latent)) @ L
            like_grad = self.flat_bin_counts - self._poisson_a * torch.exp(
                self._latents_from_white(x))
            return -x + like_grad @ self.cholesky_gram
        # unwhitened: -L^-T L^-1 (x - mu) + counts - a exp(x)
        prior_grad = -self._white_from_latents(x) @ self.cholesky_inv
        like_grad = self.flat_bin_counts - self._poisson_a * torch.exp(x)
        return prior_grad + like_grad
