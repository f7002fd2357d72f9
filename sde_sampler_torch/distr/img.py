"""2-d density defined by a grayscale image (the labrador by default).

Port of `sde_sampler_tpu/distr/img.py` with its plots: crop, white
cutoff and a stack of Gaussian blurs build an energy grid on the host
(numpy and scipy); the density is the gradient-interpolated pixel energy
with a quadratic penalty outside the image; sampling draws pixels from the
normalised density by inverse CDF, with uniform sub-pixel jitter.

The pixels come from `sde_sampler_torch/data/labrador_rgb.npz`, the
decode of `data/labrador.jpg` that `scripts/decode_labrador.py` made with
matplotlib (the decoder the JAX package calls), so that no image library is
needed.

The JAX package casts the pixel coordinate x·scale + mean to int32 the way
XLA does: saturating, NaN to 0. Torch's cast does not saturate, so
`to_int32` reproduces XLA's explicitly, and the outside penalty's integer
arithmetic wraps at 32 bits as JAX's does. The score (`img_score`, which
the rollout kernel's plain twin calls too) rounds the product and the sum
of x·scale + mean apart, as the kernel (`csrc/rollout.cuh`) does.
"""
from __future__ import annotations

import math
from collections.abc import Sequence
from pathlib import Path

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from .base import DATA_DIR, Distribution

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: towards zero, saturating at the
    int32 range, NaN to 0; as int64 values."""
    v = torch.nan_to_num(v, nan=0.0).clamp(float(_I32_MIN), float(2**31))
    return v.to(torch.int64).clamp(_I32_MIN, _I32_MAX)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's-complement arithmetic."""
    return (v - _I32_MIN) % 2**32 + _I32_MIN


def _pixels(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor):
    xs = x * scale + mean
    return xs, to_int32(xs)


def _energy_gradient(energy: torch.Tensor, i: torch.Tensor):
    """Centred differences of the energy table at the clipped pixel:
    (ix_in, iy_in, dE/dx, dE/dy)."""
    ix_in = i[..., 0].clamp(1, energy.shape[1] - 2)
    iy_in = i[..., 1].clamp(1, energy.shape[0] - 2)
    dedx = 0.5 * (energy[iy_in, ix_in + 1] - energy[iy_in, ix_in - 1])
    dedy = 0.5 * (energy[iy_in + 1, ix_in] - energy[iy_in - 1, ix_in])
    return ix_in, iy_in, dedx, dedy


def img_score(x: torch.Tensor, energy: torch.Tensor, mean: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """-(dE/dx, dE/dy)·scale over any leading batch shape (the energy is
    linear in the sub-pixel offsets; the outside penalty depends on x only
    through the integer cast)."""
    _, i = _pixels(x, mean, scale)
    _, _, dedx, dedy = _energy_gradient(energy, i)
    return -torch.stack([dedx, dedy], dim=-1) * scale


class Img(Distribution):
    def __init__(
        self,
        dim: int = 2,
        mean: Sequence[int] = (350, 350),
        scale: Sequence[int] = (100, 100),
        outside_penalty: float = 1.0,
        path: str | Path = DATA_DIR / "labrador_rgb.npz",
        embed: Sequence[int] | None = None,
        crop: Sequence[int] = (10, 710, 240, 940),
        white_cutoff: float = 225.0,
        gauss_sigma: float = 3.0,
        background: float = 0.01,
        domain=3.5,
        n_reference_samples: int = int(1e7),
        **kwargs,
    ):
        super().__init__(dim=dim, domain=domain, n_reference_samples=n_reference_samples,
                         **kwargs)
        self.path = Path(path)
        if self.path.suffix != ".npz":
            raise ValueError(
                f"{self.path}: the port reads decoded pixels (.npz with key 'rgb'); "
                "scripts/decode_labrador.py makes them from a JPEG"
            )
        self.outside_penalty = outside_penalty

        img = np.load(self.path)["rgb"].mean(axis=2).astype(np.float32)
        img[img > white_cutoff] = 255
        img /= img.max()
        if crop is not None:
            img = img[crop[0]: crop[1], crop[2]: crop[3]]
        if embed is not None:
            tmp = np.ones((embed[0], embed[1]), dtype=np.float32)
            sx = (embed[0] - img.shape[0]) // 2
            sy = (embed[1] - img.shape[1]) // 2
            tmp[sx: img.shape[0] + sx, sy: img.shape[1] + sy] = img
            img = tmp

        img_blur = gaussian_filter(img, sigma=gauss_sigma)
        density = (1.0 - img_blur) + background * (
            gaussian_filter(img, sigma=10)
            + gaussian_filter(img, sigma=20)
            + gaussian_filter(img, sigma=50)
        )
        density = density[::-1]
        energy = -np.log(density)
        energy -= energy.min()

        density_normed = density.astype(np.float64)
        density_normed /= density_normed.sum()
        self.log_density_flat = torch.as_tensor(
            np.log(density_normed.flatten()), dtype=torch.float32)
        # the inverse-CDF table of the pixels, in float32 as the JAX package's
        self.density_cdf = torch.as_tensor(
            np.cumsum(density_normed.flatten()), dtype=torch.float32)
        self.pixel_energy = torch.as_tensor(np.ascontiguousarray(energy), dtype=torch.float32)
        self.maxindex_x = self.pixel_energy.shape[1] - 1
        self.maxindex_y = self.pixel_energy.shape[0] - 1
        self.mean = torch.as_tensor(mean, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32)

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        xs, i = _pixels(x, self.mean, self.scale)
        ix, iy = i[..., 0], i[..., 1]
        dx = xs[..., 0] - ix.to(torch.float32)
        dy = xs[..., 1] - iy.to(torch.float32)
        # gradient-interpolated energy at the closest inside pixel
        ix_in, iy_in, dedx, dedy = _energy_gradient(self.pixel_energy, i)
        e0 = self.pixel_energy[iy_in, ix_in]
        image_energy = (e0 + dx * dedx + dy * dedy)[..., None]
        # quadratic penalty outside the image, in JAX's int32 arithmetic;
        # squared in float (int32 squares wrap)
        zero = torch.zeros_like(ix)
        pen_x = torch.maximum(torch.maximum(wrap32(-ix), zero),
                              torch.maximum(wrap32(ix - self.maxindex_x), zero))
        pen_y = torch.maximum(torch.maximum(wrap32(-iy), zero),
                              torch.maximum(wrap32(iy - self.maxindex_y), zero))
        pen_x, pen_y = pen_x.to(torch.float32), pen_y.to(torch.float32)
        penalty = (self.outside_penalty * (pen_x**2 + pen_y**2))[..., None]
        return -image_energy - penalty

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """The analytic score (`img_score`)."""
        return img_score(x, self.pixel_energy, self.mean, self.scale)

    def sample_from_uniforms(self, u: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        """Samples from uniforms: u (n,) picks the pixels by inverse CDF (the
        first whose cumulative mass exceeds u, clipped to the last), jitter
        (..., 2) in [0, 1) places each inside its pixel; shape jitter's."""
        width = self.pixel_energy.shape[1]
        i = torch.searchsorted(self.density_cdf, u, right=True).clamp(
            0, self.density_cdf.shape[0] - 1)
        ixy = torch.stack([i % width, i // width], dim=-1).reshape(jitter.shape)
        xy = ixy.to(torch.float32) + jitter - 0.5
        return (xy - self.mean) / self.scale

    def sample(self, shape=None, generator: torch.Generator | None = None) -> torch.Tensor:
        shape = tuple(shape or ())
        n = math.prod(shape)
        u = torch.rand((n,), generator=generator, device=self.device)
        jitter = torch.rand((*shape, 2), generator=generator, device=self.device)
        return self.sample_from_uniforms(u, jitter)

    # -- plots ---------------------------------------------------------------
    def plot_energies(self, axs=None):
        """The image (the decoded pixels), the density exp(-energy) and the
        energy's contours."""
        from sde_sampler_torch.eval.plots import pyplot

        if axs is None:
            _, axs = pyplot().subplots(ncols=3, nrows=1, figsize=(20, 6))
        axs[0].imshow(np.load(self.path)["rgb"])
        energy = self.pixel_energy.cpu().numpy()
        axs[1].imshow(np.exp(-energy[::-1]), vmin=0, vmax=1, cmap="gray_r")
        axs[2].contourf(energy, 20, vmin=energy.min(), vmax=energy.max(), cmap="Spectral")
        for ax in axs:
            ax.axis("off")
        return axs[0].get_figure()

    def plot_samples(self, samples, nbins=100, vmax=250.0, ax=None):
        """A 2-d histogram of the samples over the domain."""
        from sde_sampler_torch.eval.plots import pyplot, to_numpy

        samples = to_numpy(samples)
        domain = None if self.domain is None else to_numpy(self.domain)
        if ax is None:
            _, ax = pyplot().subplots()
        ax.hist2d(samples[:, 0], samples[:, 1], bins=nbins, vmax=vmax, range=domain,
                  cmap="gray_r")
        if domain is not None:
            ax.set_xlim(*domain[0])
            ax.set_ylim(*domain[1])
        ax.axis("off")
        return ax.get_figure()

    def plots(self, samples, nbins=100, vmax=250.0):
        """The samples beside as many exact ones (from a generator seeded 0),
        and the energies."""
        from sde_sampler_torch.eval.plots import pyplot

        fig, axes = pyplot().subplots(nrows=1, ncols=2, figsize=(6, 3))
        fig.subplots_adjust(wspace=0.05)
        generator = torch.Generator(device=self.device).manual_seed(0)
        results = {
            "prediction": samples,
            "groundtruth": self.sample((samples.shape[0],), generator=generator),
        }
        for ax, (name, x) in zip(axes, results.items()):
            ax.set_title(name, fontsize=15)
            fig = self.plot_samples(samples=x, nbins=nbins, vmax=vmax, ax=ax)
        return {"plots/comparison": fig, "plots/groundtruth": self.plot_energies()}
