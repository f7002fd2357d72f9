"""Evaluation plots on numpy and matplotlib.

Port of `sde_sampler_tpu/eval/plots.py`: 1-d marginal histograms with the
true marginal and the importance-weighted histogram, 2-d density heatmaps
(a smoothed `histogram2d`), trajectory-evolution plots coloured by the
terminal value, 2-d contours, the ground-truth densities, and `save_fig`
for matplotlib figures and PIL images. Inputs may be torch tensors on any
device; they are moved to the host as numpy arrays.

matplotlib (and scipy's `gaussian_filter`) are imported at first use, never
when this module is imported, so that the port imports on a machine
without them; `require_backend` raises there, naming the missing package.
"""
from __future__ import annotations

import importlib
import itertools
import logging
from pathlib import Path
from typing import Callable

import numpy as np
import torch

# what plot_results=True needs (PIL for the image grids and save_fig)
BACKEND_PACKAGES = ("matplotlib", "PIL")


def require_backend() -> None:
    """Raise ImportError, naming the package and `plot_results=False`,
    where a package the plots need is missing."""
    for name in BACKEND_PACKAGES:
        try:
            importlib.import_module(name)
        except ImportError as err:
            raise ImportError(
                f"plot_results=True needs {name}, which cannot be imported here ({err}); "
                "install it or run with plot_results=False"
            ) from err


def pyplot():
    """matplotlib.pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_contours_2d(log_prob: Callable, domain, nbins: int = 200, levels: int = 50,
                     thresh: float = -1000.0, ax=None):
    """Contours of log_prob (numpy (n, 2) -> (n, 1)) on the 2-d domain."""
    plt = pyplot()
    if ax is None:
        _, ax = plt.subplots(1)
    domain = to_numpy(domain)
    x = np.linspace(*domain[0], nbins)
    y = np.linspace(*domain[1], nbins)
    xg, yg = np.meshgrid(x, y, indexing="ij")
    xy = np.stack([xg, yg], axis=-1).reshape(-1, 2)
    log_p = to_numpy(log_prob(xy)).reshape(xg.shape)
    ax.contour(xg, yg, np.clip(log_p, thresh, None), levels=levels)
    ax.set_ylabel(r"$x_1$")
    ax.set_xlabel(r"$x_2$")
    return ax.get_figure()


def plot_marginal_2d(x, dim1: int = 0, dim2: int = 1, weights=None, nbins: int = 100,
                     domain=None, smoothing: float = 0.1, ax=None, scatter: bool = False):
    """The (dim1, dim2) density of the finite samples: a histogram2d
    smoothed by a Gaussian filter, as an image."""
    from scipy.ndimage import gaussian_filter

    plt = pyplot()
    data = to_numpy(x)[:, [dim1, dim2]]
    if ax is None:
        _, ax = plt.subplots(1, 1)
    hist_range = None
    if domain is not None:
        domain = to_numpy(domain)[[dim1, dim2]]
        hist_range = [tuple(domain[0]), tuple(domain[1])]
    if weights is not None:
        weights = to_numpy(weights).squeeze(-1)
    finite = np.isfinite(data).all(axis=-1)
    heatmap, binsx, binsy = np.histogram2d(
        data[finite, 0], data[finite, 1], bins=nbins, range=hist_range,
        weights=None if weights is None else weights[finite], density=True,
    )
    heatmap = gaussian_filter(heatmap, sigma=smoothing)
    extent = [binsx[0], binsx[-1], binsy[0], binsy[-1]]
    palette = plt.get_cmap("Blues").copy()
    palette.set_under("white", 0.0)
    ax.imshow(heatmap.T, extent=extent, vmin=0.0, origin="lower", cmap=palette,
              aspect="auto")
    if scatter:
        ax.scatter(x=data[:, 0], y=data[:, 1], s=0.001, c="k")
    ax.set_ylabel(rf"$x_{dim2 + 1:d}$")
    ax.set_xlabel(rf"$x_{dim1 + 1:d}$")
    return ax.get_figure()


def plot_marginal(x, weights=None, marginal: Callable | None = None, dim: int = 0,
                  nbins: int = 100, domain=None, **_):
    """The dim-th marginal: a density histogram of the finite samples, the
    importance-weighted one, and the true marginal (numpy (n, 1) -> (n,))."""
    plt = pyplot()
    data = to_numpy(x)[:, dim]
    finite = np.isfinite(data)
    data = data[finite]
    if domain is None:
        rng = (float(data.min()), float(data.max()))
    else:
        rng = tuple(to_numpy(domain)[dim])

    fig, ax = plt.subplots(1, 1)
    heights, bins = np.histogram(data, bins=nbins, range=rng, density=True)
    centers = (bins[:-1] + bins[1:]) / 2
    width = bins[1] - bins[0]
    ax.bar(centers, heights, width=width, alpha=0.85, label="histogram")
    if weights is not None:
        # the weights of the same finite samples
        w = to_numpy(weights).squeeze(-1)[finite]
        heights_w, _ = np.histogram(data, bins=nbins, range=rng, weights=w, density=True)
        ax.bar(centers, heights_w, width=width, alpha=0.5, label="histogram_is")
    if marginal is not None:
        xlin = np.linspace(*rng, nbins)
        marginal_eval = to_numpy(marginal(xlin.reshape(-1, 1), dim=dim))
        ax.plot(xlin, marginal_eval.reshape(-1), "k-", label="marginal")
    ax.legend()
    ax.set_xlabel(rf"$x_{dim + 1:d}$")
    return fig


def plot_evolution(ts, xs, dim: int = 0, ntraj: int = 50, domain=None, **_):
    """The first `ntraj` finite trajectories of coordinate `dim` over ts,
    each coloured by its terminal value."""
    plt = pyplot()
    fig, ax = plt.subplots(1, 1)
    ts = to_numpy(ts)
    trajs = to_numpy(xs)[:, :, dim].T  # (B, T+1)
    mask = np.isfinite(trajs).all(axis=1)
    discard = mask.size - mask.sum()
    if discard > 0:
        logging.warning("Filtering %d trajectories with non-finite values.", discard)
    if discard < mask.size:
        trajs = trajs[mask][:ntraj]
        terminal = trajs[:, -1]
        hues = (terminal - terminal.min()) / (1e-8 + terminal.max() - terminal.min())
        cmap = plt.get_cmap("hsv")
        for traj, hue in zip(trajs, hues):
            ax.plot(ts, traj, lw=0.4, color=cmap(float(hue)))
    if domain is not None:
        ax.set_ylim(*to_numpy(domain)[dim])
    ax.set_xlabel("t")
    ax.set_ylabel(rf"$x_{dim + 1:d}$")
    return fig


def _numpy_marginal(distr):
    """distr.marginal on numpy points, or None."""
    marginal = getattr(distr, "marginal", None)
    if marginal is None:
        return None
    device = getattr(distr, "device", None)

    def fn(x, dim=0):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return to_numpy(marginal(x, dim=dim))

    return fn


def get_plots(distr, samples, weights=None, ts=None, xs=None,
              marginal_dims: list[int] | None = None, nbins: int = 100, domain=None,
              generator: torch.Generator | None = None) -> dict:
    """The plots of an evaluation, by key: `plots/traj_{d}` (with ts and
    xs) and `plots/hist_{d}` for each marginal dim, `plots/density_{a}_{b}`
    for each pair, and with a sampler `plots/groundtruth_density_{a}_{b}`
    of up to 1e5 draws from `generator`."""
    plots: dict = {}
    marginal_dims = list(marginal_dims or [])
    if domain is None and distr.domain is not None:
        domain = distr.domain if bool(np.isfinite(to_numpy(distr.domain)).all()) else None

    if not all(d < distr.dim for d in marginal_dims):
        logging.warning("Removing non-existent marginal dims for plotting.")
        marginal_dims = [d for d in marginal_dims if d < distr.dim]

    marginal = _numpy_marginal(distr)
    for d in marginal_dims:
        if ts is not None and xs is not None:
            plots[f"plots/traj_{d}"] = plot_evolution(ts=ts, xs=xs, dim=d, domain=domain)
        plots[f"plots/hist_{d}"] = plot_marginal(
            x=samples, weights=weights, marginal=marginal, dim=d, nbins=nbins, domain=domain,
        )

    for dim1, dim2 in itertools.combinations(marginal_dims, r=2):
        plots[f"plots/density_{dim1}_{dim2}"] = plot_marginal_2d(
            x=samples, dim1=dim1, dim2=dim2, nbins=nbins, domain=domain,
        )

    if hasattr(distr, "sample"):
        gt_samples = distr.sample((min(samples.shape[0], 10**5),), generator=generator)
        for dim1, dim2 in itertools.combinations(marginal_dims, r=2):
            plots[f"plots/groundtruth_density_{dim1}_{dim2}"] = plot_marginal_2d(
                x=gt_samples, dim1=dim1, dim2=dim2, nbins=nbins, domain=domain,
            )
    return plots


def save_fig(fig, path: Path | str) -> None:
    """Write a matplotlib figure (then closed) or a PIL image to `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    from PIL.Image import Image

    if isinstance(fig, Image):
        fig.save(path)
        return
    plt = pyplot()
    if isinstance(fig, plt.Figure):
        fig.savefig(path)
        plt.close(fig)
    else:
        raise ValueError(f"Unknown figure type {type(fig)}.")
