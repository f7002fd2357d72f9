"""Alanine-dipeptide Boltzmann target in 60-d internal coordinates.

Port of `sde_sampler_tpu/distr/aladip.py`, its `backend="jax"` path: the
AMBER ff99SB-form vacuum energy (`aladip_ff.py`) composed with the
internal-coordinate transform (`aladip_transform.py`), the chirality
filter of the training samples, the backbone (phi, psi) dihedrals and a
sampler that draws from the ULA validation set. The score is the base
class's autograd through the transform and the energy; the rollout kernel
has no inline form of it, so kernel 1 takes its given-score form.

The OpenMM backend (`backend="openmm"`) needs openmm, openmmtools and
boltzgen and is not ported: it raises as the JAX package does without
them, and `"auto"` resolves to the native backend without trying to import
openmm. The plots are the native backend's: Ramachandran histograms and the
60 marginals against the validation set.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from . import aladip_ff
from .aladip_transform import AlaDipTransform, dihedral
from .base import DATA_DIR, Distribution

# kJ/mol per squared raw-unit domain violation: out-of-domain states
# (negative bonds, angles past pi) are heavily suppressed, and the score
# points back into the domain (no nan or inf anywhere on R^60)
PENALTY_K = 1.0e5
# the molar gas constant in kJ/mol/K (CODATA, OpenMM's convention)
GAS_CONSTANT = 0.00831446261815324


def filter_chirality(x: torch.Tensor, ind: tuple = (17, 26), mean_diff: float = -0.043,
                     threshold: float = 0.8) -> torch.Tensor:
    """L-form filter on the internal coordinates: a (B, 1) mask of the rows
    whose wrapped dihedral difference lies within `threshold` of the L-form
    mean (the first of equal wraps on ties, as `argmin` picks)."""
    raw = x[:, ind[0]] - x[:, ind[1]]
    diffs = torch.stack([raw, raw + 2 * math.pi, raw - 2 * math.pi], dim=1)
    min_idx = diffs.abs().argmin(dim=1)
    diff = torch.take_along_dim(diffs, min_idx[:, None], dim=1)[:, 0]
    return ((diff - mean_diff).abs() < threshold)[:, None]


def _port_data(path) -> Path:
    """A relative path under `data/` names the port's copy of the file."""
    path = Path(path)
    candidate = DATA_DIR.parent / path
    return candidate if not path.is_absolute() and candidate.exists() else path


class AlaDip(Distribution):
    def __init__(
        self,
        dim: int = 60,
        data_path: Path | str | None = DATA_DIR / "position_min_energy.npy",
        temperature: int = 1000,
        energy_cut: float = 1.0e8,
        energy_max: float = 1.0e20,
        n_threads: int = 4,
        transform: str = "internal",
        ind_circ_dih: list | None = None,
        shift_dih: bool = False,
        shift_dih_params: dict | None = None,
        default_std: dict | None = None,
        env: str = "vacuum",
        filter_chirality_train: bool = True,
        eval_data_path: Path | str | None = None,
        backend: str = "auto",
        **kwargs,
    ):
        if dim != 60:
            raise ValueError("`dim` needs to be 60.")
        super().__init__(dim=dim, **kwargs)
        self.filter_chirality_train = filter_chirality_train
        self.transform = transform
        self.temperature = temperature
        if backend not in ("auto", "openmm", "jax"):
            raise ValueError(f"Unknown AlaDip backend {backend}.")
        if backend == "openmm":
            raise ImportError(
                "AlaDip requires openmm, openmmtools and boltzgen (reference "
                "README.md:180-181). Install them to use this target; they are not "
                "available in this environment."
            )
        self.backend = "jax"  # the native backend, as the JAX package names it
        if env != "vacuum":
            raise ValueError(
                "backend='jax' implements the AMBER vacuum energy only (aladip_ff.py); "
                "env='implicit' (GBSA) needs backend='openmm'. Use target=aladip_vacuum "
                "or override target.env=vacuum."
            )
        if data_path is None or Path(data_path).suffix != ".npy":
            raise ValueError(
                "backend='jax' anchors the internal-coordinate transform on a .npy "
                "reference structure (data/position_min_energy.npy)."
            )
        self._tf = AlaDipTransform(np.load(_port_data(data_path)).reshape(-1),
                                   default_std=default_std)
        self._beta = 1.0 / (GAS_CONSTANT * self.temperature)
        self._energy_cut = float(energy_cut)
        self._energy_max = float(energy_max)

        self.eval_data = None
        if eval_data_path is not None and _port_data(eval_data_path).exists():
            self.eval_data = torch.from_numpy(np.load(_port_data(eval_data_path)))
            # the generic evaluation (reference statistics, the Sinkhorn
            # against ground truth) samples the validation set
            self.sample = self._sample_eval_data

    def to(self, device) -> "AlaDip":
        super().to(device)
        self._tf.to(self.device)
        return self

    def _sample_eval_data(self, shape, generator: torch.Generator | None = None) -> torch.Tensor:
        """Draws with replacement from the ULA validation set."""
        idx = torch.randint(0, self.eval_data.shape[0], tuple(shape[:1]), generator=generator,
                            device=self.device)
        return self.eval_data[idx]

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        pos, logdet, violation = self._tf.forward_with_penalty(x)
        e = aladip_ff.regularize_energy(aladip_ff.energy_kj(pos), self._energy_cut,
                                        self._energy_max)
        e = e + PENALTY_K * violation
        return (-self._beta * e + logdet)[..., None]

    def filter(self, x: torch.Tensor) -> torch.Tensor:
        if self.filter_chirality_train:
            return filter_chirality(x)
        return torch.ones((x.shape[0], 1), dtype=torch.bool, device=x.device)

    def phi_psi(self, samples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Backbone (phi, psi) in the IUPAC convention: the transform's
        dihedral is offset by pi from it, so both are wrapped by +pi to
        [-pi, pi) (the minimum-energy structure reads (-146°, +150°))."""
        pos, _ = self._tf.forward(samples)
        phi = dihedral(pos[..., 4, :], pos[..., 6, :], pos[..., 8, :], pos[..., 14, :])
        psi = dihedral(pos[..., 6, :], pos[..., 8, :], pos[..., 14, :], pos[..., 16, :])
        return torch.remainder(phi, 2 * math.pi) - math.pi, torch.remainder(psi, 2 * math.pi) - math.pi

    def plots(self, samples, batch_size: int = 1000) -> dict:
        """Ramachandran (phi, psi) histograms of the samples and, where the
        validation set is loaded, of it, and each coordinate's histogram
        against the validation set's (the JAX package's `_plots_jax`)."""
        import matplotlib as mpl

        from sde_sampler_torch.eval.plots import pyplot, to_numpy

        plt = pyplot()
        samples = to_numpy(samples)
        sets = [("prediction", samples)]
        if self.eval_data is not None:
            sets.append(("groundtruth", to_numpy(self.eval_data)))
        figures = {}
        for name, zs in sets:
            with torch.no_grad():
                phi, psi = self.phi_psi(torch.as_tensor(zs, device=self.device))
            fig, ax = plt.subplots(1, 1)
            ax.hist2d(to_numpy(phi), to_numpy(psi), bins=64, norm=mpl.colors.LogNorm(),
                      range=[[-np.pi, np.pi], [-np.pi, np.pi]])
            ax.set_xlabel(r"$\phi$")
            ax.set_ylabel(r"$\psi$")
            figures[f"plots/ramachandran_{name}"] = fig
        if self.eval_data is not None:
            eval_data = to_numpy(self.eval_data)
            fig, axes = plt.subplots(6, 10, figsize=(20, 12))
            for d in range(self.dim):
                ax = axes.flat[d]
                ax.hist(eval_data[:, d], bins=50, density=True, alpha=0.5)
                ax.hist(samples[:, d], bins=50, density=True, alpha=0.5)
                ax.set_xticks([])
                ax.set_yticks([])
            figures["plots/marginals"] = fig
        return figures
