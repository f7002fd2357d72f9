"""Internal-coordinate (z-matrix) transform of alanine dipeptide, in torch.

Port of `sde_sampler_tpu/distr/aladip_transform.py`: maps the 60-d sampler
space to 22 x 3 Cartesian coordinates in nm (66 degrees of freedom less the
6 of a global translation and rotation, fixed by a canonical frame) and
returns the log-Jacobian, so that Boltzmann log-densities transform
correctly. The z-matrix, the frame, the placement order and the layout of
the coordinates are the JAX package's:

    z[0]  bond   |x6 - x8|                (N-CA)
    z[1]  bond   |x14 - x8|               (C-CA)
    z[2]  angle  angle(6, 8, 14)
    z[3+3r .. 5+3r]  (bond, angle, dihedral) of Z_MATRIX row r

Canonical frame: atom 8 (CA) at the origin, atom 6 (N) on +x, atom 14 (C)
in the xy half-plane with y > 0; NERF places every other atom from its
three references, in the placement order, one atom at a time as the JAX
package does (so the log-Jacobian sums in its order).

The normalisation's means are the reference structure's internal
coordinates, computed in float32 from the float64 structure as the JAX
package (which runs without x64) computes them; its stds are the per-kind
`default_std`. Dihedrals are wrapped to the branch nearest their mean on
the inverse pass.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .aladip_ff import clip

# z-matrix rows (atom, [ref0, ref1, ref2])
Z_MATRIX = [
    (0, [1, 4, 6]),
    (1, [4, 6, 8]),
    (2, [1, 4, 0]),
    (3, [1, 4, 0]),
    (4, [6, 8, 14]),
    (5, [4, 6, 8]),
    (7, [6, 8, 4]),
    (9, [8, 6, 4]),
    (10, [8, 6, 4]),
    (11, [10, 8, 6]),
    (12, [10, 8, 11]),
    (13, [10, 8, 11]),
    (15, [14, 8, 16]),
    (16, [14, 8, 6]),
    (17, [16, 14, 15]),
    (18, [16, 14, 8]),
    (19, [18, 16, 14]),
    (20, [18, 16, 19]),
    (21, [18, 16, 19]),
]
FRAME = (8, 6, 14)  # origin, +x, xy-plane
N_ATOMS = 22
DIM = 3 + 3 * len(Z_MATRIX)  # 60


def _placement_order():
    placed = set(FRAME)
    order = []
    remaining = list(range(len(Z_MATRIX)))
    while remaining:
        progress = False
        for ridx in list(remaining):
            atom, refs = Z_MATRIX[ridx]
            if all(r in placed for r in refs):
                order.append(ridx)
                placed.add(atom)
                remaining.remove(ridx)
                progress = True
        if not progress:  # pragma: no cover - static topology
            raise ValueError(f"unplaceable z-matrix rows: {remaining}")
    return order


PLACEMENT_ORDER = _placement_order()


def _norm(v):
    # epsilon-guarded: degenerate frames (coincident or collinear reference
    # atoms) give finite values and finite gradients
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-20)


def bond_angle(a, b, c):
    """Angle at b between a and c, batched."""
    v1 = _norm(a - b)
    v2 = _norm(c - b)
    return torch.arccos(clip((v1 * v2).sum(-1), -1.0 + 1e-9, 1.0 - 1e-9))


def dihedral(p0, p1, p2, p3):
    """Signed dihedral about p1-p2, (-pi, pi], batched; a finite
    (arbitrary) angle with finite gradients on degenerate frames."""
    b0 = p1 - p0
    b1 = _norm(p2 - p1)
    b2 = p3 - p2
    v = b0 - (b0 * b1).sum(-1, keepdim=True) * b1
    w = b2 - (b2 * b1).sum(-1, keepdim=True) * b1
    x = (v * w).sum(-1)
    y = (torch.linalg.cross(b1, v, dim=-1) * w).sum(-1)
    deg = (x * x + y * y) < 1e-24
    return torch.atan2(y, torch.where(deg, 1e-12, x))


def _nerf(a, b, c, r, theta, phi):
    """Place x with |x-a| = r, angle(x, a, b) = theta, dihedral(x, a, b, c)
    = phi; a, b, c are (..., 3), r, theta, phi (...,)."""
    e1 = _norm(b - a)
    p = c - b
    e2 = _norm(p - (p * e1).sum(-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    r = r[..., None]
    st = torch.sin(theta)[..., None]
    return a + r * (
        torch.cos(theta)[..., None] * e1
        + st * (-torch.cos(phi)[..., None]) * e2
        + st * torch.sin(phi)[..., None] * e3
    )


def cartesian_to_internal(pos: torch.Tensor) -> torch.Tensor:
    """(..., 22, 3) nm -> (..., 60) raw internal coordinates."""
    def safe_dist(u, v):
        d = u - v
        return torch.sqrt((d * d).sum(-1) + 1e-20)

    o, ax, pl = FRAME
    coords = [
        safe_dist(pos[..., ax, :], pos[..., o, :]),
        safe_dist(pos[..., pl, :], pos[..., o, :]),
        bond_angle(pos[..., ax, :], pos[..., o, :], pos[..., pl, :]),
    ]
    for atom, (r0, r1, r2) in Z_MATRIX:
        pa = pos[..., atom, :]
        p0, p1, p2 = pos[..., r0, :], pos[..., r1, :], pos[..., r2, :]
        coords.append(safe_dist(pa, p0))
        coords.append(bond_angle(pa, p0, p1))
        coords.append(dihedral(pa, p0, p1, p2))
    return torch.stack(coords, dim=-1)


def _placement_levels():
    """The z-matrix rows by level: a row's atom is placed once its three
    references are (the frame's atoms are level 0), so the rows of one
    level are placed together."""
    level = {atom: 0 for atom in FRAME}
    rows: dict[int, list[int]] = {}
    for ridx in PLACEMENT_ORDER:
        atom, refs = Z_MATRIX[ridx]
        level[atom] = 1 + max(level[r] for r in refs)
        rows.setdefault(level[atom], []).append(ridx)
    return [rows[k] for k in sorted(rows)]


PLACEMENT_LEVELS = _placement_levels()


@functools.lru_cache(maxsize=None)
def _level_indices(device: str):
    """Per level: the state columns of (r, theta, phi) of its rows (L, 3)
    and the columns of their references among the atoms placed before it
    (L, 3); the atom order of all placed columns (22)."""
    columns = {atom: i for i, atom in enumerate(FRAME)}
    levels = []
    for rows in PLACEMENT_LEVELS:
        coords = [[3 + 3 * r, 4 + 3 * r, 5 + 3 * r] for r in rows]
        refs = [[columns[a] for a in Z_MATRIX[r][1]] for r in rows]
        levels.append(tuple(torch.tensor(v, device=device) for v in (coords, refs)))
        for r in rows:
            columns[Z_MATRIX[r][0]] = len(columns)
    order = torch.tensor([columns[a] for a in range(N_ATOMS)], device=device)
    return levels, order, torch.tensor([3 + 3 * r for r in PLACEMENT_ORDER], device=device)


def internal_to_cartesian(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 60) raw internals -> ((..., 22, 3) nm, (...,) logdet).

    logdet = log|det d(cartesian)/d(internal)| on the 60-d quotient: log b2
    for the in-plane frame atom plus, for each z-matrix row, 2 log r +
    log sin(theta) (the spherical volume element of its placement). The
    atoms are placed a level at a time (`PLACEMENT_LEVELS`): each
    coordinate by the JAX package's arithmetic, with a few launches for
    each of the 4 levels in place of each of the 19 rows, and the
    log-Jacobian's row terms summed in one reduction (the JAX package adds
    them one at a time, in the placement order).
    """
    levels, order, first = _level_indices(str(z.device))
    b1, b2, ang = z[..., 0], z[..., 1], z[..., 2]
    zero = torch.zeros_like(b1)
    placed = torch.stack([
        torch.stack([zero, zero, zero], dim=-1),
        torch.stack([b1, zero, zero], dim=-1),
        torch.stack([b2 * torch.cos(ang), b2 * torch.sin(ang), zero], dim=-1),
    ], dim=-2)  # FRAME's atoms: origin, +x, xy-plane
    for coords, refs in levels:
        rtp = z[..., coords]  # (..., L, 3)
        a, b, c = (placed[..., refs[:, i], :] for i in range(3))
        new = _nerf(a, b, c, rtp[..., 0], rtp[..., 1], rtp[..., 2])
        placed = torch.cat([placed, new], dim=-2)
    r, theta = z[..., first], z[..., first + 1]
    logdet = torch.log(b2) + (2.0 * torch.log(r) + torch.log(torch.sin(theta))).sum(-1)
    return placed[..., order, :], logdet


def coordinate_kinds() -> np.ndarray:
    """Per-coordinate kind: 0 = bond, 1 = angle, 2 = dihedral (layout above)."""
    kinds = [0, 0, 1]
    for _ in Z_MATRIX:
        kinds += [0, 1, 2]
    return np.array(kinds, np.int64)


# Domain guards: internal coordinates live on (0, inf) x (0, pi) x circle,
# but the sampler explores all of R^60. The geometry is built from clamped
# values and the squared violation is returned, so that the Boltzmann
# density decays smoothly outside the domain with a score pointing back in.
R_MIN = 0.03          # nm; real bonds are about 0.10-0.15 nm
ANG_EPS = 0.05        # rad


def _domain_bounds() -> tuple[tuple, tuple]:
    kinds = coordinate_kinds()
    lo = np.where(kinds == 0, R_MIN, np.where(kinds == 1, ANG_EPS, -np.inf))
    hi = np.where(kinds == 1, math.pi - ANG_EPS, np.inf)
    return tuple(lo.tolist()), tuple(hi.tolist())


_LO, _HI = _domain_bounds()


def clamp_internals(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 60) raw internals -> (clamped internals, (...,) squared
    violation)."""
    z_safe = clip(z, _LO, _HI)
    violation = ((z - z_safe) ** 2).sum(dim=-1)
    return z_safe, violation


class AlaDipTransform:
    """Normalised sampler space <-> Cartesian nm, anchored on a reference
    structure (data/position_min_energy.npy in practice)."""

    def __init__(self, ref_cartesian: np.ndarray, default_std: dict | None = None):
        default_std = default_std or {"bond": 0.005, "angle": 0.15, "dih": 0.2}
        # the float64 structure in float32, as the JAX package computes it
        ref = torch.from_numpy(
            np.asarray(ref_cartesian, np.float64).reshape(N_ATOMS, 3).astype(np.float32))
        self.kinds = coordinate_kinds()
        self.mean = cartesian_to_internal(ref)
        self.std = torch.from_numpy(np.where(
            self.kinds == 0, default_std["bond"],
            np.where(self.kinds == 1, default_std["angle"], default_std["dih"]),
        ).astype(np.float32))
        self.logdet_norm = float(np.log(np.where(
            self.kinds == 0, default_std["bond"],
            np.where(self.kinds == 1, default_std["angle"], default_std["dih"]))).sum())
        self.is_dih = torch.from_numpy(self.kinds == 2)

    def to(self, device) -> "AlaDipTransform":
        self.mean, self.std, self.is_dih = (t.to(device) for t in (self.mean, self.std, self.is_dih))
        return self

    def forward(self, z_norm: torch.Tensor):
        """(..., 60) normalised -> ((..., 22, 3) nm, (...,) logdet with the
        denormalisation's term), the geometry built from domain-clamped
        internals (see `clamp_internals`)."""
        pos, logdet, _ = self.forward_with_penalty(z_norm)
        return pos, logdet

    def forward_with_penalty(self, z_norm: torch.Tensor):
        """`forward` and the squared domain violation (raw units)."""
        z = z_norm * self.std + self.mean
        z_safe, violation = clamp_internals(z)
        pos, logdet = internal_to_cartesian(z_safe)
        return pos, logdet + self.logdet_norm, violation

    def inverse(self, pos: torch.Tensor) -> torch.Tensor:
        """(..., 22, 3) nm -> (..., 60) normalised; dihedrals wrapped to the
        branch nearest the reference mean."""
        delta = cartesian_to_internal(pos) - self.mean
        wrapped = torch.where(self.is_dih, (delta + math.pi) % (2.0 * math.pi) - math.pi, delta)
        return wrapped / self.std
