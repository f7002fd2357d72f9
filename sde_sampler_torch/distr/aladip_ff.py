"""AMBER vacuum energy of alanine dipeptide (ACE-ALA-NME), in torch.

Port of `sde_sampler_tpu/distr/aladip_ff.py`: a fixed 22-atom topology with
AMBER ff99SB-form terms (harmonic bonds and angles, periodic torsions and
impropers, Lennard-Jones and Coulomb with the AMBER 1-4 scalings, no
cutoff). The parameter tables and the topology they derive (`_derive_topology`,
`_build_tables`) are the JAX package's, in numpy at import time; the energy
functions take (..., 22, 3) tensors in nm and return kJ/mol, with the
tables cast to float32 as the JAX package (which runs without x64) casts
them, and the products of two table columns (sigma², 4 eps) formed in
float64 first as numpy forms them there. Autograd gives the forces.

Every distance and angle is epsilon-guarded as in the JAX package, so the
energy and its gradient are finite on every geometry. Clips are
`torch.minimum(torch.maximum(x, lo), hi)`, whose gradient splits at an
exact tie as `jnp.clip`'s does (`torch.clamp` would pass it whole).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

N_ATOMS = 22

# Atom order of openmmtools' AlanineDipeptideVacuum (and of
# data/position_min_energy.npy): ACE [HH31 CH3 HH32 HH33 C O],
# ALA [N H CA HA CB HB1 HB2 HB3 C O], NME [N H CH3 HH31 HH32 HH33].
ATOM_NAMES = [
    "HH31", "CH3", "HH32", "HH33", "C", "O",
    "N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O",
    "N", "H", "CH3", "HH31", "HH32", "HH33",
]
ATOM_TYPES = [
    "HC", "CT", "HC", "HC", "C", "O",
    "N", "H", "CT", "H1", "CT", "HC", "HC", "HC", "C", "O",
    "N", "H", "CT", "H1", "H1", "H1",
]
# AMBER ff94/ff99/ff99SB partial charges (e); each residue sums to 0.
CHARGES = [
    0.1123, -0.3662, 0.1123, 0.1123, 0.5972, -0.5679,
    -0.4157, 0.2719, 0.0337, 0.0823, -0.1825,
    0.0603, 0.0603, 0.0603, 0.5973, -0.5679,
    -0.4157, 0.2719, -0.1490, 0.0976, 0.0976, 0.0976,
]

BONDS = [
    (0, 1), (2, 1), (3, 1), (1, 4), (4, 5), (4, 6), (6, 7), (6, 8),
    (8, 9), (8, 10), (8, 14), (10, 11), (10, 12), (10, 13),
    (14, 15), (14, 16), (16, 17), (16, 18), (18, 19), (18, 20), (18, 21),
]

# parm99 bonded constants (kcal/mol/A^2, A) keyed by sorted type pair.
BOND_PARAMS = {
    ("CT", "HC"): (340.0, 1.090),
    ("CT", "H1"): (340.0, 1.090),
    ("CT", "CT"): (310.0, 1.526),
    ("C", "CT"): (317.0, 1.522),
    ("C", "O"): (570.0, 1.229),
    ("C", "N"): (490.0, 1.335),
    ("H", "N"): (434.0, 1.010),
    ("CT", "N"): (337.0, 1.449),
}

# parm99 angles (kcal/mol/rad^2, deg) keyed by (t_i, t_j, t_k) with the
# CENTER type second; stored with endpoints sorted for lookup.
ANGLE_PARAMS = {
    ("HC", "CT", "HC"): (35.0, 109.50),
    ("H1", "CT", "H1"): (35.0, 109.50),
    ("C", "CT", "HC"): (50.0, 109.50),
    ("C", "CT", "H1"): (50.0, 109.50),
    ("CT", "C", "O"): (80.0, 120.40),
    ("CT", "C", "N"): (70.0, 116.60),
    ("N", "C", "O"): (80.0, 122.90),
    ("C", "N", "CT"): (50.0, 121.90),
    ("C", "N", "H"): (50.0, 120.00),
    ("CT", "N", "H"): (38.0, 118.04),
    ("H1", "CT", "N"): (50.0, 109.50),
    ("CT", "CT", "N"): (80.0, 109.70),
    ("C", "CT", "N"): (63.0, 110.10),
    ("C", "CT", "CT"): (63.0, 111.10),
    ("CT", "CT", "HC"): (50.0, 109.50),
    ("CT", "CT", "H1"): (50.0, 109.50),
}

# Proper torsions: list of (k kcal/mol, periodicity, phase deg) PER PATH
# (generic parm99 entries are already divided by IDIVF here).
DIHEDRAL_GENERIC = {  # keyed by the two CENTER types, sorted
    ("C", "N"): [(10.0 / 4.0, 2, 180.0)],
    ("CT", "N"): [],  # X-CT-N-X is 0 in parm99 (ff99SB adds specifics)
    ("C", "CT"): [],  # X-C-CT-X is 0 in parm99
    ("CT", "CT"): [(1.40 / 9.0, 3, 0.0)],
}
# Specific quartets REPLACE the generic match (AMBER rule). ff99SB
# backbone corrections + the parm99 amide H-N-C-O term.
DIHEDRAL_SPECIFIC = {
    ("C", "N", "CT", "C"): [  # phi
        (0.27, 2, 0.0), (0.42, 3, 0.0),
    ],
    ("N", "CT", "C", "N"): [  # psi
        (0.45, 1, 180.0), (1.58, 2, 180.0), (0.55, 3, 180.0),
    ],
    ("CT", "CT", "N", "C"): [  # phi'
        (2.00, 1, 0.0), (2.00, 2, 0.0), (0.40, 3, 0.0),
    ],
    ("CT", "CT", "C", "N"): [  # psi'
        (0.20, 1, 0.0), (0.20, 2, 0.0), (0.40, 3, 0.0),
    ],
    ("H", "N", "C", "O"): [
        (2.00, 1, 0.0), (2.50, 2, 180.0),
    ],
}

# Impropers (k kcal/mol, periodicity, phase deg), centered on the THIRD
# atom (AMBER convention): keep the sp2 centers planar.
IMPROPERS = [
    ((1, 6, 4, 5), (10.5, 2, 180.0)),    # ACE carbonyl: X-X-C-O
    ((8, 16, 14, 15), (10.5, 2, 180.0)),  # ALA carbonyl: X-X-C-O
    ((4, 8, 6, 7), (1.0, 2, 180.0)),      # ALA amide:    X-X-N-H
    ((14, 18, 16, 17), (1.0, 2, 180.0)),  # NME amide:    X-X-N-H
]

# parm99 LJ: (rmin/2 in A, epsilon in kcal/mol) per type.
LJ_PARAMS = {
    "CT": (1.9080, 0.1094),
    "C": (1.9080, 0.0860),
    "N": (1.8240, 0.1700),
    "O": (1.6612, 0.2100),
    "H": (0.6000, 0.0157),
    "HC": (1.4870, 0.0157),
    "H1": (1.3870, 0.0157),
}

KCAL_TO_KJ = 4.184
NM_TO_A = 10.0
COULOMB_KCAL_A = 332.0637  # = ONE_4PI_EPS0 (OpenMM) in kcal*A/(mol*e^2)
SCEE = 1.2  # AMBER 1-4 electrostatic divider
SCNB = 2.0  # AMBER 1-4 LJ divider


def _derive_topology():
    """Angles, proper-dihedral paths, and nonbonded pair lists from BONDS."""
    adj = {i: set() for i in range(N_ATOMS)}
    for a, b in BONDS:
        adj[a].add(b)
        adj[b].add(a)

    angles = []
    for j in range(N_ATOMS):
        nbrs = sorted(adj[j])
        for ai in range(len(nbrs)):
            for ak in range(ai + 1, len(nbrs)):
                angles.append((nbrs[ai], j, nbrs[ak]))

    dihedrals = []
    for j, k in ((a, b) for a, b in BONDS):
        for i in sorted(adj[j] - {k}):
            for l in sorted(adj[k] - {j}):
                if i != l:
                    dihedrals.append((i, j, k, l))

    # exclusion classes: 1-2 and 1-3 fully excluded, 1-4 scaled
    excl = set()
    for a, b in BONDS:
        excl.add(tuple(sorted((a, b))))
    for i, j, k in angles:
        excl.add(tuple(sorted((i, k))))
    pairs14 = set()
    for i, _, _, l in dihedrals:
        p = tuple(sorted((i, l)))
        if p not in excl:
            pairs14.add(p)
    pairs_full = [
        (i, j)
        for i in range(N_ATOMS)
        for j in range(i + 1, N_ATOMS)
        if (i, j) not in excl and (i, j) not in pairs14
    ]
    return angles, dihedrals, sorted(pairs14), pairs_full


def _dihedral_terms(dihedrals):
    """(i,j,k,l, k_kcal, n, phase_rad) rows; specific quartets replace the
    generic wildcard entry, duplicate i-j-k-l paths through the same
    central bond each contribute (AMBER multi-path convention is already
    folded into the per-path generic constants)."""
    rows = []
    for i, j, k, l in dihedrals:
        ti, tj, tk, tl = (ATOM_TYPES[a] for a in (i, j, k, l))
        spec = DIHEDRAL_SPECIFIC.get((ti, tj, tk, tl)) or \
            DIHEDRAL_SPECIFIC.get((tl, tk, tj, ti))
        terms = spec if spec is not None else \
            DIHEDRAL_GENERIC[tuple(sorted((tj, tk)))]
        for kcal, n, phase in terms:
            rows.append((i, j, k, l, kcal, n, math.radians(phase)))
    return rows


def _build_tables():
    angles, dihedrals, pairs14, pairs_full = _derive_topology()

    bond_idx = np.array(BONDS, np.int32)
    bond_k, bond_r0 = [], []
    for a, b in BONDS:
        key = tuple(sorted((ATOM_TYPES[a], ATOM_TYPES[b])))
        k, r0 = BOND_PARAMS[key]
        bond_k.append(k * KCAL_TO_KJ * NM_TO_A**2)  # kJ/mol/nm^2
        bond_r0.append(r0 / NM_TO_A)  # nm

    ang_idx = np.array(angles, np.int32)
    ang_k, ang_t0 = [], []
    for i, j, k in angles:
        ti, tk = sorted((ATOM_TYPES[i], ATOM_TYPES[k]))
        kk, t0 = ANGLE_PARAMS[(ti, ATOM_TYPES[j], tk)]
        ang_k.append(kk * KCAL_TO_KJ)
        ang_t0.append(math.radians(t0))

    dih_rows = _dihedral_terms(dihedrals) + [
        (i, j, k, l, kcal, n, math.radians(phase))
        for (i, j, k, l), (kcal, n, phase) in IMPROPERS
    ]
    dih_idx = np.array([r[:4] for r in dih_rows], np.int32)
    dih_k = np.array([r[4] * KCAL_TO_KJ for r in dih_rows])
    dih_n = np.array([r[5] for r in dih_rows], np.float64)
    dih_phase = np.array([r[6] for r in dih_rows])

    rmin2 = np.array([LJ_PARAMS[t][0] / NM_TO_A for t in ATOM_TYPES])
    eps = np.array([LJ_PARAMS[t][1] * KCAL_TO_KJ for t in ATOM_TYPES])
    q = np.array(CHARGES)

    def _pair_tables(pairs, lj_scale, coul_scale):
        idx = np.array(pairs, np.int32).reshape(-1, 2)
        i, j = idx[:, 0], idx[:, 1]
        # Lorentz-Berthelot as AMBER applies it: rmin = rmin_i/2+rmin_j/2
        rmin = rmin2[i] + rmin2[j]
        e = np.sqrt(eps[i] * eps[j]) * lj_scale
        # rmin -> sigma for the 4*eps((s/r)^12-(s/r)^6) form
        sigma = rmin / 2.0 ** (1.0 / 6.0)
        qq = q[i] * q[j] * (COULOMB_KCAL_A * KCAL_TO_KJ / NM_TO_A) \
            * coul_scale
        return idx, sigma, e, qq

    return {
        "bond_idx": bond_idx,
        "bond_k": np.array(bond_k),
        "bond_r0": np.array(bond_r0),
        "ang_idx": ang_idx,
        "ang_k": np.array(ang_k),
        "ang_t0": np.array(ang_t0),
        "dih_idx": dih_idx,
        "dih_k": dih_k,
        "dih_n": dih_n,
        "dih_phase": dih_phase,
        "pair14": _pair_tables(pairs14, 1.0 / SCNB, 1.0 / SCEE),
        "pair": _pair_tables(pairs_full, 1.0, 1.0),
    }




_TABLES = _build_tables()


def _float32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def tables(device: str = "cpu") -> dict:
    """The energy tables as tensors on `device`: index columns (int64) and
    float32 constants, sigma² and 4 eps of the pair terms formed in
    float64 before the cast (the JAX package's numpy order)."""
    t = _TABLES
    out = {}
    for key in ("bond", "ang", "dih"):
        out[f"{key}_idx"] = torch.from_numpy(t[f"{key}_idx"].astype(np.int64))
    for key in ("bond_k", "bond_r0", "ang_k", "ang_t0", "dih_k", "dih_n", "dih_phase"):
        out[key] = _float32(t[key])
    for key in ("pair14", "pair"):
        idx, sigma, eps, qq = t[key]
        out[key] = (torch.from_numpy(idx.astype(np.int64)), _float32(sigma * sigma),
                    _float32(4.0 * eps), _float32(qq))
    return {k: tuple(x.to(device) for x in v) if isinstance(v, tuple) else v.to(device)
            for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def constant(value, device: str = "cpu") -> torch.Tensor:
    """A float32 tensor of `value` (a float or a tuple) on `device`, made
    once: no host-to-device copy in the functions that use it."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip` with its gradient: maximum then minimum, each splitting the
    gradient at a tie. lo and hi are floats or tuples (per last-axis
    entry)."""
    device = str(x.device)
    return torch.minimum(torch.maximum(x, constant(lo, device)), constant(hi, device))


def dihedral_angle(p0, p1, p2, p3):
    """Signed dihedral about the p1-p2 axis, (-pi, pi]; batched over
    leading axes. Degenerate (collinear) frames give an arbitrary but
    finite angle with finite gradients (epsilon-guarded atan2 inputs)."""
    b0 = p1 - p0
    b1 = p2 - p1
    b2 = p3 - p2
    n1 = torch.linalg.cross(b0, b1, dim=-1)
    n2 = torch.linalg.cross(b1, b2, dim=-1)
    b1n = b1 / torch.sqrt((b1 * b1).sum(-1, keepdim=True) + 1e-12)
    m1 = torch.linalg.cross(n1, b1n, dim=-1)
    x = (n1 * n2).sum(-1)
    y = (m1 * n2).sum(-1)
    # atan2's gradient blows up only at (0, 0): nudge x there
    deg = (x * x + y * y) < 1e-24
    return torch.atan2(y, torch.where(deg, 1e-12, x))


# Keeps every sqrt away from r = 0, where autograd gives nan (sqrt'(0) = inf
# times 0); 1e-12 nm² shifts real geometries by less than 1e-6 nm.
_EPS_SQ = 1e-12


def _safe_norm(v):
    return torch.sqrt((v * v).sum(-1) + _EPS_SQ)


def energy_terms(pos: torch.Tensor) -> dict:
    """Per-term AMBER vacuum energy in kJ/mol of pos (..., 22, 3) in nm:
    {"bond", "angle", "dihedral", "nb14", "nb"}, which `energy_kj` sums."""
    t = tables(str(pos.device))

    def gather(idx):
        return [pos[..., idx[:, c], :] for c in range(idx.shape[1])]

    a, b = gather(t["bond_idx"])
    r = _safe_norm(b - a)
    e_bond = (t["bond_k"] * (r - t["bond_r0"]) ** 2).sum(-1)

    pi_, pj, pk = gather(t["ang_idx"])
    v1 = pi_ - pj
    v2 = pk - pj
    cos = (v1 * v2).sum(-1) / (_safe_norm(v1) * _safe_norm(v2))
    theta = torch.arccos(clip(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    e_ang = (t["ang_k"] * (theta - t["ang_t0"]) ** 2).sum(-1)

    p0, p1, p2, p3 = gather(t["dih_idx"])
    phi = dihedral_angle(p0, p1, p2, p3)
    e_dih = (t["dih_k"] * (1.0 + torch.cos(t["dih_n"] * phi - t["dih_phase"]))).sum(-1)

    def nb(pairs):
        idx, sigma_sq, four_eps, qq = pairs
        diff = pos[..., idx[:, 1], :] - pos[..., idx[:, 0], :]
        d2 = (diff * diff).sum(-1) + _EPS_SQ
        # LJ from the squared distance (no sqrt in the 12-6 term)
        s6 = (sigma_sq / d2) ** 3
        return (four_eps * (s6 * s6 - s6) + qq / torch.sqrt(d2)).sum(-1)

    return {
        "bond": e_bond,
        "angle": e_ang,
        "dihedral": e_dih,
        "nb14": nb(t["pair14"]),
        "nb": nb(t["pair"]),
    }


def energy_kj(pos: torch.Tensor) -> torch.Tensor:
    """AMBER vacuum energy in kJ/mol. pos: (..., 22, 3) in nm."""
    terms = energy_terms(pos)
    return terms["bond"] + terms["angle"] + terms["dihedral"] + terms["nb14"] + terms["nb"]


def regularize_energy(e: torch.Tensor, energy_cut: float, energy_max: float) -> torch.Tensor:
    """Boltzgen-style regularisation: linear below `energy_cut`, logarithmic
    above, capped at `energy_max`. A non-finite energy becomes energy_max
    with a nan gradient (inf times 0 in its backward), as in the JAX
    package."""
    e = torch.where(torch.isfinite(e), e, energy_max)
    device = str(e.device)
    soft = energy_cut + torch.log1p(torch.maximum(e - energy_cut, constant(0.0, device)))
    return torch.minimum(torch.where(e < energy_cut, e, soft), constant(energy_max, device))
