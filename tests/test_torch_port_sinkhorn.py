"""Softmin, transport cost and Sinkhorn of the port vs the JAX package.

The plain versions of kernels 2 and 3 (what a CPU tensor runs) are held
against the JAX Pallas kernels in interpret mode, against float64 truth at
d = 1 and d = 10 (the bar of tests/test_eval.py:248,369), and with -inf
duals. Tolerances: against float64 truth 1e-5 (absolute for softmin,
relative for transport), which the port's direct differences reach at
every d. Against the JAX kernels: softmin 1e-5 absolute (float32
logsumexp summed in another order); transport 1e-3 relative, because the
JAX quadratic form |x|^2 + |y|^2 - 2x.y carries about 1e-6 of cancellation
error in each distance, which exp(-M/eps) at eps = 1e-2 amplifies to
about 1e-4 of the plan (the port is the side that matches float64). The
JAX d = 1 path is bounded by its cancellation floor and compared only
with truth, as its own test does.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.eval.sinkhorn import Sinkhorn as JSinkhorn
from sde_sampler_tpu.ops import sinkhorn_pallas as sp
from sde_sampler_torch.eval.sinkhorn import Sinkhorn
from sde_sampler_torch.ops.sinkhorn import (
    softmin,
    softmin_plain,
    transport_cost,
    transport_cost_plain,
)

EPS = 1e-2


def clouds(d, n=130, m=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.normal(size=(m, d)) + 0.3).astype(np.float32)
    dual = (rng.normal(size=(m,)) * 0.01).astype(np.float32)
    u = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    return x, y, dual, u


def f64_truth(x, y, dual, u, eps):
    dist = np.sqrt(((x[:, None, :].astype(np.float64) - y[None].astype(np.float64)) ** 2).sum(-1))
    z = (-dist + dual.astype(np.float64)[None, :]) / eps
    zmax = z.max(axis=1, keepdims=True)
    sm = eps * (np.log(np.exp(z - zmax).sum(axis=1)) + zmax[:, 0])
    tr = float((np.exp((-dist + u[:, None] + dual[None, :]) / eps) * dist).sum())
    return sm, tr


@pytest.mark.parametrize("d", [1, 2, 10])
def test_plain_versions_match_jax_kernels_and_f64(d):
    x, y, dual, u = clouds(d)
    sm = softmin(*map(torch.from_numpy, (x, y, dual)), EPS).numpy()
    tr = float(transport_cost(*map(torch.from_numpy, (x, y, u, dual)), EPS))
    sm64, tr64 = f64_truth(x, y, dual, u, EPS)
    np.testing.assert_allclose(sm, sm64, atol=1e-5)
    assert tr == pytest.approx(tr64, rel=1e-5)
    if d >= 2:  # the JAX d = 1 path is bounded by its cancellation floor
        jx, jy, jd, ju = map(jnp.asarray, (x, y, dual, u))
        np.testing.assert_allclose(
            sm, np.asarray(sp.softmin_pallas(jx, jy, jd, EPS, interpret=True)), atol=1e-5
        )
        want = float(sp.transport_cost_pallas(jx, jy, ju, jd, EPS, interpret=True))
        assert tr == pytest.approx(want, rel=1e-3)


def test_minus_inf_duals_stay_finite_where_jax_does():
    x, y, dual, u = clouds(3)
    dual[:40] = -np.inf
    u[:7] = -np.inf
    sm = softmin_plain(*map(torch.from_numpy, (x, y, dual)), EPS)
    want = sp.softmin_pallas(*map(jnp.asarray, (x, y, dual)), EPS, interpret=True)
    assert torch.isfinite(sm).all()
    np.testing.assert_allclose(sm.numpy(), np.asarray(want), atol=1e-5)
    tr = transport_cost_plain(*map(torch.from_numpy, (x, y, u, dual)), EPS)
    want_t = sp.transport_cost_pallas(*map(jnp.asarray, (x, y, u, dual)), EPS, interpret=True)
    assert float(tr) == pytest.approx(float(want_t), rel=1e-3)
    assert float(tr) == pytest.approx(f64_truth(x, y, dual, u, EPS)[1], rel=1e-5)
    # a row whose every column is -inf gives -inf, as in the JAX kernel
    all_inf = np.full_like(dual, -np.inf)
    out = softmin_plain(*map(torch.from_numpy, (x, y, all_inf)), EPS)
    assert torch.all(out == -math.inf)


@pytest.mark.parametrize("weighted,d", [(False, 5), (True, 5), (False, 50)],
                         ids=["False", "True", "d50"])
def test_sinkhorn_matches_jax(weighted, d):
    """d = 50 is the width of `target=mw_50d`, which the kernels take through
    their wide body on the card."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, d)).astype(np.float32)
    y = (rng.normal(size=(300 if not weighted else 217, d)) + 0.25).astype(np.float32)
    kw = dict(eps=1e-2, max_iters=60, stop_thresh=1e-6)
    w = {}
    if weighted:
        w_x = rng.uniform(0.5, 1.5, size=300).astype(np.float32)
        w_x[:13] = 0.0  # zero weights: -inf duals outside the convergence check
        w_x /= w_x.sum()
        w_y = np.full(217, 1 / 217, np.float32)
        w = dict(w_x=w_x, w_y=w_y)
    want = float(JSinkhorn(backend="xla", row_chunk=64, col_chunk=128, **kw)(
        jnp.asarray(x), jnp.asarray(y), **{k: jnp.asarray(v) for k, v in w.items()}))
    s = Sinkhorn(**kw)
    got = float(s(torch.from_numpy(x), torch.from_numpy(y),
                  **{k: torch.from_numpy(v) for k, v in w.items()}))
    assert got == pytest.approx(want, rel=1e-4)
    assert 1 <= s.n_iters <= kw["max_iters"]


def split_softmin(x, y, dual, eps, cols, chunk=16):
    """The softmin kernel's algorithm (csrc/sinkhorn.cu) in float32 numpy:
    log2 domain, column splits of `cols`, an online max moved once per chunk
    of `chunk` columns, a max of -inf rescaled against 0, then the merge of
    the splits' (max, sum) partials."""
    k2 = np.float32(1.4426950408889634) / np.float32(eps)
    m = y.shape[0]
    m_pad = -(-m // chunk) * chunk
    v2 = np.full(m_pad, -np.inf, np.float32)
    v2[:m] = dual * k2
    y_pad = np.zeros((m_pad, y.shape[1]), np.float32)
    y_pad[:m] = y
    c = np.sqrt(((x[:, None, :] - y_pad[None]) ** 2).sum(-1), dtype=np.float32)
    z = (-c * k2 + v2[None]).astype(np.float32)
    parts = []
    for j0 in range(0, m_pad, cols):
        mx = np.full(x.shape[0], -np.inf, np.float32)
        s = np.zeros(x.shape[0], np.float32)
        for c0 in range(j0, min(j0 + cols, m_pad), chunk):
            zc = z[:, c0 : c0 + chunk]
            mn = np.maximum(mx, zc.max(axis=1))
            base = np.where(mn == -np.inf, np.float32(0), mn)
            s = s * np.exp2(mx - base) + np.exp2(zc - base[:, None]).sum(axis=1)
            mx = mn
        parts.append((mx, s))
    return merge_softmin_partials(parts, eps)


def merge_softmin_partials(parts, eps):
    """softmin_merge_kernel: the splits' (max, sum) partials of each row
    into eps * ln 2 * (M + log2 S), or -inf where every partial is -inf."""
    pm = np.stack([p[0] for p in parts])
    ps = np.stack([p[1] for p in parts])
    big = pm.max(axis=0)
    safe = np.where(big == -np.inf, np.float32(0), big)
    total = (ps * np.exp2(pm - safe)).sum(axis=0)
    with np.errstate(divide="ignore"):
        out = np.float32(eps) * np.float32(np.log(2)) * (safe + np.log2(total))
    return np.where(big == -np.inf, -np.inf, out).astype(np.float32)


@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_split_log2_softmin_matches_jax_kernel_and_plain(case):
    """The kernel's split, chunked, log2-domain online logsumexp (emulated
    with no invalid float operation) against the JAX Pallas softmin in
    interpret mode and the port's plain version: 1e-5 absolute."""
    x, y, dual, _ = clouds(3, n=130, m=301)
    cols = 64  # five splits, the last one ragged
    if case == "dead_split":
        dual[64:128] = -np.inf  # the second split sees only -inf
        dual[:3] = -np.inf
    elif case == "all_inf":
        dual[:] = -np.inf  # every row sees only -inf
    with np.errstate(invalid="raise"):
        got = split_softmin(x, y, dual, EPS, cols)
    plain = softmin_plain(*map(torch.from_numpy, (x, y, dual)), EPS).numpy()
    if case == "all_inf":
        assert (got == -np.inf).all() and (plain == -np.inf).all()
        return
    want = np.asarray(sp.softmin_pallas(*map(jnp.asarray, (x, y, dual)), EPS, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)


def split_transport(x, y, u, v, eps, cols, chunk=16):
    """The transport kernel's algorithm (csrc/sinkhorn.cu) in float32 numpy:
    packed log2-domain duals (columns past m padded to `chunk` with -inf),
    c = sq * rsqrt(sq) (0 below the smallest normal), z = -c k2 + (u2_i +
    v2_j), exp2(z) flushed to 0 below the smallest normal, a float32
    partial per row and column split of `cols`, and a float64 total of the
    partials."""
    k2 = np.float32(1.4426950408889634) / np.float32(eps)
    m = y.shape[0]
    m_pad = -(-m // chunk) * chunk
    v2 = np.full(m_pad, -np.inf, np.float32)
    v2[:m] = v * k2
    u2 = (u * k2).astype(np.float32)
    y_pad = np.zeros((m_pad, y.shape[1]), np.float32)
    y_pad[:m] = y
    sq = ((x[:, None, :] - y_pad[None]) ** 2).sum(-1, dtype=np.float32)
    tiny = np.finfo(np.float32).tiny
    c = np.where(sq >= tiny, sq / np.sqrt(np.maximum(sq, tiny)), np.float32(0))
    z = (-c * k2 + (u2[:, None] + v2[None])).astype(np.float32)
    plan = np.exp2(z)
    terms = np.where(plan >= tiny, plan, np.float32(0)) * c
    parts = [terms[:, j0 : j0 + cols].sum(axis=1, dtype=np.float32)
             for j0 in range(0, m_pad, cols)]
    return float(np.stack(parts).astype(np.float64).sum())


@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_split_log2_transport_matches_jax_kernel_and_plain(case):
    """The kernel's split, log2-domain transport sum (emulated with no
    invalid float operation) against the JAX Pallas transport cost in
    interpret mode (1e-3 relative, the JAX cancellation bar above), float64
    truth and the port's plain version (1e-5 relative); all -inf duals give
    exactly 0."""
    x, y, v, u = clouds(3, n=130, m=301)
    cols = 64  # five splits, the last one ragged
    if case == "dead_split":
        v[64:128] = -np.inf  # the second split sees only -inf
        u[:3] = -np.inf
    elif case == "all_inf":
        u[:] = -np.inf
        v[:] = -np.inf
    with np.errstate(invalid="raise"):
        got = split_transport(x, y, u, v, EPS, cols)
    plain = float(transport_cost_plain(*map(torch.from_numpy, (x, y, u, v)), EPS))
    if case == "all_inf":
        assert got == 0.0 and plain == 0.0
        return
    want = float(sp.transport_cost_pallas(*map(jnp.asarray, (x, y, u, v)), EPS, interpret=True))
    assert got == pytest.approx(want, rel=1e-3)
    assert got == pytest.approx(f64_truth(x, y, v, u, EPS)[1], rel=1e-5)
    assert got == pytest.approx(plain, rel=1e-5)


# The wide body of csrc/sinkhorn.cu (d > 16): blocks of WIDE_TILE rows walk
# tiles of WIDE_TILE columns; in a tile, each of the 16 threads of a row
# holds the 8 columns LANES[t] (t * 4 + q and 64 + t * 4 + q, q < 4), and the
# squared distances are summed over k-slices of K_SLICE coordinates, the
# last one only up to d.
WIDE_TILE, K_SLICE = 128, 8
LANES = np.array([[t * 4 + q for q in range(4)] + [64 + t * 4 + q for q in range(4)]
                  for t in range(16)])


def wide_padded(y, dual, scale):
    """The columns padded to whole tiles and their duals times `scale`
    (softmin's log2 domain, transport's natural units), -inf past m."""
    m = y.shape[0]
    m_pad = -(-m // WIDE_TILE) * WIDE_TILE
    v2 = np.full(m_pad, -np.inf, np.float32)
    v2[:m] = dual * scale
    y_pad = np.zeros((m_pad, y.shape[1]), np.float32)
    y_pad[:m] = y
    return y_pad, v2


def wide_distances(x, y_pad):
    """c = sq * rsqrt(sq), 0 below the smallest normal, from the squared
    distances summed in float32 slice by slice in the order k = 0..d-1 (the
    kernel's fma rounds each term once, this twice)."""
    d = x.shape[1]
    sq = np.zeros((x.shape[0], y_pad.shape[0]), np.float32)
    for k0 in range(0, d, K_SLICE):
        for k in range(k0, min(k0 + K_SLICE, d)):
            df = x[:, k, None] - y_pad[None, :, k]
            sq += df * df
    tiny = np.finfo(np.float32).tiny
    return np.where(sq >= tiny, sq / np.sqrt(np.maximum(sq, tiny)), np.float32(0))


def online_merge(mx, s, mo, so):
    """Two running (max, sum) pairs into one, rescaled against 0 where both
    maxima are -inf."""
    mn = np.maximum(mx, mo)
    base = np.where(mn == -np.inf, np.float32(0), mn)
    return mn, s * np.exp2(mx - base) + so * np.exp2(mo - base)


def wide_softmin(x, y, dual, eps, cols):
    """The wide body's softmin in float32 numpy: each thread's online max
    moved once per tile over its 8 columns, then the 16 threads of a row
    merged by butterfly (partner t ^ 8, ^ 4, ^ 2, ^ 1), then the splits of
    `cols` columns (a multiple of the tile)."""
    k2 = np.float32(1.4426950408889634) / np.float32(eps)
    y_pad, v2 = wide_padded(y, dual, k2)
    z = (-wide_distances(x, y_pad) * k2 + v2[None]).astype(np.float32)
    parts = []
    for j0 in range(0, y_pad.shape[0], cols):
        mx = np.full((x.shape[0], 16), -np.inf, np.float32)
        s = np.zeros((x.shape[0], 16), np.float32)
        for t0 in range(j0, min(j0 + cols, y_pad.shape[0]), WIDE_TILE):
            zt = z[:, t0 + LANES]  # (n, thread, its 8 columns)
            mn = np.maximum(mx, zt.max(axis=-1))
            base = np.where(mn == -np.inf, np.float32(0), mn)
            acc = s * np.exp2(mx - base)
            for j in range(LANES.shape[1]):
                acc = acc + np.exp2(zt[..., j] - base)
            mx, s = mn, acc
        for o in (8, 4, 2, 1):
            partner = np.arange(16) ^ o
            mx, s = online_merge(mx, s, mx[:, partner], s[:, partner])
        parts.append((mx[:, 0], s[:, 0]))
    return merge_softmin_partials(parts, eps)


def wide_transport(x, y, u, v, eps, cols):
    """The wide body's transport in float32 numpy: the exponent in natural
    units, ((u_i - c) + v_j) * log2(e)/eps, exp2 flushed to 0 below the
    smallest normal, each thread's float32 sum per row over its 8 columns
    of every tile of a split of `cols` columns, then the partials totalled
    in float64."""
    k2 = np.float32(1.4426950408889634) / np.float32(eps)
    y_pad, v_pad = wide_padded(y, v, np.float32(1))
    c = wide_distances(x, y_pad)
    plan = np.exp2((((u[:, None] - c) + v_pad[None]) * k2).astype(np.float32))
    terms = np.where(plan >= np.finfo(np.float32).tiny, plan, np.float32(0)) * c
    total = 0.0
    for j0 in range(0, y_pad.shape[0], cols):
        acc = np.zeros((x.shape[0], 16), np.float32)
        for t0 in range(j0, min(j0 + cols, y_pad.shape[0]), WIDE_TILE):
            for j in range(LANES.shape[1]):
                acc = acc + terms[:, t0 + LANES[:, j]]
        total += float(acc.astype(np.float64).sum())
    return total


def plan_duals64(x, y, eps):
    """The duals after one Sinkhorn iteration from uniform weights, in
    float64 then cast to float32: at d > 16 random duals leave every plan
    entry below float32's smallest normal, these carry mass."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)

    def softmin64(a, b, dual):
        z = (-np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)) + dual[None]) / eps
        zmax = z.max(axis=1, keepdims=True)
        return eps * (np.log(np.exp(z - zmax).sum(axis=1)) + zmax[:, 0])

    n, m = x.shape[0], y.shape[0]
    u = eps * math.log(1 / n) - softmin64(x64, y64, np.full(m, eps * math.log(1 / m)))
    v = eps * math.log(1 / m) - softmin64(y64, x64, u)
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("d", [17, 50])
@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_wide_softmin_matches_jax_kernel_f64_and_plain(d, case):
    """The wide body's order of operations (emulated with no invalid float
    operation) at widths that are no multiple of the k-slice, against the
    JAX Pallas softmin in interpret mode, float64 truth and the port's plain
    version: 1e-5 absolute. Three splits of one tile, the last ragged;
    "dead_split": the second split sees only -inf; "all_inf": every row
    gives -inf."""
    x, y, dual, _ = clouds(d, n=130, m=301)
    cols = WIDE_TILE
    if case == "dead_split":
        dual[cols : 2 * cols] = -np.inf
        dual[:3] = -np.inf
    elif case == "all_inf":
        dual[:] = -np.inf
    with np.errstate(invalid="raise"):
        got = wide_softmin(x, y, dual, EPS, cols)
    plain = softmin_plain(*map(torch.from_numpy, (x, y, dual)), EPS).numpy()
    if case == "all_inf":
        assert (got == -np.inf).all() and (plain == -np.inf).all()
        return
    want = np.asarray(sp.softmin_pallas(*map(jnp.asarray, (x, y, dual)), EPS, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, f64_truth(x, y, dual, np.zeros(130, np.float32), EPS)[0],
                               atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)


@pytest.mark.parametrize("d", [17, 50])
@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_wide_transport_matches_jax_kernel_f64_and_plain(d, case):
    """The wide body's transport sum (emulated with no invalid float
    operation) on the duals of one Sinkhorn iteration, against the JAX
    Pallas transport cost in interpret mode (1e-3 relative, the JAX
    cancellation bar above), float64 truth and the port's plain version
    (1e-5 relative); all -inf duals give exactly 0."""
    x, y = clouds(d, n=130, m=301)[:2]
    u, v = plan_duals64(x, y, EPS)
    cols = WIDE_TILE
    if case == "dead_split":
        v[cols : 2 * cols] = -np.inf
        v[:7] = -np.inf
        u[:5] = -np.inf
    elif case == "all_inf":
        u[:] = -np.inf
        v[:] = -np.inf
    with np.errstate(invalid="raise"):
        got = wide_transport(x, y, u, v, EPS, cols)
    plain = float(transport_cost_plain(*map(torch.from_numpy, (x, y, u, v)), EPS))
    if case == "all_inf":
        assert got == 0.0 and plain == 0.0
        return
    assert got > 0
    want = float(sp.transport_cost_pallas(*map(jnp.asarray, (x, y, u, v)), EPS, interpret=True))
    assert got == pytest.approx(want, rel=1e-3)
    assert got == pytest.approx(f64_truth(x, y, v, u, EPS)[1], rel=1e-5)
    assert got == pytest.approx(plain, rel=1e-5)


def test_sinkhorn_on_mixture_samples_matches_float64():
    """The evaluation's Sinkhorn (eps = 1e-3) between two exact sample sets
    of the grid mixture (conf/target/gmm.yaml, d = 2), where the plan sits
    on nearest neighbours far closer than the modes' spread: the port's
    float32 direct differences and the JAX XLA evaluator's float32
    quadratic form both agree with the port's loop in float64 to 1e-4."""
    from sde_sampler_torch.distr.gauss import GMM

    g = GMM(name="grid")
    gen = torch.Generator().manual_seed(0)
    x, y = g.sample((1000,), gen), g.sample((1000,), gen)
    eps = 1e-3
    got = float(Sinkhorn(eps=eps)(x, y))
    want_jax = float(JSinkhorn(eps=eps, backend="xla")(jnp.asarray(x.numpy()),
                                                       jnp.asarray(y.numpy())))
    xd, yd = x.double(), y.double()
    log_w = torch.full((1000,), math.log(1e-3), dtype=torch.float64)
    u, v = torch.zeros_like(log_w), eps * log_w
    for _ in range(100):
        u_new = log_w * eps - softmin_plain(xd, yd, v, eps)
        v_new = log_w * eps - softmin_plain(yd, xd, u_new, eps)
        err = max(float((u - u_new).abs().max()), float((v - v_new).abs().max()))
        u, v = u_new, v_new
        if not err >= 1e-5:
            break
    exact = float(transport_cost_plain(xd, yd, u, v, eps))
    assert got == pytest.approx(exact, rel=1e-4)
    assert want_jax == pytest.approx(exact, rel=1e-4)


@pytest.mark.parametrize("p", [1, 3, 4])
def test_sinkhorn_with_other_p_matches_jax(p):
    """p != 2 runs the JAX package's XLA cost (`_cost_tile`) in plain torch:
    the L1 distance at p = 1, (sum of p-th powers)^(1/p) otherwise. Without
    an absolute value there, an odd p > 1 gives NaN on both sides (p = 3);
    p = 4 is finite. Values to 1e-4 relative: float32 iterations whose
    logsumexps are summed in another order."""
    x, y = clouds(3, n=160, m=160, seed=p)[:2]
    kw = dict(p=p, eps=EPS, max_iters=30)
    want = float(JSinkhorn(backend="xla", **kw)(jnp.asarray(x), jnp.asarray(y)))
    got = float(Sinkhorn(**kw)(torch.from_numpy(x), torch.from_numpy(y)))
    if p == 3:
        assert math.isnan(want) and math.isnan(got)
    else:
        assert math.isfinite(got) and got == pytest.approx(want, rel=1e-4)
