"""Targets of the port vs the JAX package: the Gaussian mixture (all six
presets), Gauss, DoubleWell and MultiWell, and the Boole quadrature of
their statistics.

The same numpy-seeded points go through each JAX distribution and its port;
both compute in float32 with the same formulas and differ only in the order
of additions and in transcendental rounding, so densities and scores agree
to 1e-5 relative (atol 1e-5, 1e-4 where the values reach 1e2 to 1e4: the
far-field log-densities of the multi preset). Statistics from quadrature
(the wells) agree to 1e-5; those from sampling (a MultiWell's Gaussian
coordinates) differ by the Monte Carlo error of 1e7 samples, about 1e-3 of
their value. The sampling oracles repeat tests/test_distr.py's with the
port's own generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr import double_well as jdw
from sde_sampler_tpu.distr import gauss as jg
from sde_sampler_tpu.utils import quad as jquad
from sde_sampler_torch.distr import double_well as dw
from sde_sampler_torch.distr import gauss as g
from sde_sampler_torch.distr.base import Distribution, sample_uniform
from sde_sampler_torch.utils import quad

PRESETS = ["heart", "dist", "fab", "multi", "grid", "circle"]


def both(jax_fn, port_fn, x):
    return np.asarray(jax_fn(jnp.asarray(x))), port_fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", PRESETS)
def test_gmm_presets_match_jax(name):
    j, p = jg.GMM(name=name, domain_tol=None), g.GMM(name=name, domain_tol=None)
    for attr in ("loc", "scale", "log_mix_weights", "domain"):
        np.testing.assert_array_equal(getattr(p, attr).numpy(), np.asarray(getattr(j, attr)),
                                      err_msg=attr)
    # sums over 40 or 80 components, in another order
    np.testing.assert_allclose(p.stddevs.numpy(), np.asarray(j.stddevs), rtol=1e-6)
    lo, hi = np.asarray(j.domain).T
    x = np.random.default_rng(0).uniform(lo, hi, size=(256, 2)).astype(np.float32)
    atol = 1e-4 if name in ("fab", "multi") else 1e-5
    np.testing.assert_allclose(*both(j.unnorm_log_prob, p.unnorm_log_prob, x),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(*both(j.score, p.score, x), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(
        *both(lambda v: j.marginal(v[:, 0]), lambda v: p.marginal(v[:, 0]), x),
        rtol=1e-5, atol=1e-7)
    assert p.log_norm_const == j.log_norm_const == 0.0


def test_gmm_fab_and_multi_constants():
    """The FAB benchmark's modes, from a torch generator seeded at 42, and
    softplus(1) scales (tests/test_distr.py:149)."""
    loc, scale, weights = g.gmm_params("fab")
    generator = torch.Generator().manual_seed(42)
    want = ((torch.rand((40, 2), generator=generator) - 0.5) * 80)
    torch.testing.assert_close(loc, want, atol=1e-6, rtol=0)
    assert float(scale[0, 0]) == pytest.approx(1.3132617, rel=1e-5)
    assert g.gmm_params("multi")[0].shape == (80, 2)
    assert weights.shape == (40,) and bool((weights == 1).all())
    # the tolerance check of the domain still raises for a preset that fails it
    with pytest.raises(ValueError, match="tolerance"):
        g.GMM(name="grid", domain_scale=1.0)


def test_single_gaussians_are_one_component_mixtures():
    x = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32) * 2
    for j, p in ((jg.Gauss(dim=3, loc=1.0, scale=2.0), g.Gauss(dim=3, loc=1.0, scale=2.0)),
                 (jg.IsotropicGauss(dim=3, loc=0.5, scale=1.5),
                  g.IsotropicGauss(dim=3, loc=0.5, scale=1.5))):
        assert isinstance(p, g.GMM) and p.loc.shape == (1, 3)
        np.testing.assert_allclose(*both(j.unnorm_log_prob, p.unnorm_log_prob, x),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(*both(j.score, p.score, x), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(p.stddevs.numpy(), np.asarray(j.stddevs))
        np.testing.assert_array_equal(p.domain.numpy(), np.asarray(j.domain))
    # the mixture's own score at K = 1 is the Gaussian's
    p = g.Gauss(dim=3, loc=1.0, scale=2.0)
    torch.testing.assert_close(g.GMM.score(p, torch.from_numpy(x)), p.score(torch.from_numpy(x)))


def test_gauss_exact_stats():
    """tests/test_distr.py:60, with the port's generator."""
    p = g.Gauss(dim=2, loc=1.0, scale=2.0, n_reference_samples=200_000)
    p.compute_stats(torch.Generator().manual_seed(0))
    assert p.expectations["sum"] == pytest.approx(2.0, abs=0.05)
    assert p.expectations["square"] == pytest.approx(10.0, rel=0.03)
    torch.testing.assert_close(p.stddevs, torch.full((2,), 2.0))


def test_gmm_sample_moments():
    """tests/test_distr.py:139: the grid's variance 0.3 + 50/3 per axis."""
    p = g.GMM(name="grid")
    samples = p.sample((200_000,), generator=torch.Generator().manual_seed(0))
    assert float(samples.mean(0)[0]) == pytest.approx(0.0, abs=0.05)
    expected_var = 0.3 + 50.0 / 3.0
    assert float(samples[:, 0].var()) == pytest.approx(expected_var, rel=0.03)
    assert float(p.stddevs[0] ** 2) == pytest.approx(expected_var, rel=1e-4)
    # weighted mixtures: the components in proportion to their weights
    w = g.GMM(dim=1, loc=[[-5.0], [5.0]], scale=[[0.1], [0.1]], mixture_weights=[1.0, 3.0],
              domain_tol=None)
    s = w.sample((40_000,), generator=torch.Generator().manual_seed(1))
    assert float((s > 0).float().mean()) == pytest.approx(0.75, abs=0.01)


@pytest.mark.parametrize("name", PRESETS)
def test_gmm_named_presets_all_construct(name):
    """tests/test_distr.py:158."""
    p = g.GMM(name=name, domain_tol=None)
    x = p.sample((64,), generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(p.unnorm_log_prob(x)).all())
    assert bool(torch.isfinite(p.score(x)).all())
    scores = p.score(x)
    torch.testing.assert_close(scores, Distribution.score(p, x), rtol=1e-4, atol=1e-4)


def test_double_well_statistics_match_jax():
    """Boole quadrature on 2001 points: log Z, the expectations and the
    standard deviation, to the JAX package's float32 values."""
    j, p = jdw.DoubleWell(separation=2.0, shift=1.5), dw.DoubleWell(separation=2.0, shift=1.5)
    j.compute_stats()
    p.compute_stats()
    np.testing.assert_array_equal(p.domain.numpy(), np.asarray(j.domain))
    assert p.log_norm_const == pytest.approx(j.log_norm_const, rel=1e-5)
    for name, value in j.expectations.items():
        assert p.expectations[name] == pytest.approx(value, rel=1e-5, abs=1e-5), name
    np.testing.assert_allclose(p.stddevs.numpy(), np.asarray(j.stddevs), rtol=1e-5)
    x = np.random.default_rng(2).uniform(-2, 5, size=(128, 1)).astype(np.float32)
    np.testing.assert_allclose(*both(j.log_prob, p.log_prob, x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*both(j.score, p.score, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,n_wells,sep", [(5, 5, 4.0), (4, 2, 2.0)])
def test_multiwell_statistics_match_jax(dim, n_wells, sep):
    """mw (d = 5, five wells, separation 4): factorised quadrature, exact to
    1e-5. With Gaussian coordinates (d = 4, two wells) their expectations
    come from 1e7 samples on each side (JAX key 0, the port's generator):
    Monte Carlo error about 1e-3 of the value."""
    j = jdw.MultiWell(dim=dim, n_double_wells=n_wells, separation=sep)
    p = dw.MultiWell(dim=dim, n_double_wells=n_wells, separation=sep)
    j.compute_stats()
    p.compute_stats(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(p.domain.numpy(), np.asarray(j.domain))
    assert p.log_norm_const == pytest.approx(j.log_norm_const, rel=1e-5)
    rel = 1e-5 if dim == n_wells else 2e-3
    for name, value in j.expectations.items():
        assert p.expectations[name] == pytest.approx(value, rel=rel, abs=rel), name
    np.testing.assert_allclose(p.stddevs.numpy(), np.asarray(j.stddevs), rtol=1e-5)
    x = np.random.default_rng(3).normal(size=(128, dim)).astype(np.float32) * 2
    np.testing.assert_allclose(*both(j.unnorm_log_prob, p.unnorm_log_prob, x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*both(j.score, p.score, x), rtol=1e-5, atol=1e-5)


def test_double_well_quadrature_vs_sampling():
    """tests/test_distr.py:69."""
    p = dw.DoubleWell(separation=2.0, shift=0.0)
    p.compute_stats()
    samples = p.sample((100_000,), generator=torch.Generator().manual_seed(0))
    assert float((samples**2).mean()) == pytest.approx(p.expectations["square"], rel=0.02)
    assert float(samples.std()) == pytest.approx(float(p.stddevs[0]), rel=0.02)
    assert p.expectations["sum"] == pytest.approx(0.0, abs=1e-3)


def test_multiwell_factorized_stats():
    """tests/test_distr.py:81."""
    mw = dw.MultiWell(dim=4, n_double_wells=2, separation=2.0)
    mw.compute_stats(torch.Generator().manual_seed(0))
    single = dw.DoubleWell(separation=2.0)
    single.compute_stats()
    assert mw.log_norm_const == pytest.approx(
        2 * single.log_norm_const + mw.gauss.log_norm_const, rel=1e-5)
    samples = mw.sample((50_000,), generator=torch.Generator().manual_seed(1))
    assert samples.shape == (50_000, 4)
    emp = float((samples**2).sum(-1).mean())
    assert emp == pytest.approx(mw.expectations["square"], rel=0.05)


def test_rejection_sampling_distribution():
    """tests/test_distr.py:129."""
    p = dw.DoubleWell(separation=2.0, shift=1.0)
    p.compute_stats()
    samples = p.sample((50_000,), generator=torch.Generator().manual_seed(2))
    assert samples.shape == (50_000, 1)
    assert float(samples.abs().mean()) == pytest.approx(p.expectations["abs"], rel=0.03)


@pytest.mark.parametrize("dim,n_total", [(1, 2001), (2, 1_000_000)])
def test_boole_quadrature_matches_jax(dim, n_total):
    """The 2-d grid (1001² points) streams in chunks of 2^18 on both sides."""
    assert quad._points_per_dim(n_total, dim) == jquad._points_per_dim(n_total, dim)
    m = quad._points_per_dim(n_total, dim)
    np.testing.assert_array_equal(quad._boole_weights_1d(m, 0.25).numpy(),
                                  np.asarray(jquad._boole_weights_1d(m, 0.25)))
    domain = np.array([[-3.0, 4.0], [-2.0, 2.5]][:dim], dtype=np.float32)

    def fn(xp):
        return lambda x: xp.exp(-(x**2).sum(-1, keepdims=True) / 2) * (1 + x[:, :1])

    want = float(jquad.integrate(fn(jnp), dim, n_total, jnp.asarray(domain)))
    got = float(quad.integrate(
        lambda x: torch.exp(-(x**2).sum(-1, keepdim=True) / 2) * (1 + x[:, :1]),
        dim, n_total, torch.from_numpy(domain)))
    assert got == pytest.approx(want, rel=1e-5)


def test_sample_uniform_covers_the_domain():
    domain = torch.tensor([[-1.0, 2.0], [3.0, 3.5]])
    x = sample_uniform(domain, 10_000, generator=torch.Generator().manual_seed(0))
    assert x.shape == (10_000, 2)
    assert bool(((x >= domain[:, 0]) & (x <= domain[:, 1])).all())
    torch.testing.assert_close(x.mean(0), domain.mean(1), atol=0.02, rtol=0)


def test_rings_match_jax():
    """The rings (conf/target/rings.yaml): the domain, log-density and score
    (the nearest radius, the first on ties) to 1e-5 relative, on points
    that include exact ties between two radii; the 2001² Boole statistics
    and a marginal to 1e-4 relative (4 million float32 terms, summed in
    other chunks); the boundary check raises on a domain too small."""
    from sde_sampler_tpu.distr.rings import Rings as JRings
    from sde_sampler_torch.distr.rings import Rings

    j, p = JRings(), Rings()
    np.testing.assert_array_equal(p.domain.numpy(), np.asarray(j.domain))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 2)).astype(np.float32) * 3
    x[:4] = [[2.0, 0.0], [0.0, -4.0], [0.6, 0.8], [-3.0, 4.0]]  # |x| = 2, 4 (ties), 1, 5
    np.testing.assert_allclose(*both(j.unnorm_log_prob, p.unnorm_log_prob, x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*both(j.score, p.score, x), rtol=1e-5, atol=1e-4)
    j.compute_stats()
    p.compute_stats()
    assert p.log_norm_const == pytest.approx(j.log_norm_const, rel=1e-4)
    for name, value in j.expectations.items():
        assert p.expectations[name] == pytest.approx(value, rel=1e-4, abs=1e-4), name
    np.testing.assert_allclose(p.stddevs.numpy(), np.asarray(j.stddevs), rtol=1e-4)
    np.testing.assert_allclose(*both(j.log_prob, p.log_prob, x), rtol=1e-4, atol=1e-4)
    grid = np.linspace(-6, 6, 9, dtype=np.float32)
    np.testing.assert_allclose(p.marginal(torch.from_numpy(grid), dim=1).numpy(),
                               np.asarray(j.marginal(jnp.asarray(grid), dim=1)),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="tolerance"):
        # the box's corner (5, 1) lies 0.1 from the outer ring
        Rings(domain=[[0.0, 5.0], [-1.0, 1.0]], grid_points=101**2).compute_stats()


def test_rosenbrock_matches_jax():
    """conf/target/rosenbrock.yaml (d = 15): the log-density to 1e-5
    relative; the analytic score against the JAX package's `jax.grad` to
    1e-5 relative (atol 1e-4 on values up to about 1e4); the objective
    metrics of `get_metrics` to the JAX ones."""
    from sde_sampler_tpu.distr.rosenbrock import Rosenbrock as JRosenbrock
    from sde_sampler_tpu.eval.metrics import get_metrics as jget_metrics
    from sde_sampler_torch.distr.rosenbrock import Rosenbrock
    from sde_sampler_torch.eval.metrics import get_metrics

    kw = dict(dim=15, flatness=10.0, scale=1e5)
    j, p = JRosenbrock(**kw), Rosenbrock(**kw)
    x = np.random.default_rng(6).normal(size=(64, 15)).astype(np.float32) * 1.5
    np.testing.assert_allclose(*both(j.unnorm_log_prob, p.unnorm_log_prob, x),
                               rtol=1e-5, atol=1e-4)
    want, got = both(j.score, p.score, x)
    assert np.abs(want).max() > 1e2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # the score of a (T, B, d) stack is that of each (B, d) slice
    stack = torch.from_numpy(x).reshape(4, 16, 15)
    torch.testing.assert_close(p.score(stack).reshape(64, 15), torch.from_numpy(got))
    j.compute_stats()
    p.compute_stats()
    want = jget_metrics(j, jnp.asarray(x))
    got = get_metrics(p, torch.from_numpy(x))
    for key in ("eval/obj_avg", "eval/avg_obj", "eval/min_obj"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
