"""The port's SDE integrators (`sde_sampler_torch/eq/integrator.py`) and
`LangevinSDE` vs the JAX package on the CPU.

Euler, Heun and adaptive Heun run on one shared Brownian path: a
piecewise-linear path through numpy knots, evaluated with the same float32
arithmetic on both sides. They must agree to 1e-5 (absolute and relative;
float32 on both sides, the same operations), adaptive Heun also in its
sequence of trial steps, which the test asserts. The continuous-adjoint
Euler is held against the JAX adjoint's gradients on a zero-diffusion SDE
to 1e-5 relative; on a stochastic SDE its gradients converge to the port's
own direct autograd gradients on the same tree path, with the bounds of
tests/test_eq.py:282. The virtual Brownian tree cannot reproduce JAX's
threefry draws; it is held to the statistics and continuity that
tests/test_eq.py:131,149 ask of the JAX tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.eq import integrator as jint
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import LangevinSDE as JLangevinSDE
from sde_sampler_tpu.utils.common import get_timesteps as jget_timesteps
from sde_sampler_torch.distr.gauss import GMM
from sde_sampler_torch.eq import integrator as pint
from sde_sampler_torch.eq.sdes import VP, ConstOU, LangevinSDE
from sde_sampler_torch.utils.common import get_timesteps

B, D = 32, 2
TOL = dict(atol=1e-5, rtol=1e-5)


def knots(t0, t1, n, seed=0, shape=(B, D)):
    """A Brownian path's values at n + 1 equispaced knots, float32."""
    rng = np.random.default_rng(seed)
    tk = np.linspace(t0, t1, n + 1).astype(np.float32)
    inc = rng.normal(size=(n, *shape)) * np.sqrt(np.diff(tk.astype(np.float64)))[:, None, None]
    w = np.concatenate([np.zeros((1, *shape)), np.cumsum(inc, axis=0)]).astype(np.float32)
    return tk, w


def jax_path(tk, w):
    tk, w = jnp.asarray(tk), jnp.asarray(w)

    def bm(t):
        t = jnp.asarray(t, jnp.float32)
        i = jnp.clip(jnp.searchsorted(tk, t, side="right") - 1, 0, tk.shape[0] - 2)
        frac = (t - tk[i]) / (tk[i + 1] - tk[i])
        return w[i] + frac * (w[i + 1] - w[i])

    return bm


def torch_path(tk, w):
    tk, w = torch.from_numpy(tk), torch.from_numpy(w)

    def bm(t):
        t = torch.as_tensor(t, dtype=torch.float32).reshape(1)
        i = torch.clamp(torch.searchsorted(tk, t, right=True) - 1, 0, tk.shape[0] - 2)[0]
        frac = (t[0] - tk[i]) / (tk[i + 1] - tk[i])
        return w[i] + frac * (w[i + 1] - w[i])

    return bm


def sde_pair(kind):
    if kind == "langevin":
        j_target, target = JGMM(name="grid"), GMM(name="grid")
        return (JLangevinSDE(j_target.score, diff_coeff=1.3, clip_score=30.0),
                LangevinSDE(target.score, diff_coeff=1.3, clip_score=30.0))
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
    return JVP(**kw), VP(**kw)


def x_init(seed=1, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(B, D)) * scale).astype(np.float32)


def test_langevin_sde_drift_matches_jax():
    """clip(σ²/2 · score) elementwise, and σ, on states far enough out that
    the clip binds."""
    j_sde, sde = sde_pair("langevin")
    x = x_init(scale=8.0)
    want = np.asarray(j_sde.drift(0.3, jnp.asarray(x)))
    got = sde.drift(torch.tensor(0.3), torch.from_numpy(x)).numpy()
    assert np.abs(want).max() == pytest.approx(30.0)  # the clip binds
    np.testing.assert_allclose(got, want, **TOL)
    assert np.float32(sde.diff(0.0, None)) == np.float32(j_sde.diff(0.0, None))


@pytest.mark.parametrize("scheme", ["euler", "heun"])
@pytest.mark.parametrize("kind", ["langevin", "vp"])
def test_fixed_step_schemes_match_jax_on_a_shared_path(scheme, kind):
    """40 internal steps interpolated onto 7 output times (some between
    grid points, the last at the end), noise from one shared path."""
    j_sde, sde = sde_pair(kind)
    tk, w = knots(0.0, 1.0, 40)
    ts = np.array([0.0, 0.1, 0.33, 0.5, 0.61, 0.9, 1.0], np.float32)
    x0 = x_init()
    cls = {"euler": (jint.EulerIntegrator, pint.EulerIntegrator),
           "heun": (jint.HeunIntegrator, pint.HeunIntegrator)}[scheme]
    want = cls[0](steps=40).integrate(j_sde, jnp.asarray(ts), jnp.asarray(x0),
                                      jax.random.PRNGKey(0), bm=jax_path(tk, w))
    got = cls[1](steps=40).integrate(sde, torch.from_numpy(ts), torch.from_numpy(x0),
                                     bm=torch_path(tk, w))
    assert got.shape == (7, B, D)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_euler_interpolates_onto_the_output_grid():
    """dx/dt = 1 from 0: the outputs are their own times (tests/test_eq.py)."""

    class Drift(ConstOU):
        def drift(self, t, x):
            return torch.ones_like(x)

        def diff(self, t, x):
            return 0.0

    ts = torch.tensor([0.0, 0.25, 0.5, 1.0])
    xs = pint.EulerIntegrator(steps=100).integrate(
        Drift(), ts, torch.zeros((1, 1)), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(xs[:, 0, 0].numpy(), [0.0, 0.25, 0.5, 1.0], atol=1e-5)


def test_euler_noise_comes_from_the_generator():
    """Without a path, the same generator seed gives the same rollout and
    another seed another one; Var(x_T) of a scaled BM is σ²T."""
    sde = ConstOU(drift_coeff=0.0, diff_coeff=1.5)
    ts = get_timesteps(0.0, 1.0, steps=4)
    x0 = torch.zeros((20000, 1))
    run = lambda seed: pint.EulerIntegrator(steps=50).integrate(
        sde, ts, x0, torch.Generator().manual_seed(seed))
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a[-1].var()) == pytest.approx(1.5**2, rel=0.05)


@pytest.mark.parametrize("internal", [False, True])
def test_adaptive_heun_matches_jax_step_for_step(internal):
    """The same trial steps (the same accept decisions, and every drift
    call's time, in order, to 1e-5) and states to 1e-5; with `internal`,
    the controller works on an 8-segment grid whose states are
    interpolated onto 4 output times."""
    j_target, target = JGMM(name="grid"), GMM(name="grid")
    j_times, p_times = [], []

    class JSDE(JLangevinSDE):
        def drift(self, t, x):
            jax.debug.callback(lambda v: j_times.append(float(v)), t, ordered=True)
            return super().drift(t, x)

    class PSDE(LangevinSDE):
        def drift(self, t, x):
            p_times.append(float(t))
            return super().drift(t, x)

    j_sde = JSDE(j_target.score, diff_coeff=1.0, clip_score=1e5)
    sde = PSDE(target.score, diff_coeff=1.0, clip_score=1e5)
    tk, w = knots(0.0, 0.4, 400, seed=3)
    x0 = x_init(seed=4, scale=2.0)
    kw = dict(dt=0.05, dt_min=0.0005, rtol=1e-3, atol=1e-3)
    if internal:
        ts, grid = np.array([0.0, 0.13, 0.3, 0.4], np.float32), jget_timesteps(0.0, 0.4, steps=8)
    else:
        ts, grid = np.array(jget_timesteps(0.0, 0.4, steps=5)), None
    want = jint.AdaptiveHeunIntegrator(**kw).integrate(
        j_sde, jnp.asarray(ts), jnp.asarray(x0), jax.random.PRNGKey(0),
        timesteps=grid, bm=jax_path(tk, w))
    want = np.asarray(want)
    jax.effects_barrier()
    integ = pint.AdaptiveHeunIntegrator(**kw)
    got = integ.integrate(sde, torch.from_numpy(ts), torch.from_numpy(x0),
                          timesteps=None if grid is None else torch.from_numpy(np.array(grid)),
                          bm=torch_path(tk, w))
    assert len(p_times) == len(j_times) == 2 * (integ.n_accepted + integ.n_rejected)
    # the same decisions: a trial was accepted where the next one starts later
    starts_p, starts_j = np.array(p_times[::2]), np.array(j_times[::2])
    np.testing.assert_array_equal(np.diff(starts_p) > 0, np.diff(starts_j) > 0)
    # the error estimate is a difference of close states, so the step sizes
    # it sets round apart by up to about 1e-5 relative
    np.testing.assert_allclose(p_times, j_times, rtol=1e-5)
    assert integ.n_rejected > 0 and integ.n_accepted > len(ts)  # the controller acted
    assert got.shape == (len(ts), B, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_adaptive_heun_is_exact_on_an_ode_and_raises_on_nan():
    """Zero diffusion: dx = -x dt integrates to exp(-1) (tests/test_eq.py);
    a NaN error estimate raises where the JAX loop would never end."""

    class ODE:
        def drift(self, t, x):
            return -x

        def diff(self, t, x):
            return torch.zeros_like(x)

    ts = get_timesteps(0.0, 1.0, steps=4)
    integ = pint.AdaptiveHeunIntegrator(dt=0.05, rtol=1e-5, atol=1e-7)
    xs = integ.integrate(ODE(), ts, torch.ones((8, 3)), torch.Generator().manual_seed(0))
    assert xs.shape == (5, 8, 3)
    np.testing.assert_allclose(xs[-1].numpy(), np.exp(-1.0) * np.ones((8, 3)), rtol=1e-4)

    class Broken(ODE):
        def drift(self, t, x):
            return x * float("nan")

    with pytest.raises(FloatingPointError, match="NaN"):
        integ.integrate(Broken(), ts, torch.ones((8, 3)), torch.Generator().manual_seed(0))


def test_virtual_brownian_tree_statistics():
    """W(0) = 0, Var W(t) = t, disjoint increments uncorrelated, W a pure
    function of t (tests/test_eq.py:131), and the hash the numpy splitmix64."""
    bm = pint.VirtualBrownianTree(0.0, 1.0, 0, (50_000, 1))
    assert float(bm(0.0).abs().max()) < 1e-6
    w_half, w_one = bm(0.5), bm(1.0)
    assert float(w_half.var()) == pytest.approx(0.5, rel=0.05)
    assert float(w_one.var()) == pytest.approx(1.0, rel=0.05)
    inc = w_one - w_half
    assert float(inc.var()) == pytest.approx(0.5, rel=0.05)
    assert abs(float((w_half * inc).mean()) / 0.5) < 0.05
    fresh = pint.VirtualBrownianTree(0.0, 1.0, 0, (50_000, 1))
    assert torch.equal(fresh(0.5), w_half) and torch.equal(bm(0.5), w_half)
    other = pint.VirtualBrownianTree(0.0, 1.0, 1, (50_000, 1))
    assert not torch.equal(other(0.5), w_half)

    z = np.arange(1, 200, dtype=np.uint64) * np.uint64(0x1234567890ABC)
    with np.errstate(over="ignore"):
        want = z + np.uint64(0x9E3779B97F4A7C15)
        want = (want ^ (want >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        want = (want ^ (want >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        want = want ^ (want >> np.uint64(31))
    got = pint.splitmix64(torch.from_numpy(z.view(np.int64)))
    assert np.array_equal(got.numpy(), want.view(np.int64))


def test_virtual_brownian_tree_continuity_and_bridge():
    """W(t + 1e-7) − W(t) is small (tests/test_eq.py:149), and the bridge
    variance between two times is right."""
    bm = pint.VirtualBrownianTree(0.0, 1.0, 1, (1000, 1))
    assert float((bm(0.3 + 1e-7) - bm(0.3)).abs().max()) < 1e-2
    big = pint.VirtualBrownianTree(0.0, 2.0, 2, (40_000, 1))
    inc = big(1.3) - big(0.7)
    assert float(inc.var()) == pytest.approx(0.6, rel=0.05)


def test_euler_strong_convergence_on_one_tree():
    """Driving two resolutions with the same tree path: halving dt 8 times
    shrinks the pathwise error about 8 times (strong order 1 for additive
    noise; tests/test_eq.py)."""
    sde = ConstOU(drift_coeff=1.0, diff_coeff=1.0, generative=False)
    x0 = torch.full((8, 1), 1.5)
    ts = torch.tensor([0.0, 1.0])
    bm = pint.VirtualBrownianTree(0.0, 1.0, 7, x0.shape)

    def terminal(steps):
        return pint.EulerIntegrator(steps=steps).integrate(sde, ts, x0, bm=bm)[-1]

    reference = terminal(4096)
    err_coarse = float((terminal(64) - reference).abs().max())
    err_fine = float((terminal(512) - reference).abs().max())
    assert err_coarse > err_fine > 0
    assert err_coarse / err_fine > 4.5, (err_coarse, err_fine)


class ThetaOU:
    """dx = (−θx + sin(θt)) dt + σ dW with a differentiable θ."""

    def __init__(self, theta, sigma):
        self.theta, self.sigma = theta, sigma

    def drift(self, t, x):
        return -self.theta * x + torch.sin(self.theta * t)

    def diff(self, t, x):
        return self.sigma


class JThetaOU:
    def __init__(self, theta, sigma):
        self.theta, self.sigma = theta, sigma

    def drift(self, t, x):
        return -self.theta * x + jnp.sin(self.theta * t)

    def diff(self, t, x):
        return self.sigma


def _loss(xs):
    return (xs[-1] ** 2).mean() + abs(xs).sum() * 0.1 + xs[1].sum()


def test_adjoint_gradients_match_jax_without_diffusion():
    """σ = 0: the JAX adjoint's gradients in θ and x0, to 1e-5 relative; the
    outputs include interior times, whose cotangents enter the backward
    pass between steps."""
    x0 = np.linspace(0.3, 1.2, 8).reshape(4, 2).astype(np.float32)
    ts = np.array([0.0, 0.37, 0.7, 1.0], np.float32)

    def jloss(theta, x):
        integ = jint.EulerIntegrator(steps=50, adjoint=True, depth=16)
        return _loss(integ.integrate(JThetaOU(theta, 0.0), jnp.asarray(ts), x,
                                     jax.random.PRNGKey(2)))

    want_theta, want_x = jax.grad(jloss, argnums=(0, 1))(jnp.float32(0.7), jnp.asarray(x0))
    theta = torch.tensor(0.7, requires_grad=True)
    x = torch.from_numpy(x0).requires_grad_(True)
    integ = pint.EulerIntegrator(steps=50, adjoint=True, depth=16)
    xs = integ.integrate(ThetaOU(theta, 0.0), torch.from_numpy(ts), x,
                         torch.Generator().manual_seed(2))
    _loss(xs).backward()
    np.testing.assert_allclose(float(theta.grad), float(want_theta), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("steps,tol", [(64, 0.05), (256, 0.015)])
def test_adjoint_gradients_converge_to_direct(steps, tol):
    """On a stochastic SDE the adjoint's forward values are the direct
    rollout's on the same tree path, and its gradient approaches the
    direct autograd gradient as dt → 0 (tests/test_eq.py:282)."""
    x0 = torch.linspace(0.3, 1.2, 8).reshape(4, 2)
    ts = torch.tensor([0.0, 1.0])
    seed = pint.draw_seed(torch.Generator().manual_seed(5))
    tree = pint.VirtualBrownianTree(0.0, 1.0, seed, x0.shape, depth=18)

    def run(adjoint):
        theta = torch.tensor(0.7, requires_grad=True)
        sde = ThetaOU(theta, 0.4)
        if adjoint:
            xs = pint.EulerIntegrator(steps=steps, adjoint=True, depth=18).integrate(
                sde, ts, x0, torch.Generator().manual_seed(5))
        else:
            xs = pint.EulerIntegrator(steps=steps).integrate(sde, ts, x0, bm=tree)
        loss = (xs[-1] ** 2).mean() + xs[-1].abs().sum() * 0.1
        loss.backward()
        return xs.detach(), float(theta.grad)

    xs_direct, g_direct = run(False)
    xs_adjoint, g_adjoint = run(True)
    torch.testing.assert_close(xs_adjoint, xs_direct, rtol=1e-5, atol=1e-6)
    assert g_direct != 0.0
    assert abs(g_adjoint - g_direct) / abs(g_direct) < tol, (g_adjoint, g_direct)


def test_adjoint_refuses_a_caller_path():
    """As the JAX package (`eq/integrator.py:178-185`): the adjoint builds its
    own tree."""
    sde = ConstOU()
    with pytest.raises(NotImplementedError, match="caller-supplied"):
        pint.EulerIntegrator(steps=4, adjoint=True).integrate(
            sde, torch.tensor([0.0, 1.0]), torch.zeros(2, 1), bm=lambda t: 0.0)
