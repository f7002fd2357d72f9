"""Exploration of the log-variance losses and the scan route of phase 1,
the port against `sde_sampler_tpu/losses/oc.py`.

Exploration noise and dropout of the sde control (`sde_ctrl_noise`,
`sde_ctrl_dropout`): the port takes its draws as tensors, ξ standard normals
and υ uniforms (T, B, d). The test derives them from the JAX package's own
key path, so that both sides explore with the same numbers: the loss key
splits into the noise key and the step keys (`_pregen_scan_inputs`); each
step's control key is `split(step_key)[0]` (the two-phase losses and the
time-reversal scan) or the step key itself (the reference-SDE and
exponential scans); from it `split` gives ξ's key, and `split` once more
υ's. Loss values agree to 1e-5 relative and gradients to 1e-5 of each
parameter tensor's largest (1e-4 for the exponential integrator, as
`tests/test_torch_port_dds.py`): float32, the T x B sums taken in another
order.

The scan route (`ops/rollout.py::scan_rollout`) is held against the fused
rollouts' plain twins on a FourierMLP control, and the route choice
(`phase1_route`) is checked for every control form of the kernels.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.funnel import Funnel as JFunnel
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.losses.oc import ExponentialIntegratorSDELoss as JExpLoss
from sde_sampler_tpu.losses.oc import ReferenceSDELoss as JReferenceSDELoss
from sde_sampler_tpu.losses.oc import TimeReversalLoss as JTimeReversalLoss
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import LerpCtrl as JLerpCtrl
from sde_sampler_tpu.models.reparam import ScoreCtrl as JScoreCtrl
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.losses.oc import (
    ExponentialIntegratorSDELoss,
    ReferenceSDELoss,
    TimeReversalLoss,
)
from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, MultilevelNet, TimeEmbed
from sde_sampler_torch.models.reparam import (
    CancelDriftCtrl,
    ClippedCtrl,
    LerpCtrl,
    LerpPriorCtrl,
    LerpTargetCtrl,
    PotentialCtrl,
    ScoreCtrl,
)
from sde_sampler_torch.ops import build
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

from test_torch_port_dds import cosine_grid

D, B, T = 10, 32, 8
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
NOISE, DROPOUT = 0.3, 0.5
KNOBS = {"noise": dict(sde_ctrl_noise=NOISE), "dropout": dict(sde_ctrl_dropout=DROPOUT),
         "both": dict(sde_ctrl_noise=NOISE, sde_ctrl_dropout=DROPOUT)}


def jax_explore(step_keys, shape, knobs, split_step_key):
    """ξ and υ (T, B, d) as `generative_and_sde_ctrl` draws them from each
    step's control key; None where the knob is unset."""
    xis, upss = [], []
    for step_key in step_keys:
        key = jax.random.split(step_key)[0] if split_step_key else step_key
        if "sde_ctrl_noise" in knobs:
            key, sub = jax.random.split(key)
            xis.append(np.asarray(jax.random.normal(sub, shape)))
        if "sde_ctrl_dropout" in knobs:
            key, sub = jax.random.split(key)
            upss.append(np.asarray(jax.random.uniform(sub, shape)))
    return (torch.from_numpy(np.stack(xis)) if xis else None,
            torch.from_numpy(np.stack(upss)) if upss else None)


_PARAMS = {}


def _carry(name, j_ctrl, ctrl):
    """JAX's init of `j_ctrl` compiled in one piece (the eager init compiles
    op by op), every leaf moved off its init, carried into `ctrl`."""
    if name not in _PARAMS:
        @jax.jit
        def init():
            params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, D)))
            return jax.tree_util.tree_map(
                lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
                params["params"])

        _PARAMS[name] = init()
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, _PARAMS[name]))
    return _PARAMS[name]


# nets smaller than the configs' (compile time): the forms are the same
NET = dict(num_layers=3, channels=32)


def lerp_pair():
    """The main path's LerpCtrl (`flagship_pair`'s) on the funnel in both
    packages."""
    j_prior, j_target = JIsoGauss(dim=D), JFunnel(dim=D, n_reference_samples=100)
    prior, target = IsotropicGauss(dim=D), Funnel(dim=D, n_reference_samples=100)
    j_sde, sde = JVP(**VP_KW), VP(**VP_KW)
    common = dict(clip_model=10.0, clip_score=10.0, detach_score=False)
    score = dict(dim_out=1, last_bias_init={"constant": 1.0}, **NET)
    j_ctrl = JLerpCtrl(base_model=JFourierMLP(dim=D, **NET), score_model=JTimeEmbed(**score),
                       sde=j_sde, prior_score=j_prior.score, target_score=j_target.score,
                       **common)
    ctrl = LerpCtrl(base_model=FourierMLP(dim=D, **NET), score_model=TimeEmbed(**score),
                    sde=sde, prior_score=prior.score, target_score=target.score, **common)
    return j_ctrl, ctrl, _carry("lerp", j_ctrl, ctrl)


def score_pair(j_sde, sde, targets):
    """A ScoreCtrl (`tests/test_torch_port_dds.py::score_pair`'s) on
    `targets`, a (JAX, port) pair."""
    common = dict(clip_model=10.0, clip_score=10.0, detach_score=False, scale_score=0.7)
    score = dict(dim_out=1, last_bias_init={"constant": 0.01}, **NET)
    j_ctrl = JScoreCtrl(base_model=JFourierMLP(dim=D, **NET), score_model=JTimeEmbed(**score),
                        sde=j_sde, target_score=targets[0].score, **common)
    ctrl = ScoreCtrl(base_model=FourierMLP(dim=D, **NET), score_model=TimeEmbed(**score),
                     sde=sde, target_score=targets[1].score, **common)
    return j_ctrl, ctrl, _carry("score", j_ctrl, ctrl), *targets


def setup(kind):
    """(JAX control, port control, params, JAX loss class, port loss class,
    loss kwargs of each side, ts, x0, the two log-densities of each side)."""
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    if kind == "time_reversal":
        j_ctrl, ctrl, params = lerp_pair()
        j_prior, j_target = j_ctrl.prior_score.__self__, j_ctrl.target_score.__self__
        prior, target = ctrl.prior_score.__self__, ctrl.target_score.__self__
        ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
        return dict(j_ctrl=j_ctrl, ctrl=ctrl, params=params, j_cls=JTimeReversalLoss,
                    cls=TimeReversalLoss, j_kw=dict(sde=j_ctrl.sde), kw=dict(sde=ctrl.sde),
                    ts=ts, x0=x0, j_logps=(j_target.unnorm_log_prob, j_prior.log_prob),
                    logps=(target.unnorm_log_prob, prior.log_prob), split_scan=True)
    # a Gaussian target: under the VP SDE's expansion the funnel's terminal
    # log-density of these short runs reaches 1e11
    vp_kw = dict(VP_KW, terminal_t=float(ts_for(kind)[-1]))
    j_sde, sde = JVP(**vp_kw), VP(**vp_kw)
    targets = (JIsoGauss(dim=D, loc=0.5, scale=1.5), IsotropicGauss(dim=D, loc=0.5, scale=1.5))
    j_ctrl, ctrl, params, j_target, target = score_pair(j_sde=j_sde, sde=sde, targets=targets)
    j_ref, ref = JIsoGauss(dim=D), IsotropicGauss(dim=D)
    common = dict(ts=ts_for(kind), x0=x0, j_logps=(j_target.unnorm_log_prob, j_ref.log_prob),
                  logps=(target.unnorm_log_prob, ref.log_prob), j_ctrl=j_ctrl, ctrl=ctrl,
                  params=params, split_scan=False)
    if kind == "reference":
        return dict(common, j_cls=JReferenceSDELoss, cls=ReferenceSDELoss,
                    j_kw=dict(sde=j_sde, reference_ctrl=lambda t, x: -0.2 * x),
                    kw=dict(sde=sde, reference_ctrl=lambda t, x: -0.2 * x))
    # the exponential integrator with an SDE, for the dropout's neutral control
    return dict(common, j_cls=JExpLoss, cls=ExponentialIntegratorSDELoss,
                j_kw=dict(sde=j_sde, alpha=0.9, sigma=1.1),
                kw=dict(sde=sde, alpha=0.9, sigma=1.1))


def ts_for(kind):
    if kind == "exponential":  # the DDS cosine grid
        return cosine_grid(T)
    return np.linspace(0.0, VP_KW["terminal_t"], T + 1).astype(np.float32)


CASES = [("time_reversal", True, "noise"), ("time_reversal", True, "dropout"),
         ("time_reversal", True, "both"), ("time_reversal", False, "both"),
         ("reference", True, "both"), ("reference", False, "both"),
         ("exponential", True, "both"), ("exponential", False, "both")]


@pytest.mark.parametrize("kind,two_phase,knobs", CASES,
                         ids=[f"{k}-{'two_phase' if t else 'scan'}-{n}" for k, t, n in CASES])
def test_exploring_loss_and_gradients_match_jax(kind, two_phase, knobs):
    """The lv loss with exploration noise, dropout or both: the two-phase
    loss (phase 1 through the scan route) and the scan loss (`simulate`),
    on JAX's noise and exploration draws."""
    c = setup(kind)
    knobs = KNOBS[knobs]
    key = jax.random.PRNGKey(11)
    j_loss = c["j_cls"](generative_ctrl=None, method="lv", max_rnd=1e8, noise_pregen=True,
                        scan_unroll=1, two_phase=two_phase, **knobs, **c["j_kw"])
    jts, jx0 = jnp.asarray(c["ts"]), jnp.asarray(c["x0"])
    dbs, step_keys = j_loss._pregen_scan_inputs(
        key, jts, jx0, scale_sqrt_dt=kind != "exponential")
    explore = jax_explore(step_keys, (B, D), knobs, two_phase or c["split_scan"])

    def j_loss_fn(p):
        bound = j_loss.with_ctrls(
            generative_ctrl=lambda t, x: c["j_ctrl"].apply({"params": p}, t, x))
        value, _ = bound(key, jts, jx0, *c["j_logps"])
        return value

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(c["params"])

    ctrl = c["ctrl"]
    loss = c["cls"](generative_ctrl=None, method="lv", max_rnd=1e8, two_phase=two_phase,
                    **knobs, **c["kw"]).with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x), ctrl_module=ctrl, ctrl_clips=None)
    build.reset_launches()
    value, metrics = loss(torch.from_numpy(c["ts"]), torch.from_numpy(c["x0"]), *c["logps"],
                          dbs=torch.from_numpy(np.array(dbs)), explore=explore)
    value.backward()
    # the two-phase loss's phase 1 took the scan route, once
    assert build.ROUTES["route.scan"] == int(two_phase)
    assert int(metrics["train/n_filtered"]) == 0
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    # the exponential integrator's gradients differ by up to 4e-5 of their
    # largest (tests/test_torch_port_dds.py holds them to 1e-4)
    tol = 1e-4 if kind == "exponential" else 1e-5
    for name, p in ctrl.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=tol * scale,
                                   rtol=0, err_msg=name)


def test_dropout_without_an_sde_is_refused_as_jax_fails():
    """DDS's exponential integrator has no SDE (conf/solver/dds.yaml): the
    dropout's neutral control −drift/diff does not exist. The JAX package
    fails on None.drift when it traces; the port refuses at construction.
    Exploration noise alone runs."""
    c = setup("exponential")
    j_loss = JExpLoss(generative_ctrl=lambda t, x: x, method="lv", alpha=0.9, sigma=1.1,
                      sde_ctrl_dropout=DROPOUT)
    with pytest.raises(AttributeError, match="drift"):
        j_loss(jax.random.PRNGKey(0), jnp.asarray(c["ts"]), jnp.asarray(c["x0"]), *c["j_logps"])
    with pytest.raises(ValueError, match="sde_ctrl_dropout"):
        ExponentialIntegratorSDELoss(generative_ctrl=None, method="lv", alpha=0.9, sigma=1.1,
                                     sde_ctrl_dropout=DROPOUT)
    assert ExponentialIntegratorSDELoss(generative_ctrl=None, method="lv", alpha=0.9,
                                        sigma=1.1, sde_ctrl_noise=NOISE).explores


def test_draw_explore_and_the_explored_control():
    """The draws' shapes and laws, and the explored control: plus
    noise·ξ, then the neutral control −drift/diff where υ > dropout (the
    JAX package's direction, as written)."""
    sde = VP(**VP_KW)
    loss = TimeReversalLoss(generative_ctrl=None, sde=sde, method="lv", **KNOBS["both"])
    ts = torch.linspace(0.0, 1.0, 5)
    x = torch.randn(4096, 3, generator=torch.Generator().manual_seed(0))
    xi, ups = loss.draw_explore(ts, x, torch.Generator().manual_seed(1))
    assert xi.shape == ups.shape == (4, 4096, 3)
    assert abs(float(xi.std()) - 1.0) < 0.02 and 0.0 <= float(ups.min())
    assert float(ups.max()) < 1.0 and abs(float((ups > DROPOUT).float().mean()) - 0.5) < 0.02
    u = torch.randn_like(x)
    s = ts[1]
    got = loss.explore_sde_ctrl(u, s, x, xi[1], ups[1])
    neutral = -sde.drift(s, x) / sde.diff(s, x)
    want = torch.where(ups[1] > DROPOUT, neutral, u + NOISE * xi[1])
    torch.testing.assert_close(got, want)
    # without the knobs nothing is drawn and the control is unchanged
    quiet = TimeReversalLoss(generative_ctrl=None, sde=sde, method="lv")
    assert quiet.draw_explore(ts, x) == (None, None) and not quiet.explores
    assert quiet.explore_sde_ctrl(u, s, x) is u


@pytest.mark.parametrize("kind", ["time_reversal", "exponential"])
def test_scan_route_gives_the_plain_twins_rollout(kind):
    """With sim_backend=xla phase 1 takes the scan route on a FourierMLP
    control that has a kernel instance: the same (xs, x_T) as the fused
    rollout's plain twin (kernel 1's EM update, kernel 2's exponential
    one), within the twins' rollout tolerance (tests/test_rollout_pallas.py:54)."""
    c = setup(kind)
    ctrl = c["ctrl"]
    clips = {"clip_model": 5.0, "clip_score": 5.0}
    loss = c["cls"](generative_ctrl=None, method="lv", sim_backend="xla", **c["kw"]).with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x, clips=clips), ctrl_module=ctrl,
        ctrl_clips=clips)
    rng = np.random.default_rng(4)
    ts, x0 = torch.from_numpy(c["ts"]), torch.from_numpy(c["x0"])
    noise = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32))
    if kind == "time_reversal":
        noise = noise * torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
        want = ro.rollout_plain(ctrl, x0, ts, noise, clips)
    else:
        want = ro.rollout_exp_plain(ctrl, x0, ts, noise, 0.9, 1.1, clips)
    build.reset_launches()
    got = loss._phase1(ts, x0, noise, (None, None))
    assert build.ROUTES["route.scan"] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=1e-5)


def _controls():
    """One control of each kernel form (`ro.FORMS`), on the funnel, with a
    GELU FourierMLP base net, and the SDE its EM update integrates."""
    sde = VP(**VP_KW)
    prior, target = IsotropicGauss(dim=D), Funnel(dim=D, n_reference_samples=100)
    score = dict(target_score=target.score, score_model=TimeEmbed(dim_out=1))
    net = lambda **kw: FourierMLP(dim=D, **kw)
    return {
        "lerp": (lambda base: LerpCtrl(base_model=base, sde=sde, prior_score=prior.score,
                                       **score), net(), None),
        "lerp_target": (lambda base: LerpTargetCtrl(base_model=base, sde=sde, **score),
                        net(), None),
        "score": (lambda base: ScoreCtrl(base_model=base, **score), net(), sde),
        "clipped": (lambda base: ClippedCtrl(base_model=base, sde=sde), net(), None),
        "potential": (lambda base: PotentialCtrl(base_model=base, sde=sde), net(dim_out=1),
                      None),
        "cancel_drift": (lambda base: CancelDriftCtrl(base_model=base, sde=sde, **score),
                         net(), None),
        "lerp_prior": (lambda base: LerpPriorCtrl(base_model=base, sde=sde,
                                                  prior_score=prior.score, **score), net(), None),
    }


def test_route_choice_for_every_form():
    """Every form of `ro.FORMS`: the kernel where an instance exists, the
    scan route only for a base net without a kernel body or for
    exploration (or when sim_backend=xla asks for it on a CPU tensor; on
    the card it sets no instance aside), a raise for any other refusal;
    sim_backend=pallas demands the kernel."""
    controls = _controls()
    assert set(controls) == set(ro.FORMS.values())
    route = ro.phase1_route
    for form, (make, fourier, sde) in controls.items():
        ctrl = make(fourier)
        assert ro.kernel_instance(ctrl, sde)[0] == form
        assert route(ctrl, sde) == ("kernel", None), form
        assert route(ctrl, sde, sim_backend="pallas") == ("kernel", None)
        assert route(ctrl, sde, sim_backend="xla") == ("scan", "sim_backend=xla")
        assert route(ctrl, sde, sim_backend="xla", on_card=True) == ("kernel", None)
        assert route(ctrl, sde, explore=True) == ("scan", "explore")
        with pytest.raises(NotImplementedError, match="exploration"):
            route(ctrl, sde, sim_backend="pallas", explore=True)
        # a ReLU DenseNet has a kernel body in every form but the potential one
        dense = make(DenseNet(dim=D, dim_out=1 if form == "potential" else None))
        if form != "potential":
            assert ro.kernel_instance(dense, sde)[0] == form
            assert route(dense, sde) == ("kernel", None)
            assert route(dense, sde, sim_backend="pallas") == ("kernel", None)
        # a base net without a kernel body: a ReLU FourierMLP, a MultilevelNet
        # and, under the PotentialCtrl, the DenseNet
        refused = [FourierMLP(dim=D, dim_out=1, activation="relu"),
                   MultilevelNet(dim=D, dim_out=1 if form == "potential" else None, factor=2,
                                 levels=2)]
        for base in refused + ([dense.base_model] if form == "potential" else []):
            other = make(base)
            missing = ro.kernel_instance(other, sde)
            assert isinstance(missing, ro.NoInstance) and missing.reason == "base_net"
            assert route(other, sde) == ("scan", "base_net")
            assert route(other, sde, explore=True) == ("scan", "explore")
            assert route(other, sde, sim_backend="xla", on_card=True) == ("scan", "base_net")
            with pytest.raises(NotImplementedError, match="GELU FourierMLP"):
                route(other, sde, sim_backend="pallas")
            with pytest.raises(NotImplementedError, match="GELU FourierMLP"):
                ro.fused_rollout(other, torch.zeros(2, D), torch.linspace(0, 1, 3),
                                 torch.zeros(2, 2, D), sde=sde)
        # any other refusal raises on every backend, exploring or not: here
        # the exponential integrator under a form other than ScoreCtrl's
        if form != "score":
            for backend in ("auto", "xla", "pallas"):
                for explore in (False, True):
                    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
                        route(ctrl, None, "exp", backend, explore)
    # a control type without a kernel form, a potential net of two outputs,
    # a non-OU SDE: raised whatever the base net or the exploration

    class Subclassed(LerpCtrl):
        pass

    sub = Subclassed(base_model=DenseNet(dim=D), sde=VP(**VP_KW),
                     prior_score=IsotropicGauss(dim=D).score,
                     target_score=Funnel(dim=D, n_reference_samples=100).score)
    wide_potential = controls["potential"][0](FourierMLP(dim=D, dim_out=2))
    score_ctrl = controls["score"][0](FourierMLP(dim=D))
    for ctrl, sde, match in ((sub, None, "LerpCtrl, a ScoreCtrl"),
                             (wide_potential, None, "one output"),
                             (score_ctrl, object(), "OU-family")):
        for backend in ("auto", "xla"):
            for explore in (False, True):
                with pytest.raises(NotImplementedError, match=match):
                    route(ctrl, sde, sim_backend=backend, explore=explore)


def test_exploring_dis_run_on_the_cpu(tmp_path):
    """`target=funnel solver=dis loss.sde_ctrl_noise=0.1
    loss.sde_ctrl_dropout=0.5` trains through the entry point: one scan
    route a phase 1, the route logged once, finite losses and log Z."""
    build.reset_launches()
    steps = 3
    solver = entry.main([
        "target=funnel", "solver=dis", "loss.sde_ctrl_noise=0.1", "loss.sde_ctrl_dropout=0.5",
        "device=cpu", "plot_results=False", f"train_steps={steps}", "train_batch_size=16",
        "train_timesteps.steps=8", "eval_batch_size=64", "eval_init=False",
        "target.n_reference_samples=1000", "~eval_sample_losses", f"out_dir={tmp_path}"])
    assert build.ROUTES["route.scan"] == steps
    assert sum(build.LAUNCHES.values()) == 0
    log = (tmp_path / "main.log").read_text()
    assert log.count("Phase 1 of TimeReversalLoss takes the scan route (explore)") == 1
    final = solver.last_metrics
    assert math.isfinite(final["eval/log_norm_const_is"])
    assert solver.loss.sde_ctrl_noise == 0.1 and solver.loss.sde_ctrl_dropout == 0.5
