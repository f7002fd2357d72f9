"""The Bridge with a learned inference control in the port vs the JAX package.

`solver=bridge_diff_init` (a LerpCtrl on VP, a ClippedCtrl inference
control) and `solver=bridge` (a LerpTargetCtrl on the scaled BM, a
LerpPriorCtrl inference control whose divergence reaches the prior score),
piece by piece, on the same numpy-seeded inputs and the JAX parameters
carried across (`utils/params.py`):

- the divergence estimators `divx_exact` (its batched branch at d = 2 and
  5, its sequential one at d = 66) and `divx_hutchinson` on the JAX probes:
  the value and the parameter gradient of the summed divergence, which is
  reverse mode over forward mode, to rtol 1e-5 / atol 1e-5; the value also
  under `torch.no_grad` (the evaluation's rollout);
- LerpPriorCtrl and LerpTargetCtrl, with and without the hard constraint;
- TimeReversalLoss with an inference control on the JAX noise: the
  two-phase lv loss (exact and Hutchinson) and the kl loss with the
  gradients of both controls (loss to 1e-5 relative, gradients to 1e-4 of
  each tensor's largest, as tests/test_torch_port_loss.py), and the
  evaluation's three log Z estimators (rtol 1e-5, atol 1e-4 on the
  per-sample RNDs);
- the plain twin of kernel 1's lerp_target form against the JAX kernel
  `fused_sim_rollout` in interpret mode and its scan (atol 2e-5 + rtol 1e-5,
  as tests/test_torch_port_rollout.py);
- three optimizer steps of each solver on the grid mixture, with both
  controls' parameters to 5e-5 (tests/test_torch_port_solver.py), save the
  Adam rule of tests/test_torch_port_targets.py for elements whose
  gradient lay near its rounding level (one score-net weight of the
  generative control moved 5.2e-5 from JAX's under bridge_diff_init), and
  the inference control's 50 times smaller learning rate visible in the
  steps. Losses and max gradients agree to 1e-4 relative: this 16-sample
  LV loss of the mixture is ill-conditioned in float32 (at the first step,
  with the same parameters, JAX's value lies 1.0e-5 relative from the
  float64 one and the port's 3e-6), and the later steps add the parameter
  differences;
- CPU runs of the entry point that write finite metrics and resume both
  controls from their checkpoint.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.losses.oc import BaseOCLoss as JBaseOCLoss
from sde_sampler_tpu.losses.oc import TimeReversalLoss as JTimeReversalLoss
from sde_sampler_tpu.losses.oc import divx_exact as j_divx_exact
from sde_sampler_tpu.losses.oc import divx_hutchinson as j_divx_hutchinson
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import ClippedCtrl as JClippedCtrl
from sde_sampler_tpu.models.reparam import LerpCtrl as JLerpCtrl
from sde_sampler_tpu.models.reparam import LerpPriorCtrl as JLerpPriorCtrl
from sde_sampler_tpu.models.reparam import LerpTargetCtrl as JLerpTargetCtrl
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.gauss import GMM, IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.losses.oc import (
    BaseOCLoss,
    TimeReversalLoss,
    divx_exact,
    divx_hutchinson,
)
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import (
    ClippedCtrl,
    LerpCtrl,
    LerpPriorCtrl,
    LerpTargetCtrl,
)
from sde_sampler_torch.ops.rollout import fused_rollout
from sde_sampler_torch.utils.params import (
    flax_to_state_dict,
    load_flax_params,
    load_solver_params,
)

from test_torch_port_rollout import jax_rollouts

REPO = Path(__file__).parents[1]
WIDTH = 32
NETS = dict(num_layers=4, channels=WIDTH)
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
BM_KW = dict(diff_coeff=1.0, terminal_t=1.0)  # conf/sde/bm.yaml
B, T = 32, 12


def t_(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def perturbed_init(j_module, d, seed=0):
    """JAX init with every parameter perturbed (the configs zero the last
    layers, which would hide them from the comparisons)."""
    params = j_module.init(jax.random.PRNGKey(seed), jnp.zeros(()), jnp.zeros((2, d)))["params"]
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), a.shape), params
    )


def assert_grads_match(module, j_grads, scale_tol=1e-4, atol=None, rtol=0.0):
    """Port gradients against the JAX tree: atol `scale_tol` times each
    tensor's largest JAX gradient, or a fixed atol and rtol."""
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in module.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        tol = atol if atol is not None else scale_tol * (float(want[name].abs().max()) + 1e-12)
        np.testing.assert_allclose(got, want[name].numpy(), atol=tol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# divergence estimators
# ---------------------------------------------------------------------------


def jax_probes(key, shape, noise_type, n_samples):
    """The probes `divx_hutchinson` draws in the JAX package."""
    out = []
    for i in range(n_samples):
        sub = jax.random.fold_in(key, i)
        if noise_type == "rademacher":
            out.append(jax.random.randint(sub, shape, 0, 2).astype(jnp.float32) * 2 - 1.0)
        else:
            out.append(jax.random.normal(sub, shape, dtype=jnp.float32))
    return np.stack([np.asarray(p) for p in out])


@pytest.mark.parametrize("d,estimator", [
    (2, "exact"), (5, "exact"), (66, "exact"),
    (2, "rademacher"), (5, "rademacher"), (2, "gauss"), (5, "gauss"),
])
def test_divergence_estimators_match_jax(d, estimator):
    j_net, net = JFourierMLP(dim=d, **NETS), FourierMLP(dim=d, **NETS)
    params = perturbed_init(j_net, d)
    load_flax_params(net, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(d)
    x = rng.normal(size=(16, d)).astype(np.float32)
    t = np.float32(0.37)
    key = jax.random.PRNGKey(3)
    n_samples = 2
    probes = jax_probes(key, x.shape, estimator, n_samples) if estimator != "exact" else None

    def j_div(p):
        fn = lambda tt, xx: j_net.apply({"params": p}, tt, xx)
        if estimator == "exact":
            return j_divx_exact(fn, jnp.float32(t), jnp.asarray(x))
        return j_divx_hutchinson(fn, jnp.float32(t), jnp.asarray(x), key,
                                 noise_type=estimator, n_samples=n_samples)

    j_div_v, j_value = jax.jit(j_div)(params)
    j_grads = jax.jit(jax.grad(lambda p: j_div(p)[0].sum()))(params)

    fn = lambda tt, xx: net(tt, xx)
    def div_of(xx):
        if estimator == "exact":
            return divx_exact(fn, torch.tensor(t), xx)
        return divx_hutchinson(fn, torch.tensor(t), xx, noise=t_(probes), noise_type=estimator)

    div, value = div_of(t_(x))
    assert div.shape == (16, 1) and value.shape == (16, d)
    np.testing.assert_allclose(div.detach().numpy(), np.asarray(j_div_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(j_value), rtol=1e-5, atol=1e-5)
    div.sum().backward()
    assert_grads_match(net, j_grads, atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # forward mode still runs where autograd does not
        div_ng, _ = div_of(t_(x))
    torch.testing.assert_close(div_ng, div.detach(), rtol=1e-6, atol=1e-6)


def test_hutchinson_probes_from_a_generator_are_unbiased():
    """Probes drawn from a torch generator: Rademacher signs, and an
    estimate that averages to the exact divergence of a linear map."""
    A = torch.tensor([[1.5, 0.3, 0.0], [0.2, -0.7, 0.4], [0.0, 0.1, 2.2]])
    fn = lambda t, x: x @ A.T
    x = torch.randn(4000, 3, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    div, value = divx_hutchinson(fn, 0.0, x, generator=g, noise_type="rademacher")
    assert float(div.mean()) == pytest.approx(float(A.trace()), abs=0.05)
    torch.testing.assert_close(value, fn(0.0, x))
    exact, _ = divx_exact(fn, 0.0, x)
    torch.testing.assert_close(exact, torch.full((4000, 1), float(A.trace())))
    with pytest.raises(NotImplementedError, match="Undefined noise type"):
        divx_hutchinson(fn, 0.0, x, generator=g, noise_type="uniform")


# ---------------------------------------------------------------------------
# the one-sided lerp controls
# ---------------------------------------------------------------------------


def bridge_stack(kind, d=2, hard_constrain=False, target="grid"):
    """(JAX (gen, inf), port (gen, inf), params {generative_ctrl,
    inference_ctrl}, JAX (prior, target), port (prior, target)) of a Bridge:
    `diff_init` (conf/solver/bridge_diff_init.yaml) or `bridge`
    (conf/solver/bridge.yaml), at width 32."""
    if target == "grid":
        j_target, p_target = JGMM(name="grid"), GMM(name="grid")
    else:  # a three-component mixture at d = 5
        rng = np.random.default_rng(11)
        kw = dict(dim=d, loc=rng.normal(size=(3, d)) * 2, scale=0.5 + rng.random((3, d)),
                  mixture_weights=np.array([0.2, 0.3, 0.5]), domain_tol=None)
        j_target, p_target = JGMM(**kw), GMM(**kw)
    j_prior, prior = JIsoGauss(dim=d), IsotropicGauss(dim=d)
    score = lambda cls: cls(dim_out=1, **NETS, last_bias_init={"constant": 1.0})
    common = dict(clip_model=10.0, clip_score=10.0, hard_constrain=hard_constrain,
                  detach_score=False)
    if kind == "diff_init":
        j_sde, sde = JVP(**VP_KW), VP(**VP_KW)
        j_gen = JLerpCtrl(base_model=JFourierMLP(dim=d, **NETS), score_model=score(JTimeEmbed),
                          sde=j_sde, prior_score=j_prior.score, target_score=j_target.score,
                          **common)
        gen = LerpCtrl(base_model=FourierMLP(dim=d, **NETS), score_model=score(TimeEmbed),
                       sde=sde, prior_score=prior.score, target_score=p_target.score, **common)
        j_inf = JClippedCtrl(base_model=JFourierMLP(dim=d, **NETS), clip_model=10.0, sde=j_sde)
        inf = ClippedCtrl(base_model=FourierMLP(dim=d, **NETS), clip_model=10.0, sde=sde)
    else:
        j_sde, sde = JScaledBM(**BM_KW), ScaledBM(**BM_KW)
        pair = {}
        for name, (j_cls, cls) in (("gen", (JLerpTargetCtrl, LerpTargetCtrl)),
                                   ("inf", (JLerpPriorCtrl, LerpPriorCtrl))):
            pair[name] = (
                j_cls(base_model=JFourierMLP(dim=d, **NETS), score_model=score(JTimeEmbed),
                      sde=j_sde, prior_score=j_prior.score, target_score=j_target.score,
                      **common),
                cls(base_model=FourierMLP(dim=d, **NETS), score_model=score(TimeEmbed),
                    sde=sde, prior_score=prior.score, target_score=p_target.score, **common),
            )
        (j_gen, gen), (j_inf, inf) = pair["gen"], pair["inf"]
    params = {"generative_ctrl": perturbed_init(j_gen, d, 0),
              "inference_ctrl": perturbed_init(j_inf, d, 2)}
    load_solver_params({"generative_ctrl": gen, "inference_ctrl": inf},
                       jax.tree_util.tree_map(np.asarray, params))
    return (j_gen, j_inf), (gen, inf), params, (j_prior, j_target), (prior, p_target)


@pytest.mark.parametrize("hard_constrain", [False, True])
@pytest.mark.parametrize("which", ["LerpTargetCtrl", "LerpPriorCtrl"])
def test_one_sided_lerp_controls_match_jax(which, hard_constrain):
    """Forward at several times and clips, and the control's exact
    divergence, which reaches the target or prior score (detach_score
    False)."""
    (j_gen, j_inf), (gen, inf), params, _, _ = bridge_stack("bridge", hard_constrain=hard_constrain)
    j_ctrl, ctrl, p = ((j_gen, gen, params["generative_ctrl"]) if which == "LerpTargetCtrl"
                       else (j_inf, inf, params["inference_ctrl"]))
    assert type(ctrl).__name__ == which
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(24, 2)) * 3.0).astype(np.float32)
    for t, clips in ((0.0, None), (0.3, None), (0.81, {"clip_model": 0.5, "clip_score": 2.0}),
                     (1.0, None)):
        want = j_ctrl.apply({"params": p}, jnp.float32(t), jnp.asarray(x), clips=clips)
        with torch.no_grad():
            got = ctrl(torch.tensor(t), t_(x), clips=clips)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    fn = lambda tt, xx: j_ctrl.apply({"params": p}, tt, xx)
    j_div, _ = j_divx_exact(fn, jnp.float32(0.4), jnp.asarray(x))
    with torch.no_grad():
        div, _ = divx_exact(lambda tt, xx: ctrl(tt, xx), torch.tensor(0.4), t_(x))
    np.testing.assert_allclose(div.numpy(), np.asarray(j_div), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def loss_setup(kind, method, estimator=None, seed=0):
    (j_gen, j_inf), (gen, inf), params, (j_prior, j_target), (prior, target) = bridge_stack(kind)
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, 2)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    j_loss = JTimeReversalLoss(
        generative_ctrl=None, sde=j_gen.sde, method=method, max_rnd=1e8,
        div_estimator=estimator, noise_pregen=True, scan_unroll=1,
    )
    dbs, step_keys = j_loss._pregen_scan_inputs(key, jnp.asarray(ts), jnp.asarray(x0))
    probes = None
    if estimator is not None:  # the per-step probes of the JAX two-phase loss
        probes = np.stack([
            jax_probes(jax.random.split(k)[1], x0.shape, estimator, 1)[0] for k in step_keys
        ])
    loss = TimeReversalLoss(generative_ctrl=None, sde=gen.sde, method=method, max_rnd=1e8,
                            div_estimator=estimator)
    return dict(j_gen=j_gen, j_inf=j_inf, gen=gen, inf=inf, params=params, j_prior=j_prior,
                j_target=j_target, prior=prior, target=target, x0=x0, ts=ts, key=key,
                j_loss=j_loss, loss=loss, dbs=np.array(dbs), probes=probes)


def bound_losses(c, p=None):
    """The JAX loss with the controls of `p` bound, and the port's."""
    p = c["params"] if p is None else p
    j_bound = c["j_loss"].with_ctrls(
        generative_ctrl=lambda t, x: c["j_gen"].apply({"params": p["generative_ctrl"]}, t, x),
        inference_ctrl=lambda t, x: c["j_inf"].apply({"params": p["inference_ctrl"]}, t, x),
    )
    gen, inf = c["gen"], c["inf"]
    bound = c["loss"].with_ctrls(
        generative_ctrl=lambda t, x: gen(t, x), ctrl_module=gen, ctrl_clips=None,
        inference_ctrl=lambda t, x: inf(t, x),
    )
    return j_bound, bound


@pytest.mark.parametrize("kind,method,estimator", [
    ("diff_init", "lv", None), ("bridge", "lv", None), ("diff_init", "lv", "rademacher"),
    ("diff_init", "kl", None), ("bridge", "kl", None),
])
def test_train_loss_and_both_gradients_match_jax(kind, method, estimator):
    """lv: the two-phase loss (phase 1 on the generative control alone,
    through the fused rollout's plain twin; phase 2 with the inference
    control and its divergence on all states at once); kl: the autograd
    rollout with the divergence at every step."""
    c = loss_setup(kind, method, estimator)

    def j_loss_fn(p):
        j_bound, _ = bound_losses(c, p)
        value, _ = j_bound(c["key"], jnp.asarray(c["ts"]), jnp.asarray(c["x0"]),
                           c["j_target"].unnorm_log_prob, c["j_prior"].log_prob)
        return value

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(c["params"])
    _, loss = bound_losses(c)
    assert loss.two_phase == (method == "lv")
    value, metrics = loss(t_(c["ts"]), t_(c["x0"]), c["target"].unnorm_log_prob,
                          c["prior"].log_prob, dbs=t_(c["dbs"]),
                          probes=None if c["probes"] is None else t_(c["probes"]))
    value.backward()
    assert int(metrics["train/n_filtered"]) == 0
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    assert_grads_match(c["gen"], j_grads["generative_ctrl"])
    assert_grads_match(c["inf"], j_grads["inference_ctrl"])
    # the inference control is trained: its gradient is not zero
    assert max(float(p.grad.abs().max()) for p in c["inf"].parameters()
               if p.grad is not None) > 0


@pytest.mark.parametrize("kind", ["diff_init", "bridge"])
def test_eval_estimators_with_an_inference_control_match_jax(kind):
    c = loss_setup(kind, "lv", seed=1)
    j_bound, bound = bound_losses(c)
    j_res = j_bound.eval(c["key"], jnp.asarray(c["ts"]), jnp.asarray(c["x0"]),
                         c["j_target"].unnorm_log_prob, c["j_prior"].log_prob,
                         return_traj=True)
    with torch.no_grad():
        res = bound.eval(t_(c["ts"]), t_(c["x0"]), c["target"].unnorm_log_prob,
                         c["prior"].log_prob, return_traj=True, dbs=t_(c["dbs"]))
    for got, want in ((res.samples, j_res.samples), (res.xs, j_res.xs),
                      (res.rnd, j_res.rnd), (res.rnd_no_ito, j_res.rnd_no_ito)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    stats = BaseOCLoss.compute_results_arrays(res.rnd, res.rnd_no_ito, max_rnd=1e8)
    j_stats = JBaseOCLoss.compute_results_arrays(j_res.rnd, j_res.rnd_no_ito, max_rnd=1e8)
    for name in ("log_norm_const_is", "log_norm_const_lb", "log_norm_const_lb_ito"):
        assert float(stats[name]) == pytest.approx(float(j_stats[name]), rel=1e-5, abs=1e-4)


# ---------------------------------------------------------------------------
# kernel 1's lerp_target form: the plain twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,hard_constrain,clips", [
    pytest.param(2, False, None, id="gmm"),
    pytest.param(2, True, {"clip_model": 0.3, "clip_score": 2.0}, id="gmm.hard.clips"),
    pytest.param(5, False, {"clip_model": 5.0, "clip_score": 10.0}, id="gmm.d5"),
])
def test_lerp_target_plain_rollout_matches_jax_kernel_and_scan(d, hard_constrain, clips):
    """The LerpTargetCtrl on the scaled BM (conf/sde/bm.yaml): the plain
    twin against the JAX Pallas kernel (interpret mode) and its scan on the
    same inputs, on the last T steps of the configs' 200-step grid."""
    (j_gen, _), (gen, _), params, _, _ = bridge_stack(
        "bridge", d=d, hard_constrain=hard_constrain, target="grid" if d == 2 else "d5")
    rng = np.random.default_rng(1)
    x0 = (rng.normal(size=(B, d)) * 3.0).astype(np.float32)
    ts = np.linspace(1 - T / 200, 1.0, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, B, d)) * np.sqrt(np.diff(ts))[:, None, None]).astype(np.float32)
    wants = jax_rollouts(j_gen, params["generative_ctrl"], x0, ts, dbs, clips)
    xs, x_T = fused_rollout(gen, t_(x0), t_(ts), t_(dbs), clips)
    assert torch.equal(xs[0], t_(x0)) and bool(torch.isfinite(xs).all())
    for want_xs, want_xT in wants:
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(x_T.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

S_B, S_STEPS = 16, 6


def tiny(solver):
    return [
        "target=gmm", f"solver={solver}", f"train_batch_size={S_B}",
        f"train_timesteps.steps={S_STEPS}", "plot_results=False", "eval_init=False",
        "store_last_ckpt=False", "n_devices=1", "target.n_reference_samples=1000",
        "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
    ]


@pytest.mark.parametrize("solver", ["bridge_diff_init", "bridge"])
def test_three_bridge_optimizer_steps_match_jax(tmp_path, solver):
    from sde_sampler_tpu.utils.config import compose, locate

    args = tiny(solver) + ["train_steps=10"]
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    want_types = (("LerpCtrl", "ClippedCtrl") if solver == "bridge_diff_init"
                  else ("LerpTargetCtrl", "LerpPriorCtrl"))
    assert (type(ps.generative_ctrl).__name__, type(ps.inference_ctrl).__name__) == want_types
    # the group learning rates of the config: the inference control's is 0.02 x
    lrs = {name: g["base_lr"] for name, g in zip(ps.modules, ps.optimizer.param_groups)}
    assert lrs == pytest.approx({"generative_ctrl": 5e-3, "inference_ctrl": 1e-4})
    assert set(ps.scheduled_params) >= {"inference_ctrl.clip_model"}
    load_solver_params(ps.modules, jax.tree_util.tree_map(np.asarray, js.train_state.params))
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)
    start = {k: v.clone() for k, v in ps.modules.state_dict().items()}
    params = dict(ps.modules.named_parameters())
    low = {name: np.zeros(p.shape, dtype=bool) for name, p in params.items()}

    for _ in range(3):
        _, k_loss = jax.random.split(js.train_state.key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (S_B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        j_metrics = js.step()
        metrics = ps.step(x0=torch.from_numpy(np.array(x0)), dbs=torch.from_numpy(np.array(dbs)))
        assert float(metrics["train/loss"]) == pytest.approx(
            float(j_metrics["train/loss"]), rel=1e-4)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=1e-4)
        for name, p in params.items():
            grad = p.grad.abs().numpy()
            low[name] |= (grad > 0) & (grad < 1e-2 * grad.max())

    moved, n_off, n_all = {}, 0, 0
    for name in ("generative_ctrl", "inference_ctrl"):
        want = flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, js.train_state.params[name]))
        lr = ps.optimizer.param_groups[list(ps.modules).index(name)]["base_lr"]
        for key, value in ps.modules[name].state_dict().items():
            err = np.abs(value.numpy() - want[key].numpy())
            assert err[~low[f"{name}.{key}"]].max(initial=0.0) <= 5e-5, f"{name}.{key}"
            assert err.max() <= 2 * 2 * lr, f"{name}.{key}"
            n_off += int((err > 5e-5).sum())
            n_all += err.size
            moved[name] = max(moved.get(name, 0.0),
                              float((value - start[f"{name}.{key}"]).abs().max()))
    assert n_off < 1e-3 * n_all
    # Adam moves each element by at most about its lr a step
    assert moved["inference_ctrl"] <= 3 * 1e-4 * 1.01
    assert moved["generative_ctrl"] > 10 * moved["inference_ctrl"]
    assert ps.n_steps == 3 and ps.n_updates == 3 and ps.n_steps_skip == 0


def test_weight_carry_needs_the_same_controls():
    gen = ClippedCtrl(base_model=FourierMLP(dim=2, **NETS))
    with pytest.raises(ValueError, match="controls"):
        load_solver_params({"generative_ctrl": gen}, {"generative_ctrl": {}, "inference_ctrl": {}})


@pytest.mark.parametrize("solver", ["bridge_diff_init", "bridge"])
def test_entry_point_cpu_bridge_run_writes_finite_metrics_and_resumes(tmp_path, solver):
    out = tmp_path / "run"
    args = tiny(solver) + ["train_steps=3", "eval_batch_size=64", "device=cpu",
                           "store_last_ckpt=True", f"out_dir={out}"]
    args.remove("store_last_ckpt=False")
    solver_obj = entry.main(args)
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size",
                "error/sinkhorn"):
        assert math.isfinite(final[key]), key
    assert any(math.isfinite(l.get("train/loss", math.nan)) for l in lines)
    # the EMA shadows and the checkpoint hold both controls
    n_params = sum(1 for _ in solver_obj.generative_ctrl.parameters()) + sum(
        1 for _ in solver_obj.inference_ctrl.parameters())
    assert len(solver_obj.ema_params) == len(solver_obj.params) == n_params
    resumed = entry.make_solver(args)
    resumed.setup()
    assert resumed.n_steps == 3
    for a, b in zip(resumed.inference_ctrl.parameters(), solver_obj.inference_ctrl.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.ema_params, solver_obj.ema_params):
        assert torch.equal(a, b)
