"""Reference-SDE solvers (EulerDDS, PIS) of the port vs the JAX package.

Kernel 1's ScoreCtrl form (`fused_rollout` with the EM `sde`) runs its
plain twin on the CPU; it must match the JAX kernel `fused_sim_rollout`
with `sde_step_fn` in interpret mode and its lax.scan on the funnel
ScoreCtrl stack, for the VP SDE of EulerDDS and the scaled Brownian motion
of PIS, at atol 2e-5 + rtol 1e-5 (tests/test_rollout_pallas.py:54).
`ReferenceSDELoss` with and without a reference control is held against
the JAX loss on the JAX package's own Brownian increments
(`_pregen_scan_inputs(key, ts, x)`): values to 1e-5 relative, gradients to
1e-4 of each tensor's largest. The solvers' reference pieces (OU marginal,
Dirac prior, PIS's analytic control, EulerDDS's invariance check and
reference control) match the JAX solvers built from the same config.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.delta import Delta as JDelta
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.losses.oc import BaseOCLoss as JBaseOCLoss
from sde_sampler_tpu.losses.oc import ReferenceSDELoss as JReferenceSDELoss
from sde_sampler_tpu.ops.rollout_pallas import fused_sim_rollout, sde_step_fn
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.losses.oc import BaseOCLoss, ReferenceSDELoss
from sde_sampler_torch.ops.rollout import fused_rollout
from sde_sampler_torch.utils.params import flax_to_state_dict

from test_torch_port_dds import score_pair

REPO = Path(__file__).parents[1]
D, B, T = 10, 32, 12
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
BM_KW = dict(diff_coeff=0.4472135954999579, terminal_t=5.0)  # conf/sde/bm_pis.yaml


def sde_pair(name):
    if name == "vp":
        return JVP(**VP_KW), VP(**VP_KW)
    return JScaledBM(**BM_KW), ScaledBM(**BM_KW)


def em_inputs(sde, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, D)).astype(np.float32)
    ts = np.linspace(0.0, sde.terminal_t, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, batch, D)) * np.sqrt(np.diff(ts))[:, None, None]).astype(
        np.float32
    )
    return x0, ts, dbs


@pytest.mark.parametrize("sde_name", ["vp", "bm"])
def test_score_form_plain_rollout_matches_jax_kernel_and_scan(sde_name):
    j_sde, sde = sde_pair(sde_name)
    j_ctrl, ctrl, params, _, _ = score_pair(j_sde=j_sde, sde=sde)
    clips = {"clip_model": 0.3, "clip_score": 2.0}
    x0, ts, dbs = em_inputs(sde)

    def apply_ctrl(p, s, x):
        return j_ctrl.apply({"params": p}, s, x, clips=clips)

    step = sde_step_fn(apply_ctrl, drift=j_sde.drift, diff=j_sde.diff)
    jx0, jts, jdbs = map(jnp.asarray, (x0, ts, dbs))
    kernel = fused_sim_rollout(step, params, jx0, jts, jdbs, block_b=16, interpret=True)

    def body(x, inp):
        s, t, db = inp
        return step(params, s, t, x, db), x

    x_T, xs = jax.lax.scan(body, jx0, (jts[:-1], jts[1:], jdbs))
    got_xs, got_xT = fused_rollout(
        ctrl, torch.from_numpy(x0), torch.from_numpy(ts), torch.from_numpy(dbs), clips,
        sde=sde,
    )
    assert torch.equal(got_xs[0], torch.from_numpy(x0))
    for want_xs, want_xT in (kernel, (xs, x_T)):
        np.testing.assert_allclose(got_xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got_xT.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def loss_setup(method, with_reference, seed=0, batch=64):
    # a VP with beta up to 2, not 10: at 12 steps and the untrained control,
    # beta 10 lets a fifth of the trajectories diverge (rnd >= max_rnd)
    kw = dict(VP_KW, diff_coeff_sq_max=2.0)
    j_sde, sde = JVP(**kw), VP(**kw)
    j_ctrl, ctrl, params, j_target, target = score_pair(j_sde=j_sde, sde=sde)
    j_prior, prior = JIsoGauss(dim=D), IsotropicGauss(dim=D)
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, D)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    # EulerDDS's reference control, sigma(t) * prior score
    j_ref = (lambda t, x: j_sde.diff(t, x) * j_prior.score(x)) if with_reference else None
    ref = (lambda t, x: sde.diff(t, x) * prior.score(x)) if with_reference else None
    kw = dict(method=method, max_rnd=1e8)
    j_loss = JReferenceSDELoss(generative_ctrl=None, sde=j_sde, reference_ctrl=j_ref,
                               noise_pregen=True, scan_unroll=1, **kw)
    dbs, _ = j_loss._pregen_scan_inputs(key, jnp.asarray(ts), jnp.asarray(x0))
    loss = ReferenceSDELoss(generative_ctrl=None, sde=sde, reference_ctrl=ref, **kw)
    return dict(j_ctrl=j_ctrl, ctrl=ctrl, params=params, j_target=j_target, target=target,
                j_prior=j_prior, prior=prior, x0=x0, ts=ts, key=key, j_loss=j_loss,
                loss=loss, dbs=np.array(dbs))


@pytest.mark.parametrize(
    "method,with_reference", [("lv", False), ("lv", True), ("kl", True), ("kl_ito", False)]
)
def test_reference_loss_and_gradients_match_jax(method, with_reference):
    """lv: the two-phase loss (phase 1 through kernel 1's ScoreCtrl twin);
    kl / kl_ito: the autograd `simulate`."""
    c = loss_setup(method, with_reference)

    def j_loss_fn(p):
        bound = c["j_loss"].with_ctrls(
            generative_ctrl=lambda t, x: c["j_ctrl"].apply({"params": p}, t, x)
        )
        value, _ = bound(c["key"], jnp.asarray(c["ts"]), jnp.asarray(c["x0"]),
                         c["j_target"].unnorm_log_prob, c["j_prior"].log_prob)
        return value

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(c["params"])
    ctrl = c["ctrl"]
    loss = c["loss"].with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x), ctrl_module=ctrl, ctrl_clips=None
    )
    assert loss.two_phase == (method == "lv")
    value, metrics = loss(torch.from_numpy(c["ts"]), torch.from_numpy(c["x0"]),
                          c["target"].unnorm_log_prob, c["prior"].log_prob,
                          dbs=torch.from_numpy(c["dbs"]))
    value.backward()
    assert int(metrics["train/n_filtered"]) == 0
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in ctrl.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(
            p.grad.numpy(), want[name].numpy(), atol=1e-4 * scale, rtol=0, err_msg=name
        )


def test_one_diverged_trajectory_poisons_the_reference_gradient_on_both_sides():
    """The hazard of tests/test_torch_port_loss.py on EulerDDS's loss: a
    trajectory whose funnel score overflows (x_0 = -200) is filtered out of
    the loss value, but every parameter gradient comes out non-finite, in
    the port and in the JAX package alike; the values agree to 1e-5."""
    c = loss_setup("lv", True)
    x0 = c["x0"].copy()
    x0[0, 0] = -200.0

    def j_loss_fn(p):
        bound = c["j_loss"].with_ctrls(
            generative_ctrl=lambda t, x: c["j_ctrl"].apply({"params": p}, t, x)
        )
        return bound(c["key"], jnp.asarray(c["ts"]), jnp.asarray(x0),
                     c["j_target"].unnorm_log_prob, c["j_prior"].log_prob)

    (j_value, j_metrics), j_grads = jax.jit(
        jax.value_and_grad(j_loss_fn, has_aux=True))(c["params"])
    ctrl = c["ctrl"]
    loss = c["loss"].with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x), ctrl_module=ctrl, ctrl_clips=None
    )
    value, metrics = loss(torch.from_numpy(c["ts"]), torch.from_numpy(x0),
                          c["target"].unnorm_log_prob, c["prior"].log_prob,
                          dbs=torch.from_numpy(c["dbs"]))
    value.backward()
    assert int(metrics["train/n_filtered"]) == int(j_metrics["train/n_filtered"]) == 1
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree_util.tree_leaves(j_grads))
    assert not all(bool(torch.isfinite(p.grad).all()) for p in ctrl.parameters())


def test_reference_eval_estimators_match_jax():
    c = loss_setup("lv", True, seed=1)
    bound = c["j_loss"].with_ctrls(
        generative_ctrl=lambda t, x: c["j_ctrl"].apply({"params": c["params"]}, t, x)
    )
    j_res = bound.eval(c["key"], jnp.asarray(c["ts"]), jnp.asarray(c["x0"]),
                       c["j_target"].unnorm_log_prob, c["j_prior"].log_prob,
                       return_traj=True)
    ctrl = c["ctrl"]
    loss = c["loss"].with_ctrls(generative_ctrl=lambda t, x: ctrl(t, x))
    with torch.no_grad():
        res = loss.eval(torch.from_numpy(c["ts"]), torch.from_numpy(c["x0"]),
                        c["target"].unnorm_log_prob, c["prior"].log_prob,
                        return_traj=True, dbs=torch.from_numpy(c["dbs"]))
    for got, want in ((res.samples, j_res.samples), (res.xs, j_res.xs),
                      (res.rnd, j_res.rnd), (res.rnd_no_ito, j_res.rnd_no_ito)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    stats = BaseOCLoss.compute_results_arrays(res.rnd, res.rnd_no_ito, max_rnd=1e8)
    j_stats = JBaseOCLoss.compute_results_arrays(j_res.rnd, j_res.rnd_no_ito, max_rnd=1e8)
    for name in ("log_norm_const_is", "log_norm_const_lb", "log_norm_const_lb_ito"):
        assert float(stats[name]) == pytest.approx(float(j_stats[name]), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("sde_name", ["vp", "bm"])
def test_marginal_distr_and_delta_match_jax(sde_name):
    j_sde, sde = sde_pair(sde_name)
    j_delta, delta = JDelta(dim=D), Delta(dim=D)
    x = np.random.default_rng(2).normal(size=(16, D)).astype(np.float32)
    var_init = 0.7 if sde_name == "vp" else None
    j_m = j_sde.marginal_distr(j_sde.terminal_t, x_init=j_delta.loc,
                               var_init=None if var_init is None else var_init * jnp.ones_like(j_delta.loc))
    m = sde.marginal_distr(sde.terminal_t, x_init=delta.loc,
                           var_init=None if var_init is None else var_init * torch.ones_like(delta.loc))
    for got, want in ((m.loc, j_m.loc), (m.scale, j_m.scale),
                      (m.log_prob(torch.from_numpy(x)), j_m.log_prob(jnp.asarray(x))),
                      (delta.log_prob(torch.from_numpy(x * 1e-3)), j_delta.log_prob(jnp.asarray(x * 1e-3)))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        delta.sample((5,)).numpy(), np.asarray(j_delta.sample(jax.random.PRNGKey(0), (5,))))
    assert delta.sample().shape == (D,)


TINY = [
    "target=funnel", "train_batch_size=16", "train_timesteps.steps=8",
    "plot_results=False", "eval_init=False", "store_last_ckpt=False",
    "target.n_reference_samples=1000", "n_devices=1", "train_steps=10",
]


def both_solvers(solver, tmp_path, extra=()):
    from sde_sampler_tpu.utils.config import compose, locate

    args = TINY + [f"solver={solver}", *extra]
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    return js, ps


def test_pis_and_euler_dds_solver_pieces_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, D)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    js, ps = both_solvers("pis", tmp_path / "pis")
    assert type(ps.prior).__name__ == "Delta"
    np.testing.assert_allclose(ps.reference_distr.log_prob(tx).numpy(),
                               np.asarray(js.reference_distr.log_prob(jx)), rtol=1e-5, atol=1e-5)
    for t in (0.0, 1.3, 5.0):
        np.testing.assert_allclose(
            ps.analytic_inference_ctrl(torch.tensor(t), tx).numpy(),
            np.asarray(js.analytic_inference_ctrl(jnp.float32(t), jx)), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            ps.inference_sde.drift(torch.tensor(t), tx).numpy(),
            np.asarray(js.inference_sde.drift(jnp.float32(t), jx)), rtol=1e-5, atol=1e-5)

    js, ps = both_solvers("dds_euler", tmp_path / "euler")
    np.testing.assert_allclose(ps.reference_distr.scale.numpy(),
                               np.asarray(js.reference_distr.scale), rtol=1e-6)
    for t in (0.0, 0.4):
        np.testing.assert_allclose(
            ps.reference_ctrl(torch.tensor(t), tx).numpy(),
            np.asarray(js.reference_ctrl(jnp.float32(t), jx)), rtol=1e-5, atol=1e-5)
    # the prior must be the SDE's invariant law
    with pytest.raises(ValueError, match="invariant"):
        entry.make_solver(TINY + ["solver=dds_euler", "prior.scale=2.0", "device=cpu",
                                  f"out_dir={tmp_path / 'bad'}"])
