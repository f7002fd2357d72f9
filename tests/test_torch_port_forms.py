"""Kernel 1's control forms for the configurations that compose a solver
with another model (`model@generative_ctrl=...`), against the JAX package.

On the CPU phase 1 runs kernel 1's plain twin, which must match the JAX
kernel `fused_sim_rollout` in interpret mode and its lax.scan at B 32, T 12,
with the parameters carried across (`utils/params.py`) and the same numpy
noise, within atol 2e-5 + rtol 1e-5 (the tolerance of
tests/test_torch_port_rollout.py):

- the LerpPriorCtrl form (`model=lerp_prior`), with and without the hard
  constraint and with a score net of d outputs;
- the LerpCtrl over PIS's Delta prior (a diagonal Gauss of scale 1e-3) on
  its scaled Brownian motion, from the Dirac's point;
- the ScoreCtrl under the time-reversal loss (`solver=dis model=score`),
  phase 1 through the loss, which integrates its own VP;
- the LerpTargetCtrl and the CancelDriftCtrl with score nets of d outputs
  (`solver=bridge model=lerp_dim`, `model=langevin_init` with
  `time_embed_dim`);
- the LerpTargetCtrl over a base net of one output (`solver=bridge
  model=potential`), broadcast over the coordinates.

Then the LV loss of `solver=dis model=lerp_prior` and its gradients against
the JAX loss, and the grid of solvers and models that the port's config
engine composes on the mixture: phase 1 has a route for every pair but the
seven DDS pairs, which fail in the JAX package too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.delta import Delta as JDelta
from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.losses.oc import TimeReversalLoss as JTimeReversalLoss
from sde_sampler_tpu.models import reparam as jreparam
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.gauss import GMM, Gauss, IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.losses.oc import TimeReversalLoss
from sde_sampler_torch.models import reparam
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

from test_torch_port_rollout import jax_rollouts

B, T = 32, 12
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)  # vp_10
PIS_BM = dict(diff_coeff=0.4472135954999579, terminal_t=5.0)  # bm_pis
BRIDGE_BM = dict(diff_coeff=1.0, terminal_t=1.0)  # bm
CLIPS = {"clip_model": 5.0, "clip_score": 10.0}

# case -> (control class, SDE (class name, kwargs), prior, score net outputs
# (0: none, 1, or "d"), extra control kwargs, base net outputs (None: d),
# whether phase 1 runs through the time-reversal loss)
CASES = {
    "lerp_prior": ("LerpPriorCtrl", ("VP", VP_KW), "iso", 1, {}, None, False),
    "lerp_prior.hard": ("LerpPriorCtrl", ("VP", VP_KW), "iso", 1,
                        {"hard_constrain": True}, None, False),
    "lerp_prior.dim": ("LerpPriorCtrl", ("VP", VP_KW), "iso", "d", {}, None, False),
    "lerp.delta": ("LerpCtrl", ("ScaledBM", PIS_BM), "delta", 1, {}, None, False),
    "score.time_reversal": ("ScoreCtrl", ("VP", VP_KW), None, 1, {}, None, True),
    "lerp_target.dim": ("LerpTargetCtrl", ("ScaledBM", BRIDGE_BM), None, "d", {}, None, False),
    "cancel_drift.dim": ("CancelDriftCtrl", ("VP", VP_KW), None, "d",
                         {"langevin_init": True}, None, False),
    "lerp_target.one_output": ("LerpTargetCtrl", ("ScaledBM", BRIDGE_BM), None, 0, {}, 1, False),
}


def ctrl_pair(case, d=2):
    """The case's control on the grid mixture in both packages, the
    configs' nets, sharing a perturbed JAX init; returns (JAX control, port
    control, params)."""
    cls, (sde_name, sde_kw), prior, score_out, extra, base_out, _ = CASES[case]
    j_target, target = JGMM(name="grid"), GMM(name="grid")
    j_sde = {"VP": JVP, "ScaledBM": JScaledBM}[sde_name](**sde_kw)
    sde = {"VP": VP, "ScaledBM": ScaledBM}[sde_name](**sde_kw)
    nets = dict(num_layers=4, channels=64)
    common = dict(clip_model=10.0, clip_score=10.0, detach_score=False, **extra)
    if prior == "iso":
        common["prior_score"] = (JIsoGauss(dim=d).score, IsotropicGauss(dim=d).score)
    elif prior == "delta":
        common["prior_score"] = (JDelta(dim=d).score, Delta(dim=d).score)
    kw = [{k: v[i] if k == "prior_score" else v for k, v in common.items()} for i in (0, 1)]
    if score_out:
        dim_out = d if score_out == "d" else 1
        kw[0]["score_model"] = JTimeEmbed(dim_out=dim_out, **nets,
                                          last_bias_init={"constant": 1.0})
        kw[1]["score_model"] = TimeEmbed(dim_out=dim_out, **nets,
                                         last_bias_init={"constant": 1.0})
    j_ctrl = getattr(jreparam, cls)(base_model=JFourierMLP(dim=d, dim_out=base_out, **nets),
                                    sde=j_sde, target_score=j_target.score, **kw[0])
    ctrl = getattr(reparam, cls)(base_model=FourierMLP(dim=d, dim_out=base_out, **nets),
                                 sde=sde, target_score=target.score, **kw[1])
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params


def inputs(terminal_t, d=2, seed=1, first=False, scale=3.0):
    """x0 and Brownian increments on T steps of the configs' 200-step grid:
    its last T steps, or its first from x0 = 0 (PIS's Dirac)."""
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(B, d)) * scale * (0.0 if first else 1.0)).astype(np.float32)
    start, end = (0.0, T / 200) if first else (1 - T / 200, 1.0)
    ts = np.linspace(start * terminal_t, end * terminal_t, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, B, d)) * np.sqrt(np.diff(ts))[:, None, None]).astype(np.float32)
    return x0, ts, dbs


@pytest.mark.parametrize("case", list(CASES))
def test_plain_twin_matches_jax_kernel_and_scan(case):
    j_ctrl, ctrl, params = ctrl_pair(case)
    x0, ts, dbs = inputs(ctrl.sde.terminal_t, first=case == "lerp.delta")
    wants = jax_rollouts(j_ctrl, params, x0, ts, dbs, CLIPS)
    x0_t, ts_t, dbs_t = map(torch.from_numpy, (x0, ts, dbs))
    loss = TimeReversalLoss(generative_ctrl=None, sde=ctrl.sde, method="lv").with_ctrls(
        generative_ctrl=ctrl, ctrl_module=ctrl, ctrl_clips=CLIPS)
    assert loss.phase1_route() == loss.phase1_route(on_card=True) == ("kernel", None)
    if CASES[case][-1]:  # through the loss, which passes the SDE it integrates
        with pytest.raises(NotImplementedError, match="OU-family"):
            ro.fused_rollout(ctrl, x0_t, ts_t, dbs_t, CLIPS)  # a ScoreCtrl has no SDE of its own
        xs, x_T = loss._phase1(ts_t, x0_t, dbs_t, (None, None))
    else:
        xs, x_T = ro.fused_rollout(ctrl, x0_t, ts_t, dbs_t, CLIPS)
    assert torch.equal(xs[0], x0_t) and bool(torch.isfinite(xs).all())
    for want_xs, want_xT in wants:
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(x_T.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def test_gauss_prior_terms_per_coordinate():
    """The lerp forms read a Gauss prior's loc and variance per coordinate,
    as its score computes them (an IsotropicGauss's from its host floats);
    an IsotropicGauss and an equal Gauss give the same rollout."""
    _, ctrl, _ = ctrl_pair("lerp_prior")
    iso = IsotropicGauss(dim=2, loc=0.5, scale=2.0)
    loc, var = ro.prior_terms(iso, "cpu")
    assert torch.equal(loc, torch.full((2,), 0.5)) and torch.equal(var, torch.full((2,), 4.0))
    loc, var = ro.prior_terms(Delta(dim=2), "cpu")
    assert torch.equal(loc, torch.zeros(2)) and torch.equal(var, Delta(dim=2).scale[0] ** 2)
    assert ro.prior_terms(None, "cpu") == (None, None)
    x0, ts, dbs = map(torch.from_numpy, inputs(1.0))
    ctrl.prior_score = iso.score
    want = ro.fused_rollout(ctrl, x0, ts, dbs, CLIPS)
    ctrl.prior_score = Gauss(dim=2, loc=0.5, scale=2.0).score
    got = ro.fused_rollout(ctrl, x0, ts, dbs, CLIPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a prior of another kind has no instance
    ctrl.prior_score = GMM(name="grid").score
    with pytest.raises(NotImplementedError, match="needs a Gauss prior"):
        ro.fused_rollout(ctrl, x0, ts, dbs, CLIPS)


def test_lerp_prior_lv_loss_and_gradients_match_jax():
    """`solver=dis model=lerp_prior`: the two-phase LV loss (phase 1 through
    the plain twin) and its parameter gradients against the JAX loss on the
    noise its own loss draws: values to 1e-5 relative, gradients to 1e-4 of
    each tensor's largest (tests/test_torch_port_loss.py)."""
    j_ctrl, ctrl, params = ctrl_pair("lerp_prior")
    j_prior, j_target = JIsoGauss(dim=2), JGMM(name="grid")
    prior, target = IsotropicGauss(dim=2), GMM(name="grid")
    rng = np.random.default_rng(0)
    x0 = (rng.normal(size=(64, 2)) * 3.0).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    j_loss = JTimeReversalLoss(generative_ctrl=None, sde=j_ctrl.sde, method="lv", max_rnd=1e8,
                               noise_pregen=True, scan_unroll=1)
    dbs, _ = j_loss._pregen_scan_inputs(key, jnp.asarray(ts), jnp.asarray(x0))

    def j_loss_fn(p):
        bound = j_loss.with_ctrls(
            generative_ctrl=lambda t, x: j_ctrl.apply({"params": p}, t, x))
        value, _ = bound(key, jnp.asarray(ts), jnp.asarray(x0), j_target.unnorm_log_prob,
                         j_prior.log_prob)
        return value

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(params)
    loss = TimeReversalLoss(generative_ctrl=None, sde=ctrl.sde, method="lv",
                            max_rnd=1e8).with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x), ctrl_module=ctrl, ctrl_clips=None)
    assert loss.phase1_route() == ("kernel", None)
    value, _ = loss(torch.from_numpy(ts), torch.from_numpy(x0), target.unnorm_log_prob,
                    prior.log_prob, dbs=torch.from_numpy(np.array(dbs)))
    value.backward()
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in ctrl.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4 * scale,
                                   rtol=0, err_msg=name)


SOLVERS = ("dis", "dis_no_score", "dds", "dds_euler", "pis", "pis_no_score", "bridge",
           "bridge_diff_init")
MODELS = ("clipped", "langevin_init", "lerp", "lerp_dim", "lerp_prior", "lerp_target",
          "potential", "score", "score_dim")
# the pairs that the JAX package refuses, each with the line where it fails
# (`scripts/main.py` on the CPU, one step): DDS has no SDE for a control
# that reads one, and conf/solver/dds.yaml's clip_score reaches controls
# without that field
JAX_REFUSES = {
    ("dds", "clipped"): "sde_sampler_tpu/utils/config.py:503 TypeError: ClippedCtrl got "
                        "an unexpected keyword argument 'clip_score'",
    ("dds", "potential"): "sde_sampler_tpu/utils/config.py:503 TypeError: PotentialCtrl got "
                          "an unexpected keyword argument 'clip_score'",
    ("dds", "langevin_init"): "sde_sampler_tpu/models/reparam.py:98 AttributeError: None.diff",
    ("dds", "lerp"): "sde_sampler_tpu/models/reparam.py:119 AttributeError: None.terminal_t",
    ("dds", "lerp_dim"): "sde_sampler_tpu/models/reparam.py:119 AttributeError: "
                         "None.terminal_t",
    ("dds", "lerp_prior"): "sde_sampler_tpu/models/reparam.py:145 AttributeError: "
                           "None.terminal_t",
    ("dds", "lerp_target"): "sde_sampler_tpu/models/reparam.py:157 AttributeError: "
                            "None.terminal_t",
}


def test_phase1_routes_of_the_solver_model_grid(tmp_path):
    """Every solver x model pair on the mixture, composed by the port's
    config engine and built at tiny sizes (nothing trained): phase 1 takes
    the kernel on the CPU and on the card, and raises on exactly the pairs
    that the JAX package refuses."""
    refused = set()
    for solver in SOLVERS:
        for model in MODELS:
            built = entry.make_solver([
                "target=gmm", f"solver={solver}", f"model@generative_ctrl={model}",
                "device=cpu", "plot_results=False", "train_batch_size=16",
                "eval_batch_size=64", "target.n_reference_samples=100",
                f"out_dir={tmp_path / f'{solver}_{model}'}"])
            loss = built.bound_loss({})
            try:
                routes = {loss.phase1_route(on_card=on_card) for on_card in (False, True)}
            except NotImplementedError as err:
                assert "exponential integrator needs a ScoreCtrl" in str(err)
                refused.add((solver, model))
                continue
            assert routes == {("kernel", None)}, (solver, model)
    assert refused == set(JAX_REFUSES)
