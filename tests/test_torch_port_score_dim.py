"""Score nets of one output per coordinate (`conf/model/lerp_dim.yaml`,
`score_dim.yaml`) in the port's rollouts vs the JAX package, on the CPU.

A `TimeEmbed` of d outputs depends on t alone, so `ops/rollout.py::
step_tables` tabulates scale_score * clip(score net), with LerpCtrl's hard
constraint where set, as d more columns a step; kernels 1 and 2 (on the
card) and their plain twins multiply coordinate j's score term by column j.

- The tables against the JAX control's own score-net term
  (`clipped_score_model`, `constrain`) on the same weights, at every step
  start: atol 2e-5 + rtol 1e-5 (float32; the nets' 64-wide sums in
  another order).
- The plain twins of kernel 1 (LerpCtrl of `lerp_dim` with and without the
  hard constraint under DIS's VP, ScoreCtrl of `score_dim` under PIS's
  scaled BM) and kernel 2 (`score_dim` under DDS's exponential integrator)
  against the JAX kernel `fused_sim_rollout` in interpret mode and its
  lax.scan, with the weights carried across and the same numpy noise, at
  B 32, T 12: atol 2e-5 + rtol 1e-5, the JAX package's own kernel
  tolerance (tests/test_rollout_pallas.py:54).
- A d-output net whose outputs are all equal gives the bits of the
  one-output net with that output: the per-coordinate path runs the
  one-output arithmetic (the card holds the kernels to the same in
  chip_smoke.py).
- Score nets of another width raise on both devices; d outputs in the
  lerp_target and cancel_drift forms give their one-output bits too (their
  parity with the JAX package in tests/test_torch_port_forms.py).
- Three DIS optimizer steps with `model@generative_ctrl=lerp_dim` against
  the JAX train step, at tests/test_torch_port_targets.py's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.funnel import Funnel as JFunnel
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import LerpCtrl as JLerpCtrl
from sde_sampler_tpu.models.reparam import ScoreCtrl as JScoreCtrl
from sde_sampler_tpu.ops.rollout_pallas import (
    exp_integrator_step_fn,
    fused_sim_rollout,
    sde_step_fn,
)
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import CancelDriftCtrl, LerpCtrl, LerpTargetCtrl, ScoreCtrl
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.utils.params import load_flax_params

from test_torch_port_dds import cosine_grid
from test_torch_port_img import three_steps_match_jax, tiny

D, B, T = 10, 32, 12
ALPHA, SIGMA = 0.9, 1.1
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
BM_KW = dict(diff_coeff=0.4472135954999579, terminal_t=5.0)  # conf/sde/bm_pis.yaml
CLIPS = {"clip_model": 5.0, "clip_score": 10.0}


def ctrl_pair(case, hard_constrain=False):
    """The control of `case` ("lerp": conf/model/lerp_dim.yaml under DIS,
    "score": score_dim.yaml under PIS, "exp": score_dim.yaml under DDS) on
    the funnel in both packages, with a perturbed JAX init carried across
    (every output of the score net its own)."""
    nets = dict(num_layers=4, channels=64)
    j_target, target = JFunnel(dim=D, n_reference_samples=100), Funnel(dim=D, n_reference_samples=100)
    common = dict(clip_model=1e4, clip_score=1e4, detach_score=False, scale_score=0.8)
    if case == "lerp":
        bias, j_sde, sde = 1.0, JVP(**VP_KW), VP(**VP_KW)
        j_cls, cls = JLerpCtrl, LerpCtrl
        extra = dict(hard_constrain=hard_constrain)
        j_extra = dict(extra, prior_score=JIsoGauss(dim=D).score)
        extra["prior_score"] = IsotropicGauss(dim=D).score
    else:
        bias, j_cls, cls, extra, j_extra = 0.01, JScoreCtrl, ScoreCtrl, {}, {}
        j_sde, sde = (JScaledBM(**BM_KW), ScaledBM(**BM_KW)) if case == "score" else (None, None)
    j_ctrl = j_cls(base_model=JFourierMLP(dim=D, **nets),
                   score_model=JTimeEmbed(dim_out=D, **nets, last_bias_init={"constant": bias}),
                   sde=j_sde, target_score=j_target.score, **common, **j_extra)
    ctrl = cls(base_model=FourierMLP(dim=D, **nets),
               score_model=TimeEmbed(dim_out=D, **nets, last_bias_init={"constant": bias}),
               sde=sde, target_score=target.score, **common, **extra)
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, D)))["params"]
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    params = jax.tree_util.tree_map(lambda a: a + 0.05 * jax.random.normal(next(keys), a.shape),
                                    params)
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params


def grid(case):
    """The last T steps of the configs' 200-step grid, or DDS's cosine grid."""
    if case == "exp":
        return cosine_grid()
    end = BM_KW["terminal_t"] if case == "score" else 1.0
    return np.linspace(end * (1 - T / 200), end, T + 1).astype(np.float32)


@pytest.mark.parametrize("case,hard", [("lerp", False), ("lerp", True), ("score", False),
                                       ("exp", False)])
def test_step_tables_hold_the_jax_controls_score_net_term(case, hard):
    j_ctrl, ctrl, params = ctrl_pair(case, hard)
    ts = grid(case)
    sde = ctrl.sde if case != "exp" else None
    tab, _ = ro.step_tables(ctrl, sde, torch.from_numpy(ts), CLIPS,
                            exp=(ALPHA, SIGMA) if case == "exp" else None)
    assert tab.shape == (T, 6 + D) and bool(torch.isnan(tab[:, 4]).all())

    def term(module, s, x):
        out = module.clipped_score_model(s, x, CLIPS)
        if hard:
            out = module.constrain(out, s)
        return module.scale_score * out

    x = jnp.zeros((1, D))
    want = jax.jit(jax.vmap(lambda s: j_ctrl.apply({"params": params}, s, x, method=term)[0]))(
        jnp.asarray(ts[:-1]))
    np.testing.assert_allclose(tab[:, 6:].numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    assert float(tab[:, 6:].std(dim=1).min()) > 0  # the coordinates' scales differ


def jax_rollouts(case, j_ctrl, params, x0, ts, noise):
    def apply_ctrl(p, s, x):
        return j_ctrl.apply({"params": p}, s, x, clips=CLIPS)

    if case == "exp":
        step = exp_integrator_step_fn(apply_ctrl, alpha=ALPHA, sigma=SIGMA)
    else:
        step = sde_step_fn(apply_ctrl, drift=j_ctrl.sde.drift, diff=j_ctrl.sde.diff)
    x0, ts, noise = map(jnp.asarray, (x0, ts, noise))

    def body(x, inp):
        s, t, n = inp
        return step(params, s, t, x, n), x

    x_T, xs = jax.lax.scan(body, x0, (ts[:-1], ts[1:], noise))
    return [fused_sim_rollout(step, params, x0, ts, noise, block_b=16, interpret=True),
            (xs, x_T)]


@pytest.mark.parametrize("case,hard", [("lerp", False), ("lerp", True), ("score", False),
                                       ("exp", False)])
def test_plain_twins_match_jax_kernel_and_scan(case, hard):
    j_ctrl, ctrl, params = ctrl_pair(case, hard)
    ts = grid(case)
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(B, D)).astype(np.float32) * (0.0 if case == "score" else 1.0)
    noise = rng.normal(size=(T, B, D)).astype(np.float32)
    if case != "exp":
        noise *= np.sqrt(np.diff(ts))[:, None, None]
    args = map(torch.from_numpy, (x0, ts, noise))
    if case == "exp":
        xs, x_T = ro.fused_rollout_exp(ctrl, *args, ALPHA, SIGMA, CLIPS)
    else:
        xs, x_T = ro.fused_rollout(ctrl, *args, CLIPS, sde=ctrl.sde if case == "score" else None)
    assert bool(torch.isfinite(xs).all())
    for want_xs, want_xT in jax_rollouts(case, j_ctrl, params, x0, ts, noise):
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(x_T.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


class EqualOutputs(TimeEmbed):
    """A TimeEmbed of d outputs, each the output of a one-output net."""

    def __init__(self, one: TimeEmbed, dim_out: int):
        super().__init__(dim_out=dim_out, num_layers=4, channels=64)
        self.one = one

    def forward(self, t, *args):
        out = self.one(t, *args)
        return out.expand(*out.shape[:-1], self.dim_out)


@pytest.mark.parametrize("case,hard", [("lerp", False), ("lerp", True), ("score", False),
                                       ("exp", False)])
def test_equal_outputs_give_the_one_output_bits(case, hard):
    _, ctrl, _ = ctrl_pair(case, hard)
    one = TimeEmbed(dim_out=1, num_layers=4, channels=64, last_bias_init={"constant": 0.5})
    one.reset_parameters(torch.Generator().manual_seed(7))
    ts = torch.from_numpy(grid(case))
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn(B, D, generator=gen)
    noise = torch.randn(T, B, D, generator=gen) * 0.05
    results = []
    for score_model in (one, EqualOutputs(one, D)):
        ctrl.score_model = score_model
        if case == "exp":
            results.append(ro.fused_rollout_exp(ctrl, x0, ts, noise, ALPHA, SIGMA, CLIPS))
        else:
            results.append(ro.fused_rollout(ctrl, x0, ts, noise, CLIPS,
                                            sde=ctrl.sde if case == "score" else None))
    assert ro.per_coord(ctrl)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_other_score_net_widths_and_forms_raise():
    _, ctrl, _ = ctrl_pair("lerp")
    x0, ts, dbs = torch.zeros(B, D), torch.linspace(0, 1, T + 1), torch.zeros(T, B, D)
    ctrl.score_model = TimeEmbed(dim_out=3)
    with pytest.raises(NotImplementedError, match="one output or one per coordinate"):
        ro.fused_rollout(ctrl, x0, ts, dbs)
    # the lerp_target and cancel_drift forms take d outputs too: equal
    # outputs give the one-output bits
    sde, target = VP(**VP_KW), Funnel(dim=D, n_reference_samples=100)
    one = TimeEmbed(dim_out=1, num_layers=4, channels=64, last_bias_init={"constant": 0.5})
    one.reset_parameters(torch.Generator().manual_seed(7))
    x0, dbs = torch.randn(B, D) * 0.5, torch.randn(T, B, D) * 0.05
    for cls, kw in ((LerpTargetCtrl, {}), (CancelDriftCtrl, {"langevin_init": True})):
        other = cls(base_model=FourierMLP(dim=D), score_model=one, sde=sde,
                    target_score=target.score, clip_model=10.0, clip_score=10.0, **kw)
        want = ro.fused_rollout(other, x0, ts, dbs)
        other.score_model = EqualOutputs(one, D)
        assert ro.per_coord(other)
        got = ro.fused_rollout(other, x0, ts, dbs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a d-output net at d = 1 is the one-output net
    one_d = ScoreCtrl(base_model=FourierMLP(dim=1), score_model=TimeEmbed(dim_out=1),
                      target_score=lambda x: -x)
    assert not ro.per_coord(one_d)


def test_three_lerp_dim_optimizer_steps_match_jax(tmp_path):
    three_steps_match_jax(tmp_path, tiny("funnel", "model@generative_ctrl=lerp_dim",
                                         "target.n_reference_samples=1000"))
