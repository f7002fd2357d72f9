"""DDS on the funnel: the port vs the JAX package.

Kernel 2 (`fused_rollout_exp`, the exponential-integrator rollout) runs its
plain twin on the CPU; it must match the JAX kernel `fused_sim_rollout` with
`exp_integrator_step_fn` in interpret mode and its lax.scan, on a funnel
`ScoreCtrl` stack (FourierMLP, TimeEmbed score net, scale_score 0.7, so
that the port's folded score scale is exercised) over a short cosine grid
whose last steps have dt = 0 exactly. Float32 on both sides, summed in
another order: atol 2e-5 + rtol 1e-5, the tolerance of the JAX package's own
kernel test (tests/test_rollout_pallas.py:54).

`ExponentialIntegratorSDELoss` (two-phase lv, lv through `simulate`, kl,
kl_ito) is held against the JAX loss on the JAX package's own noise buffer
(`_pregen_scan_inputs(key, ts, x, scale_sqrt_dt=False)`, standard
normals): loss values to 1e-5 relative, parameter gradients to 1e-4 of the
largest gradient of each tensor, as in tests/test_torch_port_loss.py. The
DDS trainer takes three optimizer steps against JAX's, as
tests/test_torch_port_solver.py does for DIS.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.double_well import MultiWell as JMultiWell
from sde_sampler_tpu.distr.funnel import Funnel as JFunnel
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.losses.oc import BaseOCLoss as JBaseOCLoss
from sde_sampler_tpu.losses.oc import ExponentialIntegratorSDELoss as JExpLoss
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import ScoreCtrl as JScoreCtrl
from sde_sampler_tpu.ops.rollout_pallas import exp_integrator_step_fn, fused_sim_rollout
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.double_well import MultiWell
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.losses.oc import BaseOCLoss, ExponentialIntegratorSDELoss
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import ClippedCtrl, LerpCtrl, ScoreCtrl
from sde_sampler_torch.ops.rollout import fused_rollout, fused_rollout_exp
from sde_sampler_torch.utils.common import get_timesteps
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = Path(__file__).parents[1]
D, B, T = 10, 32, 12
ALPHA, SIGMA = 0.9, 1.1

_PARAMS = {}


def score_pair(clip=10.0, scale_score=0.7, j_sde=None, sde=None, d=D, targets=None):
    """The funnel ScoreCtrl (or one on `targets`, a (JAX, port) pair) in both
    packages, sharing JAX's init (the last layers get values so that every
    parameter is seen)."""
    j_target, target = targets or (
        JFunnel(dim=d, n_reference_samples=100), Funnel(dim=d, n_reference_samples=100))
    common = dict(clip_model=clip, clip_score=clip, detach_score=False, scale_score=scale_score)
    j_ctrl = JScoreCtrl(
        base_model=JFourierMLP(dim=d, num_layers=4, channels=64),
        score_model=JTimeEmbed(dim_out=1, num_layers=4, channels=64,
                               last_bias_init={"constant": 0.01}),
        sde=j_sde, target_score=j_target.score, **common,
    )
    ctrl = ScoreCtrl(
        base_model=FourierMLP(dim=d, num_layers=4, channels=64),
        score_model=TimeEmbed(dim_out=1, num_layers=4, channels=64,
                              last_bias_init={"constant": 0.01}),
        sde=sde, target_score=target.score, **common,
    )
    if d not in _PARAMS:
        params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))
        _PARAMS[d] = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
            params["params"],
        )
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, _PARAMS[d]))
    return j_ctrl, ctrl, _PARAMS[d], j_target, target


def cosine_grid(steps=T, end=1.6):
    """A (steps + 1,) DDS cosine grid; its last steps have dt = 0 exactly."""
    ts = get_timesteps(0.0, end, steps=steps - 1, rescale_t="cosine").numpy()
    assert ts.shape == (steps + 1,) and ts[-1] == ts[-2]
    return ts


def rollout_inputs(seed=1, batch=B, d=D):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, d)).astype(np.float32)
    noise = rng.normal(size=(T, batch, d)).astype(np.float32)
    return x0, cosine_grid(), noise


@pytest.mark.parametrize("clipped,target", [(False, "funnel"), (True, "funnel"), (True, "mw")],
                         ids=["False", "True", "score.wells"])
def test_exp_plain_rollout_matches_jax_kernel_and_scan(clipped, target):
    """"score.wells": the DDS ScoreCtrl on mw (MultiWell, d = 5, five wells
    at separation 4), kernel 2's wells form."""
    d = D if target == "funnel" else 5
    j_ctrl, ctrl, params, _, _ = score_pair(
        clip=10.0 if clipped else None, d=d,
        targets=None if target == "funnel" else (
            JMultiWell(dim=5, n_double_wells=5, separation=4.0),
            MultiWell(dim=5, n_double_wells=5, separation=4.0)))
    clips = {"clip_model": 0.3, "clip_score": 2.0} if clipped else None
    x0, ts, noise = rollout_inputs(d=d)

    def apply_ctrl(p, s, x):
        return j_ctrl.apply({"params": p}, s, x, clips=clips)

    step = exp_integrator_step_fn(apply_ctrl, alpha=ALPHA, sigma=SIGMA)
    jx0, jts, jnoise = map(jnp.asarray, (x0, ts, noise))
    kernel = fused_sim_rollout(step, params, jx0, jts, jnoise, block_b=16, interpret=True)

    def body(x, inp):
        s, t, eps = inp
        return step(params, s, t, x, eps), x

    x_T, xs = jax.lax.scan(body, jx0, (jts[:-1], jts[1:], jnoise))
    got_xs, got_xT = fused_rollout_exp(
        ctrl, torch.from_numpy(x0), torch.from_numpy(ts), torch.from_numpy(noise),
        ALPHA, SIGMA, clips,
    )
    assert torch.equal(got_xs[0], torch.from_numpy(x0))
    # the dt = 0 step passes the state through unchanged
    assert torch.equal(got_xT, got_xs[-1])
    for want_xs, want_xT in (kernel, (xs, x_T)):
        np.testing.assert_allclose(got_xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got_xT.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def test_exp_plain_twin_matches_the_generic_loop():
    """The per-step tables reproduce the generic ScoreCtrl call step by step."""
    _, ctrl, _, _, _ = score_pair(scale_score=1.3)
    x0, ts, noise = map(torch.from_numpy, rollout_inputs(seed=4))
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    xs, x_T = fused_rollout_exp(ctrl, x0, ts, noise, ALPHA, SIGMA, clips)
    x, xs_g = x0, []
    with torch.no_grad():
        for k in range(T):
            beta = (ALPHA * torch.sqrt(ts[k + 1] - ts[k])).clamp(0.0, 1.0)
            xs_g.append(x)
            u = ctrl(ts[k], x, clips=clips)
            x = x * torch.sqrt(1 - beta**2) + beta**2 * SIGMA**2 * u + SIGMA * beta * noise[k]
    torch.testing.assert_close(xs, torch.stack(xs_g), atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, x, atol=2e-5, rtol=1e-5)


def test_rollouts_raise_on_unsupported_controls_and_targets():
    _, ctrl, _, _, _ = score_pair()
    x0, ts, noise = map(torch.from_numpy, rollout_inputs())
    sde = VP()
    # the score-free ClippedCtrl has kernel 1's form only
    plain = ClippedCtrl(base_model=FourierMLP(dim=D), sde=sde)
    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
        fused_rollout_exp(plain, x0, ts, noise, ALPHA, SIGMA)
    prior = IsotropicGauss(dim=D)
    lerp = LerpCtrl(base_model=FourierMLP(dim=D), sde=sde, prior_score=prior.score,
                    target_score=Funnel(dim=D, n_reference_samples=10).score)
    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
        fused_rollout_exp(lerp, x0, ts, noise, ALPHA, SIGMA)
    # a target without an inline score (a bare function) takes the
    # given-score form: its twin runs the generic exponential-integrator loop
    bare = ScoreCtrl(base_model=FourierMLP(dim=D), target_score=lambda x: -x)
    xs, x_T = fused_rollout_exp(bare, x0, ts, noise, ALPHA, SIGMA)
    x = x0
    with torch.no_grad():
        for k in range(T):
            torch.testing.assert_close(xs[k], x, atol=2e-5, rtol=1e-5)
            beta = (ALPHA * torch.sqrt(ts[k + 1] - ts[k])).clamp(0.0, 1.0)
            u = bare(ts[k], x)
            x = x * torch.sqrt(1 - beta**2) + beta**2 * SIGMA**2 * u + SIGMA * beta * noise[k]
    torch.testing.assert_close(x_T, x, atol=2e-5, rtol=1e-5)
    # a score net of one output per coordinate has its instances
    # (tests/test_torch_port_score_dim.py); any other width has none
    wide = ScoreCtrl(base_model=FourierMLP(dim=D), score_model=TimeEmbed(dim_out=3),
                     target_score=ctrl.target_score)
    with pytest.raises(NotImplementedError, match="one output"):
        fused_rollout_exp(wide, x0, ts, noise, ALPHA, SIGMA)
    # the EM kernel needs the SDE it integrates
    with pytest.raises(NotImplementedError, match="OU-family"):
        fused_rollout(ctrl, x0, ts, noise)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_rollout_exp(ctrl, x0[:5], ts, noise, ALPHA, SIGMA)


def loss_setup(method, two_phase, seed=0, batch=64):
    j_ctrl, ctrl, params, j_target, target = score_pair()
    j_prior, prior = JIsoGauss(dim=D, scale=SIGMA), IsotropicGauss(dim=D, scale=SIGMA)
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(batch, D)) * SIGMA).astype(np.float32)
    ts = cosine_grid()
    key = jax.random.PRNGKey(seed)
    kw = dict(method=method, alpha=ALPHA, sigma=SIGMA, max_rnd=1e8, two_phase=two_phase)
    j_loss = JExpLoss(generative_ctrl=None, noise_pregen=True, scan_unroll=1, **kw)
    noise, _ = j_loss._pregen_scan_inputs(key, jnp.asarray(ts), jnp.asarray(x0),
                                          scale_sqrt_dt=False)
    loss = ExponentialIntegratorSDELoss(generative_ctrl=None, **kw)
    return dict(j_ctrl=j_ctrl, ctrl=ctrl, params=params, j_target=j_target, target=target,
                j_prior=j_prior, prior=prior, x0=x0, ts=ts, key=key, j_loss=j_loss,
                loss=loss, noise=np.array(noise))


@pytest.mark.parametrize(
    "method,two_phase", [("lv", True), ("lv", False), ("kl", None), ("kl_ito", None)]
)
def test_exp_loss_and_gradients_match_jax(method, two_phase):
    """lv two-phase: phase 1 through kernel 2's plain twin, phase 2 one
    batched control call; the others through the autograd `simulate`."""
    c = loss_setup(method, two_phase)

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
    assert loss.two_phase == (method == "lv" and two_phase is not False)
    value, metrics = loss(torch.from_numpy(c["ts"]), torch.from_numpy(c["x0"]),
                          c["target"].unnorm_log_prob, c["prior"].log_prob,
                          dbs=torch.from_numpy(c["noise"]))
    value.backward()
    assert int(metrics["train/n_filtered"]) == 0
    assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in ctrl.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(
            p.grad.numpy(), want[name].numpy(), atol=1e-4 * scale, rtol=0, err_msg=name
        )


def test_exp_eval_estimators_match_jax():
    c = loss_setup("lv", None, seed=1)
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
                        return_traj=True, dbs=torch.from_numpy(c["noise"]))
    for got, want in ((res.samples, j_res.samples), (res.xs, j_res.xs),
                      (res.rnd, j_res.rnd), (res.rnd_no_ito, j_res.rnd_no_ito)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    stats = BaseOCLoss.compute_results_arrays(res.rnd, res.rnd_no_ito, max_rnd=1e8)
    j_stats = JBaseOCLoss.compute_results_arrays(j_res.rnd, j_res.rnd_no_ito, max_rnd=1e8)
    for name in ("log_norm_const_is", "log_norm_const_lb", "log_norm_const_lb_ito"):
        assert float(stats[name]) == pytest.approx(float(j_stats[name]), rel=1e-5, abs=1e-5)


def test_noise_buffer_of_the_exponential_integrator_is_unscaled():
    ts = torch.from_numpy(cosine_grid())
    x = torch.zeros(4096, D)
    g = torch.Generator().manual_seed(0)
    noise = BaseOCLoss.draw_noise(ts, x, g, scale_sqrt_dt=False)
    g.manual_seed(0)
    dbs = BaseOCLoss.draw_noise(ts, x, g)
    assert abs(float(noise.std()) - 1.0) < 0.01
    torch.testing.assert_close(dbs, noise * torch.sqrt(ts[1:] - ts[:-1])[:, None, None])


BATCH = 16
TINY = [
    "target=funnel", "solver=dds", f"train_batch_size={BATCH}",
    "train_timesteps.dt=2.0", "plot_results=False", "eval_init=False",
    "store_last_ckpt=False", "target.n_reference_samples=1000", "n_devices=1",
    "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
]


def test_three_dds_optimizer_steps_match_jax(tmp_path):
    """Losses agree to 1e-5 relative and max gradients to 1e-4 relative.

    Parameters agree to 5e-5 absolute (1% of one Adam step of lr 5e-3),
    except elements whose gradient in some step was nonzero but below 1e-2
    of its tensor's largest. The gradients agree to about 1e-4 of that
    largest, so such a gradient is known to 1% or worse, and Adam
    normalises every update to about lr whatever the gradient's size: the
    first step of an element whose gradient is at the rounding level goes
    whichever way the rounding says. Those elements are held only to two
    steps of 2 lr; fewer than 0.1% of all elements may exceed 5e-5. The
    last layers start at zero, so the first nonzero gradients of the layers
    below are small. (For DIS, one element of 38859 moved by 1.4e-5:
    tests/test_torch_port_solver.py.)
    """
    from sde_sampler_tpu.utils.config import compose, locate

    cfg = compose(REPO / "conf", "base", TINY + ["train_steps=10", f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(TINY + ["train_steps=10", "device=cpu", f"out_dir={tmp_path / 'port'}"])
    assert ps.sde is None and ps.reference_distr is ps.prior
    assert ps.train_ts.shape == (9,) and float(ps.train_ts[-1] - ps.train_ts[-2]) == 0.0
    j_params = jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"])
    load_flax_params(ps.generative_ctrl, j_params)
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)

    params = dict(ps.generative_ctrl.named_parameters())
    low = {name: np.zeros(p.shape, dtype=bool) for name, p in params.items()}
    for _ in range(3):
        _, k_loss = jax.random.split(js.train_state.key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (BATCH,))
        noise, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0, scale_sqrt_dt=False)
        j_metrics = js.step()
        metrics = ps.step(x0=torch.from_numpy(np.array(x0)),
                          dbs=torch.from_numpy(np.array(noise)))
        assert float(metrics["train/loss"]) == pytest.approx(
            float(j_metrics["train/loss"]), rel=1e-5)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=1e-4)
        for name, p in params.items():
            g = p.grad.abs().numpy()
            low[name] |= (g > 0) & (g < 1e-2 * g.max())

    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    lr, n_off, n_all = 5e-3, 0, 0
    for name, value in ps.generative_ctrl.state_dict().items():
        err = np.abs(value.numpy() - want[name].numpy())
        assert err[~low[name]].max(initial=0.0) <= 5e-5, name
        assert err.max() <= 2 * 2 * lr, name
        n_off += int((err > 5e-5).sum())
        n_all += err.size
    assert n_off < 1e-3 * n_all
    assert ps.n_steps == 3 and ps.n_updates == 3 and ps.n_steps_skip == 0


@pytest.mark.parametrize(
    "solver,grid",
    [("dds", "train_timesteps.dt=1.0"), ("dds_euler", "train_timesteps.steps=16"),
     ("pis", "train_timesteps.steps=16")],
)
def test_entry_point_cpu_run_of_each_reference_solver(tmp_path, solver, grid):
    out = tmp_path / solver
    entry.main([
        "target=funnel", f"solver={solver}", grid, "device=cpu", "plot_results=False",
        "train_steps=3", f"train_batch_size={BATCH}", "eval_batch_size=64",
        "eval_init=False", "store_last_ckpt=False", "target.n_reference_samples=1000",
        f"out_dir={out}",
    ])
    import json

    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size",
                "error/sinkhorn"):
        assert math.isfinite(final[key]), key
    assert any(math.isfinite(l.get("train/loss", math.nan)) for l in lines)
