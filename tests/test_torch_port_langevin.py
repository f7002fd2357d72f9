"""The Langevin solver, the CancelDriftCtrl of `model=langevin_init`, and
the slice's entry paths of the port vs the JAX package on the CPU.

- `LangevinSolver` (`solver=langevin`) built from conf/ on both sides, fed
  the same prior samples and one shared piecewise-linear Brownian path
  (tests/test_torch_port_integrators.py), under the Euler, Heun and
  adaptive Heun configs: the trajectory on the output grid, the burn-in
  expectations and their `_direct` metrics to 1e-5 (float32 on both sides,
  the same operations). The target is the shifted Gaussian, whose Langevin
  dynamics contract: on the mixture's modes the adaptive controller's step
  sizes, which round apart by 1e-7 (tests/test_torch_port_integrators.py),
  are amplified by the dynamics to 4e-4 within 0.5 time units.
- `CancelDriftCtrl` with the JAX parameters carried across: values and
  parameter gradients to 1e-5, with langevin_init on and off, at one time
  and on a (T, B, d) stack; three EulerDDS optimizer steps of
  `model@generative_ctrl=langevin_init` on the mixture with the JAX
  package's noise: losses and largest gradients to 1e-4 relative and the
  parameters to 5e-5 with the Adam low-gradient rule of the Bridge's and
  the mixture's solver tests (tests/test_torch_port_bridge.py,
  test_torch_port_targets.py).
- Runs through `python -m sde_sampler_torch.main ... device=cpu`: the
  Langevin solver under each of the five integrator configs, DIS on the
  rings and the Rosenbrock, and EulerDDS with the langevin_init control.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import CancelDriftCtrl as JCancelDriftCtrl
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.gauss import GMM
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import CancelDriftCtrl
from sde_sampler_torch.utils.params import load_flax_params, load_solver_params

from test_torch_port_integrators import jax_path, knots, torch_path

REPO = Path(__file__).parents[1]
B = 64  # divisible by the JAX package's eight CPU devices


def langevin_args(integrator, target="gmm"):
    return [
        f"target={target}", "solver=langevin", f"integrator={integrator}", f"eval_batch_size={B}",
        "sde.terminal_t=0.5", "eval_timesteps.steps=10", "eval_expectation_burn=5",
        "integrator.dt=0.05", "plot_results=False", "store_last_ckpt=False", "n_devices=1",
        *(["target.n_reference_samples=1000"] if target == "gmm" else []),
        "~eval_sample_losses",
    ]


@pytest.mark.parametrize("integrator", ["euler", "heun", "torchsde_heun"])
def test_langevin_solver_matches_jax_on_shared_noise(tmp_path, integrator):
    from sde_sampler_tpu.utils.config import compose, locate

    args = langevin_args(integrator, target="gauss_shift")
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    assert type(ps).__name__ == "LangevinSolver"
    assert type(ps.integrator).__name__ == type(js.integrator).__name__
    js.target.compute_stats(js.next_key())
    ps.target.compute_stats(ps.generator)

    x0 = (np.random.default_rng(7).normal(size=(B, 1)) * 3).astype(np.float32)
    tk, w = knots(0.0, 0.5, 500, seed=8, shape=(B, 1))
    js.prior.sample = lambda key, shape: jnp.asarray(x0)
    ps.prior.sample = lambda shape, generator=None: torch.from_numpy(x0)
    j_integrate, p_integrate = js.integrator.integrate, ps.integrator.integrate
    js.integrator.integrate = lambda sde, ts, x_init, key, timesteps=None, bm=None: j_integrate(
        sde, ts, x_init, key, timesteps=timesteps, bm=jax_path(tk, w))
    ps.integrator.integrate = lambda sde, ts, x_init, generator=None, timesteps=None: p_integrate(
        sde, ts, x_init, generator, timesteps=timesteps, bm=torch_path(tk, w))

    want, got = js.run(), ps.run()
    assert got.xs.shape == (11, B, 1) and got.weights is None
    assert got.log_norm_const_preds is None
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), atol=1e-5, rtol=1e-5)
    for name, value in want.expectation_preds.items():
        assert got.expectation_preds[name] == pytest.approx(value, rel=1e-5, abs=1e-5), name
    want_m, _ = js.get_metrics_and_plots(want)
    got_m = ps.get_metrics(got)
    for name in want.expectation_preds:
        for key in (f"eval/{name}", f"eval/{name}_direct"):
            assert got_m[key] == pytest.approx(want_m[key], rel=1e-5, abs=1e-5), key
    assert "eval/effective_sample_size" not in got_m


@pytest.mark.parametrize("langevin_init", [True, False])
def test_cancel_drift_ctrl_matches_jax_with_carried_weights(langevin_init):
    d = 2
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
    j_target, target = JGMM(name="grid"), GMM(name="grid")
    common = dict(clip_model=4.0, clip_score=30.0, detach_score=False, scale_score=0.7,
                  langevin_init=langevin_init)
    nets = dict(num_layers=4, channels=64)
    j_ctrl = JCancelDriftCtrl(
        base_model=JFourierMLP(dim=d, **nets),
        score_model=JTimeEmbed(dim_out=1, **nets, last_bias_init={"constant": 1.0}),
        sde=JVP(**kw), target_score=j_target.score, **common)
    ctrl = CancelDriftCtrl(
        base_model=FourierMLP(dim=d, **nets),
        score_model=TimeEmbed(dim_out=1, **nets, last_bias_init={"constant": 1.0}),
        sde=VP(**kw), target_score=target.score, **common)
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(5, 16, d)) * 3).astype(np.float32)
    ts = np.linspace(0.0, 0.8, 5).astype(np.float32)
    clips = {"clip_model": 2.0, "clip_score": 20.0}

    def j_steps(p):  # each step's (B, d) state at its own time
        return jnp.stack([j_ctrl.apply({"params": p}, jnp.float32(ts[k]), jnp.asarray(x[k]),
                                       clips=clips) for k in range(5)])

    for k in (0, 3):  # one time on a (B, d) state
        want = j_ctrl.apply({"params": params}, jnp.float32(ts[k]), jnp.asarray(x[k]), clips=clips)
        got = ctrl(torch.tensor(ts[k]), torch.from_numpy(x[k]), clips=clips)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the (T, B, d) stack with its (T, 1, 1) times in one call (phase 2's),
    # and the parameter gradients of its sum
    got = ctrl(torch.from_numpy(ts.reshape(5, 1, 1)), torch.from_numpy(x), clips=clips)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(j_steps(params)),
                               rtol=1e-5, atol=1e-5)
    got.sum().backward()
    j_grads = jax.grad(lambda p: j_steps(p).sum())(params)
    from sde_sampler_torch.utils.params import flax_to_state_dict

    want_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in ctrl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_three_langevin_init_optimizer_steps_match_jax(tmp_path):
    """EulerDDS with the CancelDriftCtrl on the mixture: the VP drift is
    nonzero, so the control cancels it in every EM step of phase 1 (the
    cancel_drift plain twin here) and of phase 2."""
    from sde_sampler_tpu.utils.config import compose, locate

    n = 16
    args = ["target=gmm", "solver=dds_euler", "model@generative_ctrl=langevin_init",
            f"train_batch_size={n}", "train_timesteps.steps=6", "plot_results=False",
            "eval_init=False", "store_last_ckpt=False", "n_devices=1",
            "target.n_reference_samples=1000", "loss.scan_unroll=1", "train_steps=10"]
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    assert type(ps.generative_ctrl).__name__ == "CancelDriftCtrl"
    assert ps.generative_ctrl.langevin_init is True
    load_solver_params(ps.modules, jax.tree_util.tree_map(np.asarray, js.train_state.params))
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)
    params = dict(ps.generative_ctrl.named_parameters())
    low = {name: np.zeros(p.shape, dtype=bool) for name, p in params.items()}
    for _ in range(3):
        _, k_loss = jax.random.split(js.train_state.key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (n,))
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
    from sde_sampler_torch.utils.params import flax_to_state_dict

    # the Adam rule of tests/test_torch_port_targets.py: elements whose
    # gradient lay at the rounding level in some step are held to two
    # steps of 2 lr, and fewer than 0.1% of all may exceed 5e-5
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
    assert ps.n_updates == 3 and ps.n_steps_skip == 0


def _last_metrics(out_dir):
    lines = (out_dir / "metrics.jsonl").read_text().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize(
    "integrator", ["euler", "heun", "euler_adjoint", "torchsde_euler", "torchsde_heun"])
def test_langevin_entry_runs_each_integrator(tmp_path, integrator):
    args = langevin_args(integrator) + ["device=cpu", f"out_dir={tmp_path}"]
    args = [a for a in args if a != "~eval_sample_losses"]  # the Sinkhorn at n = 64
    solver = entry.main(args)
    metrics = _last_metrics(tmp_path)
    for name in ("square", "abs", "sum", "square_minus_sum"):
        assert np.isfinite(metrics[f"eval/{name}_direct"]), name
    assert np.isfinite(metrics["error/sinkhorn"])
    if integrator == "torchsde_heun":
        assert solver.integrator.n_accepted >= 10


@pytest.mark.parametrize("args,keys", [
    (["target=rings", "solver=dis", "loss.method=lv"],
     ["eval/log_norm_const_is", "error/log_norm_const_is", "eval/effective_sample_size"]),
    (["target=rosenbrock", "solver=dis"],
     ["eval/log_norm_const_is", "eval/obj_avg", "eval/avg_obj", "eval/min_obj"]),
    (["target=gmm", "solver=dds_euler", "model@generative_ctrl=langevin_init",
      "target.n_reference_samples=1000"],
     ["eval/log_norm_const_is", "error/log_norm_const_is", "error/sinkhorn"]),
], ids=["rings_dis", "rosenbrock_dis", "gmm_dds_euler_langevin_init"])
def test_slice_entry_runs(tmp_path, args, keys):
    entry.main(args + ["device=cpu", "plot_results=False", "train_steps=5",
                       "train_batch_size=16", "train_timesteps.steps=8", "eval_batch_size=64",
                       "eval_init=False", f"out_dir={tmp_path}"])
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(l["train/loss"]) for l in lines if "train/loss" in l)
    for key in keys:
        assert np.isfinite(lines[-1][key]), key
