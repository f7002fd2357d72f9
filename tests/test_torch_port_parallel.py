"""Data parallelism of the port (`n_devices` > 1) against the JAX package's
mesh and against the port on one device.

The port's ranks are spawned gloo processes on the CPU
(`sde_sampler_torch.parallel.mesh.spawn`), one group per test; their
functions live in tests/torch_parallel_ranks.py, which imports no JAX. The
JAX side runs on the 8 virtual CPU devices of tests/conftest.py.

Tolerances:
- the sharded Sinkhorn (n = 100, eps = 1e-2) within 1e-5 relative of the
  port's one-rank result and of a float64 Sinkhorn (the bar of
  tests/test_torch_port_sinkhorn.py against truth), and within 1e-4 of the
  JAX sharded Sinkhorn (its bar against JAX), which lies within 1e-4 of
  float64 at d = 1 too;
- three optimizer steps at n_devices=2 against the JAX n_devices=8 losses
  at rtol 1e-4, atol 1e-5 (the JAX package's own multichip tests), and the
  ranks' parameters equal bit for bit. The losses alone cannot see a
  gradient summed wrongly over the ranks (Adam's steps do not change when
  every gradient is scaled alike), so each step's largest gradient
  (`train/max_grad`, near 1e14 at these sizes) is held within 1e-5
  relative of the port's one-rank steps on the same draws, and within 1e-3
  of JAX's: the port's one rank lies 2.1e-4 from JAX's there, float32
  rounding of a loss near 1e12, while JAX's 8 devices lie within 1e-7 of
  its one;
- the port at n_devices=2 against itself at n_devices=1 with one seed: the
  same global draws, so only the order of the reductions differs. Losses
  and largest gradients within 1e-5 relative, the log Z estimators and the ESS within 1e-5
  (relative, or 1e-5 absolute near 0), the Sinkhorn within 1e-5; the
  Langevin chains are integrated row by row from the same draws, so their
  expectations under each integrator agree to 1e-6 relative.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

from sde_sampler_torch import main as entry
from sde_sampler_torch.eval.sinkhorn import Sinkhorn
from sde_sampler_torch.parallel import mesh
from sde_sampler_torch.utils.launcher import SlurmLauncher

SINKHORN_KW = dict(eps=1e-2, max_iters=100, stop_thresh=1e-5)


def sinkhorn_f64(x, y, eps, max_iters, stop_thresh):
    """The log-domain Sinkhorn of eval/sinkhorn.py in float64 numpy."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    cost = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
    log_a, log_b = np.full(len(x), -np.log(len(x))), np.full(len(y), -np.log(len(y)))

    def softmin(c, dual):
        z = (-c + dual[None]) / eps
        top = z.max(axis=1, keepdims=True)
        return eps * (np.log(np.exp(z - top).sum(axis=1)) + top[:, 0])

    u, v = np.zeros(len(x)), eps * log_b
    for _ in range(max_iters):
        u_new = log_a * eps - softmin(cost, v)
        v_new = log_b * eps - softmin(cost.T, u_new)
        err = max(np.abs(u - u_new).max(), np.abs(v - v_new).max())
        u, v = u_new, v_new
        if err < stop_thresh:
            break
    return float((np.exp((-cost + u[:, None] + v[None]) / eps) * cost).sum())


@pytest.mark.parametrize("w", [2, 3])
def test_sharded_sinkhorn_matches_jax_and_one_rank(w):
    """W = 2 and W = 3 ranks at n = 100 (uneven blocks at W = 3), d = 1 and
    d = 3, against the JAX sharded Sinkhorn on a W-device mesh; the mesh
    helpers on an uneven and a repeated batch."""
    from sde_sampler_tpu.eval.sinkhorn import Sinkhorn as JSinkhorn
    from sde_sampler_tpu.parallel.mesh import get_mesh

    rng = np.random.default_rng(7)
    cases = [(rng.normal(size=(100, d)).astype(np.float32),
              (rng.normal(size=(100, d)) + 0.3).astype(np.float32)) for d in (1, 3)]
    got = mesh.spawn(ranks.sinkhorn_and_mesh, w, "cpu", args=(cases, SINKHORN_KW))
    assert all(r["sinkhorn"] == got[0]["sinkhorn"] for r in got)  # one value on every rank
    assert all(r["n_iters"] == got[0]["n_iters"] for r in got)
    for (x, y), sharded in zip(cases, got[0]["sinkhorn"]):
        one = float(Sinkhorn(**SINKHORN_KW)(torch.from_numpy(x), torch.from_numpy(y)))
        truth = sinkhorn_f64(x, y, **SINKHORN_KW)
        jax_mesh = JSinkhorn(mesh=get_mesh(w), **SINKHORN_KW)
        want = float(jax_mesh(jnp.asarray(x), jnp.asarray(y)))
        assert sharded == pytest.approx(one, rel=1e-5)
        assert sharded == pytest.approx(truth, rel=1e-5)
        assert sharded == pytest.approx(want, rel=1e-4)
        # d = 1 too: the two sharded paths agree far below the 15% of the
        # 100k dw_shift Sinkhorns against the TPU's (ROADMAP, Queue 3)
        assert want == pytest.approx(truth, rel=1e-4)

    blocks = [r["mesh"] for r in got]
    sizes = mesh.block_sizes(10, w)
    assert [b["block"] for b in blocks] == [
        [sum(sizes[:r]), sizes[r]] for r in range(w)]
    starts = [sum(sizes[:r]) for r in range(w)]
    for r, b in enumerate(blocks):
        assert b["sizes"] == sizes and b["gathered"] and b["gathered_dim1"]
        assert b["sum"] == sum(range(30)) and b["max"] == 29.0
        mine = list(range(starts[r], starts[r] + sizes[r]))
        assert b["repeat_rows"] == mine + mine  # both copies of a sample stay on its rank
        assert b["replicated"] == [[0.0] * 4, [[1.0, 1.0], [1.0, 1.0]]]


TINY = [
    "target=dw_shift", "solver=basic_dis", "train_steps=3", "train_batch_size=16",
    "train_timesteps.steps=8", "eval_batch_size=32", "eval_interval=1000", "eval_init=False",
    "plot_results=False", "store_last_ckpt=False", "~eval_sample_losses",
]
TWO_PHASE = ["loss.method=lv", "+loss.two_phase=True", "+loss.noise_pregen=True"]


def jax_draws(js, method: str):
    """The global prior samples and noise of the JAX solver's next step,
    taken from its key chain as its loss takes them."""
    _, k_loss = jax.random.split(js.train_state.key)
    k_prior, k_noise = jax.random.split(k_loss)
    x0 = js.prior.sample(k_prior, (js.train_batch_size,))
    ts = js.train_ts
    if method == "lv":  # the two-phase loss's pregenerated noise
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, ts, x0)
    else:  # the kl scan's per-step splits
        key, steps = k_noise, []
        for k in range(ts.shape[0] - 1):
            key, k_db, _, _ = jax.random.split(key, 4)
            steps.append(jax.random.normal(k_db, x0.shape, x0.dtype) * jnp.sqrt(ts[k + 1] - ts[k]))
        dbs = jnp.stack(steps)
    return np.array(x0), np.array(dbs)


@pytest.mark.parametrize("variant", ["kl", "two_phase_lv"])
def test_three_steps_at_two_ranks_match_jax_eight_devices(variant, tmp_path):
    """basic_dis on dw_shift (tests/test_solvers.py:91, and the two-phase
    variant of tests/test_two_phase.py:163): the port's two ranks on the JAX
    draws and initial parameters against the JAX 8-device mesh."""
    from sde_sampler_tpu.utils.config import compose, locate

    extra = TWO_PHASE if variant == "two_phase_lv" else []
    cfg = compose(entry.CONF_DIR, "base", TINY + extra + ["n_devices=8", f"out_dir={tmp_path}/jax"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    assert js.mesh is not None and js.mesh.size == 8
    j_params = jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"])
    draws, j_losses, j_max_grads = [], [], []
    for _ in range(3):
        draws.append(jax_draws(js, "lv" if extra else "kl"))
        j_metrics = js.step()
        j_losses.append(float(j_metrics["train/loss"]))
        j_max_grads.append(float(j_metrics["train/max_grad"]))

    overrides = TINY + extra + ["device=cpu", "n_devices=2", f"out_dir={tmp_path}/port"]
    got = mesh.spawn(ranks.optimizer_steps, 2, "cpu", args=(overrides, j_params, draws))
    np.testing.assert_allclose(got[0]["losses"], j_losses, rtol=1e-4, atol=1e-5)
    one = ranks.optimizer_steps(0, TINY + extra + ["device=cpu", f"out_dir={tmp_path}/one"],
                                j_params, draws)
    np.testing.assert_allclose(got[0]["max_grads"], one["max_grads"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["max_grads"], j_max_grads, rtol=1e-3)
    assert got[0]["digest"] == got[1]["digest"]  # the ranks' parameters, bit for bit
    assert got[0]["losses"] == got[1]["losses"] and got[0]["max_grads"] == got[1]["max_grads"]
    assert got[0]["n_updates"] == 3 and got[0]["n_filtered"] == 0


def test_two_ranks_match_one_rank_through_the_entry_point(tmp_path):
    """One seed at n_devices=2 and n_devices=1: funnel DIS (three steps,
    the evaluation's log Z estimators, ESS and Sinkhorn); the losses of a
    Bridge trained with Hutchinson probes and of lv_traj with two copies a
    sample and an exploring sde control (the draws of each, and a sample's
    copies on one rank); the Langevin solver under Euler, Heun, the adjoint
    Euler (its Brownian tree) and adaptive Heun (the tree and the global
    error): the burn-in expectations."""
    train = ["device=cpu", "plot_results=False", "train_steps=3", "train_batch_size=16",
             "train_timesteps.steps=8", "log_interval=1", "eval_batch_size=64",
             "eval_init=False", "target.n_reference_samples=1000", "wandb.mode=disabled"]
    langevin = ["target=gmm", "solver=langevin", "device=cpu", "plot_results=False",
                "eval_batch_size=64", "sde.terminal_t=0.5", "eval_timesteps.steps=20",
                "eval_expectation_burn=10", "target.n_reference_samples=1000",
                "wandb.mode=disabled"]
    trained = [["target=funnel", "solver=dis", "loss.method=lv", *train],
               ["target=gmm", "solver=bridge", "loss.div_estimator=rademacher", *train],
               ["target=funnel", "solver=dis", "loss.method=lv_traj", "loss.traj_per_sample=2",
                "loss.sde_ctrl_noise=0.1", "loss.sde_ctrl_dropout=0.5", *train]]
    jobs = trained + [langevin + [f"integrator={name}"]
                      for name in ("euler", "heun", "euler_adjoint", "torchsde_heun")]
    two = mesh.spawn(ranks.entry_runs, 2, "cpu", args=(
        [job + ["n_devices=2", f"out_dir={tmp_path}/two{i}"] for i, job in enumerate(jobs)],))
    one = [entry.main(job + [f"out_dir={tmp_path}/one{i}"]) for i, job in enumerate(jobs)]

    for i in range(len(trained)):
        assert two[0][i]["digest"] == two[1][i]["digest"] != ""
        lines = [json.loads(line) for line in
                 (tmp_path / f"one{i}" / "metrics.jsonl").read_text().splitlines()]
        losses_one = [l["train/loss"] for l in lines if "train/loss" in l]
        max_grads_one = [l["train/max_grad"] for l in lines if "train/max_grad" in l]
        assert len(two[0][i]["losses"]) == 3 and len(two[0][i]["max_grads"]) == 3
        np.testing.assert_allclose(two[0][i]["losses"], losses_one, rtol=1e-5)
        np.testing.assert_allclose(two[0][i]["max_grads"], max_grads_one, rtol=1e-5)
    dis_two, dis_one = two[0][0], one[0]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size", "error/sinkhorn"):
        assert math.isfinite(dis_two["final"][key]), key
        assert dis_two["final"][key] == pytest.approx(dis_one.last_metrics[key], rel=1e-5,
                                                      abs=1e-5), key
    for run_two, run_one in zip(two[0][len(trained):], one[len(trained):]):
        direct = {k: v for k, v in run_one.last_metrics.items() if k.endswith("_direct")}
        assert direct and all(math.isfinite(v) for v in direct.values())
        for k, v in direct.items():
            assert run_two["final"][k] == pytest.approx(v, rel=1e-6, abs=1e-7), k


def test_n_devices_without_a_group_raises(tmp_path):
    """No silent single-device run: n_devices=2 in a process with no group
    names the entry point that starts one; fewer rows than ranks raise."""
    with pytest.raises(RuntimeError, match="python -m sde_sampler_torch.main"):
        entry.make_solver(TINY + ["device=cpu", "n_devices=2", f"out_dir={tmp_path}"])
    assert mesh.get_group(1) is None and mesh.get_group(None) is None
    with pytest.raises(ValueError, match="cannot be split"):
        mesh.block(2, 0, 3)
    assert mesh.block_sizes(100, 3) == [34, 33, 33]


def test_slurm_job_of_two_ranks_asks_for_two_cards(tmp_path):
    """A Slurm job of n_devices=2 is one task with two cards; a CPU job or
    a one-device job asks for none."""
    launcher = SlurmLauncher(submit=False, sbatch_dir=str(tmp_path))
    launcher.run([["target=funnel", "n_devices=2"], ["target=funnel", "n_devices=2", "device=cpu"],
                  ["target=funnel"]])
    scripts = [(tmp_path / f"job_{i}.sh").read_text() for i in range(3)]
    assert "#SBATCH --ntasks=1" in scripts[0] and "#SBATCH --gpus-per-task=2" in scripts[0]
    assert "--gpus-per-task" not in scripts[1] and "--gpus-per-task" not in scripts[2]
