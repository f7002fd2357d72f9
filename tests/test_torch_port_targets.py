"""The mixture, double-well and multi-well paths of the port vs the JAX
package, through their solvers and the entry point.

Three optimizer steps of `target=gmm solver=dis loss.method=lv` (LerpCtrl)
and of `target=gmm solver=dis_no_score` (the score-free ClippedCtrl) against
the JAX train step, from the same parameters, prior samples and noise, at
the tolerances of tests/test_torch_port_solver.py: losses to 1e-5
relative, max gradients to 1e-4, parameters to 5e-5 absolute (1% of one
Adam step of lr 5e-3), except, as in tests/test_torch_port_dds.py, elements
whose gradient in some step was nonzero but below 1e-2 of its tensor's
largest: Adam normalises every update to about lr, so the first step of an
element whose gradient lies at the rounding level goes whichever way the
rounding says. Those are held to two steps of 2 lr, and fewer than 0.1% of
all elements may exceed 5e-5 (on the mixture under DIS, 2 of the score
net's 8192 first-layer weights moved by 6.3e-5). Then tiny CPU runs of the entry point on gmm (DIS),
dw_shift (PIS), mw (DDS) and gauss_shift (PIS without a score) write
finite log Z and, where the target can be sampled, a Sinkhorn value.
"""
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sde_sampler_torch import main as entry
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = Path(__file__).parents[1]
B, STEPS = 16, 6


def tiny(target, solver):
    args = [
        f"target={target}", f"solver={solver}", f"train_batch_size={B}",
        f"train_timesteps.steps={STEPS}", "plot_results=False", "eval_init=False",
        "store_last_ckpt=False", "n_devices=1",
        "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
    ]
    if target in ("gmm", "gauss_shift"):  # the wells integrate their statistics
        args.append("target.n_reference_samples=1000")
    if solver == "dis":
        args.insert(2, "loss.method=lv")
    return args


@pytest.mark.parametrize("solver", ["dis", "dis_no_score"])
def test_three_gmm_optimizer_steps_match_jax(tmp_path, solver):
    from sde_sampler_tpu.utils.config import compose, locate

    args = tiny("gmm", solver) + ["train_steps=10"]
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    assert type(ps.generative_ctrl).__name__ == ("LerpCtrl" if solver == "dis" else "ClippedCtrl")
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
        x0 = js.prior.sample(k_prior, (B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        j_metrics = js.step()
        metrics = ps.step(x0=torch.from_numpy(np.array(x0)), dbs=torch.from_numpy(np.array(dbs)))
        assert float(metrics["train/loss"]) == pytest.approx(
            float(j_metrics["train/loss"]), rel=1e-5)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=1e-4)
        for name, p in params.items():
            grad = p.grad.abs().numpy()
            low[name] |= (grad > 0) & (grad < 1e-2 * grad.max())

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
    "target,solver,grid",
    [("gmm", "dis", "train_timesteps.steps=16"), ("dw_shift", "pis", "train_timesteps.steps=16"),
     ("mw", "dds", "train_timesteps.dt=1.0"),
     ("gauss_shift", "pis_no_score", "train_timesteps.steps=16")],
)
def test_entry_point_cpu_run_of_each_new_target(tmp_path, target, solver, grid):
    out = tmp_path / target
    args = tiny(target, solver)
    args.remove(f"train_timesteps.steps={STEPS}")
    solver_obj = entry.main(args + [
        grid, "device=cpu", "train_steps=3", "eval_batch_size=64", f"out_dir={out}",
    ])
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size",
                "error/sinkhorn", "eval/frac_groundtruth_in_domain",
                "error/avg_marginal_stddev", "rel_error/square"):
        assert math.isfinite(final[key]), key
    assert any(math.isfinite(l.get("train/loss", math.nan)) for l in lines)
    assert math.isfinite(solver_obj.target.log_norm_const)
