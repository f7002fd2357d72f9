"""Trainer and entry point of the port vs the JAX package.

Three optimizer steps of the port's Bridge (DIS, funnel, two-phase LV,
Adam with L2 decay, grad clip, StepLR, EMA, scheduled clips) against the
JAX train step from the same initial parameters, with the prior samples
and noise taken from JAX's own key chain. Losses agree to 1e-5 relative.
Parameters after three Adam steps agree to 5e-5 absolute, 1% of one step:
Adam normalises each update to about lr = 5e-3, so for the rare element
whose gradient is near its own rounding error the update itself depends
on the rounding (one element of 38859 moved by 1.4e-5 here).
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
TINY = [
    "target=funnel", "solver=dis", "loss.method=lv", f"train_batch_size={B}",
    f"train_timesteps.steps={STEPS}", "plot_results=False", "eval_init=False",
    "store_last_ckpt=False", "target.n_reference_samples=1000", "n_devices=1",
    "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
]


def jax_solver(out_dir):
    from sde_sampler_tpu.utils.config import compose, locate

    cfg = compose(REPO / "conf", "base", TINY + ["train_steps=10", f"out_dir={out_dir}"])
    return locate(cfg["solver"]["_target_"])(cfg)


def test_three_optimizer_steps_match_jax(tmp_path):
    js = jax_solver(tmp_path / "jax")
    ps = entry.make_solver(TINY + ["train_steps=10", "device=cpu", f"out_dir={tmp_path / 'port'}"])
    j_params = jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"])
    load_flax_params(ps.generative_ctrl, j_params)
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)

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

    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    for name, value in ps.generative_ctrl.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=5e-5, rtol=0,
                                   err_msg=name)
    assert ps.n_steps == 3 and ps.n_updates == 3 and ps.n_steps_skip == 0


def test_entry_point_cpu_run_writes_finite_metrics_and_resumes(tmp_path):
    out = tmp_path / "run"
    args = TINY + ["train_steps=3", "eval_batch_size=64", "device=cpu",
                   "store_last_ckpt=True", f"out_dir={out}"]
    args.remove("store_last_ckpt=False")
    solver = entry.main(args)
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size",
                "error/sinkhorn"):
        assert math.isfinite(final[key]), key
    assert any(math.isfinite(l.get("train/loss", math.nan)) for l in lines)
    assert (out / "ckpt" / "ckpt_final.pt").exists()

    # a new solver on the same out_dir resumes from the latest checkpoint
    resumed = entry.make_solver(args)
    resumed.setup()
    assert resumed.n_steps == 3 and resumed.n_updates == solver.n_updates
    for a, b in zip(resumed.params, solver.params):
        assert torch.equal(a, b)
    fresh = torch.Generator().manual_seed(int(solver.cfg["seed"])).get_state()
    assert not torch.equal(resumed.generator.get_state(), fresh)


def test_entry_point_without_device_cpu_does_not_run_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="No CUDA device"):
        entry.main(TINY + ["train_steps=1", f"out_dir={tmp_path}"])
    # with device=cpu the plots run (matplotlib is installed here)
    solver = entry.make_solver(TINY + ["plot_results=True", "device=cpu", f"out_dir={tmp_path}"])
    assert solver.plot_results and solver.device == torch.device("cpu")
