"""The host-side knobs of the port's solvers vs the JAX package, on the CPU:
the setup hooks (`conf/utils/debug.yaml`), `params_file` warm starts, the
model watcher (`conf/utils/model_watcher.yaml`) and `eval_stddev_steps`.

- Setup hooks: `enable_debug_nans` turns on torch's autograd anomaly
  detection where the JAX package turns on `jax_debug_nans`; `disable_jit`
  has nothing to disable in eager torch.
- `params_file`: a reference-shaped torch checkpoint, converted by the JAX
  package's `scripts/import_torch_ckpt.py`, warm-starts both solvers with
  the same values (bitwise, and the checkpoint's own); a tree of some of a
  solver's controls replaces those alone; a module the solver lacks, a
  shape that differs and a pickle whose unpickling would import JAX are
  refused.
- The model watcher: per-module L2 norms of the gradients and parameters
  of one DIS step from the same parameters and inputs, to 1e-5 relative
  (float32 sums in another order); thinned to the steps `log_freq`
  divides in `metrics.jsonl`.
- `eval_stddev_steps`: the variances (ddof = 1, logged under `*_stddev_*`
  keys as the JAX package and the reference log them) of the loss and
  of each gradient element over draws of the JAX key chain: the loss's
  to 1e-4 relative, the gradients' mean and max to 1e-3 (variances of
  gradients that agree to 1e-4 relative).
"""
import json
import math
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.utils.config import compose, locate
from sde_sampler_torch import main as entry
from sde_sampler_torch.utils import debug
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params, load_params_file
from sde_sampler_torch.utils.watch import ModelWatcher

REPO = Path(__file__).parents[1]
B, STEPS = 16, 6


def tiny(solver="dis", *extra):
    return [
        "target=funnel", f"solver={solver}", f"train_batch_size={B}",
        f"train_timesteps.steps={STEPS}", "plot_results=False", "eval_init=False",
        "store_last_ckpt=False", "target.n_reference_samples=1000", "n_devices=1",
        "train_steps=10", "loss.scan_unroll=1", *extra,
    ] + (["loss.method=lv"] if solver == "dis" else [])


def solvers(tmp_path, *extra, solver="dis"):
    args = tiny(solver, *extra)
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    return js, ps


def carry(js, ps):
    """The JAX solver's parameters into the port's, EMA shadow included."""
    for name, tree in js.train_state.params.items():
        load_flax_params(ps.modules[name], jax.tree_util.tree_map(np.asarray, tree))
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)


def jax_draws(js, key, n):
    """The prior samples and noise of n draws of `key`'s chain, as the JAX
    loss draws them from each split."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        k_prior, k_noise = jax.random.split(sub)
        x0 = js.prior.sample(k_prior, (B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        out.append((torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(dbs))))
    return out


def test_setup_hooks_set_the_debug_modes(tmp_path):
    try:
        js, ps = solvers(tmp_path, "+utils@setup=debug")
        assert jax.config.jax_debug_nans is True
        assert torch.is_anomaly_enabled()
        debug.disable_jit()  # a documented no-op
        debug.enable_debug_nans(False)
        assert not torch.is_anomaly_enabled()
        assert ps.cfg["setup"][0]["_target_"].endswith("utils.debug.enable_debug_nans")
    finally:
        jax.config.update("jax_debug_nans", False)
        torch.autograd.set_detect_anomaly(False)


def reference_checkpoint(tmp_path, ps):
    """A reference-shaped torch checkpoint of the port's generative control
    (the reference's module names are the port's), converted by the JAX
    package's import script into a params pickle."""
    state = {k: v.detach().clone() + 0.01 * torch.arange(v.numel()).reshape(v.shape) / v.numel()
             for k, v in ps.generative_ctrl.state_dict().items()}
    ckpt = tmp_path / "ref_ckpt.pt"
    torch.save({"generative_ctrl": state, "n_steps": 7}, ckpt)
    out = tmp_path / "converted.pkl"
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "import_torch_ckpt.py"),
                          str(ckpt), str(out)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    return state, out


def test_params_file_warm_start_matches_jax(tmp_path):
    ps0 = entry.make_solver(tiny() + ["device=cpu", f"out_dir={tmp_path / 'p0'}"])
    state, pkl = reference_checkpoint(tmp_path, ps0)
    js, ps = solvers(tmp_path, f"params_file={pkl}")
    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    for name, value in ps.generative_ctrl.state_dict().items():
        assert torch.equal(value, want[name]), name
        assert torch.equal(value, state[name]), name
    for p, shadow in zip(ps.params, ps.ema_params):
        assert torch.equal(p, shadow)
    assert math.isfinite(float(ps.step()["train/loss"]))


def test_params_file_replaces_the_controls_it_holds(tmp_path):
    """A Bridge with an inference control, warm-started from a tree of its
    generative control alone: the inference control keeps its init."""
    fresh = entry.make_solver(tiny("bridge_diff_init", "target=gmm")
                              + ["device=cpu", f"out_dir={tmp_path / 'fresh'}"])
    state, pkl = reference_checkpoint(tmp_path, fresh)
    ps = entry.make_solver(tiny("bridge_diff_init", "target=gmm", f"params_file={pkl}")
                           + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    for name, value in ps.generative_ctrl.state_dict().items():
        assert torch.equal(value, state[name]), name
    for (name, a), b in zip(ps.inference_ctrl.state_dict().items(),
                            fresh.inference_ctrl.state_dict().values()):
        assert torch.equal(a, b), name


def test_params_file_refusals(tmp_path):
    ps0 = entry.make_solver(tiny() + ["device=cpu", f"out_dir={tmp_path / 'p0'}"])
    _, pkl = reference_checkpoint(tmp_path, ps0)
    tree = load_params_file(pkl)
    unknown = tmp_path / "unknown.pkl"
    unknown.write_bytes(pickle.dumps({**tree, "other_ctrl": tree["generative_ctrl"]}))
    with pytest.raises(ValueError, match="other_ctrl"):
        entry.make_solver(tiny("dis", f"params_file={unknown}")
                          + ["device=cpu", f"out_dir={tmp_path / 'a'}"])
    tree["generative_ctrl"]["base_model"]["out"]["bias"] = np.zeros(3, np.float32)
    shape = tmp_path / "shape.pkl"
    shape.write_bytes(pickle.dumps(tree))
    with pytest.raises(ValueError, match="does not match the model architecture"):
        entry.make_solver(tiny("dis", f"params_file={shape}")
                          + ["device=cpu", f"out_dir={tmp_path / 'b'}"])
    # jax arrays: their unpickling would import jax
    with_jax = tmp_path / "jax.pkl"
    with_jax.write_bytes(pickle.dumps({"generative_ctrl": {"w": jnp.zeros(2)}}))
    with pytest.raises(pickle.UnpicklingError, match="would import jax"):
        load_params_file(with_jax)
    with pytest.raises(pickle.UnpicklingError, match="would import jax"):
        entry.make_solver(tiny("dis", f"params_file={with_jax}")
                          + ["device=cpu", f"out_dir={tmp_path / 'c'}"])


def test_model_watcher_matches_jax(tmp_path):
    js, ps = solvers(tmp_path, "+utils@model_watcher=model_watcher", "+model_watcher.log=all")
    assert isinstance(ps.model_watcher, ModelWatcher)
    assert (ps.model_watcher.log, ps.model_watcher.log_freq) == ("all", js.model_watcher.log_freq)
    carry(js, ps)
    (x0, dbs), = jax_draws(js, js.train_state.key, 1)
    j_metrics = js.step()
    metrics = ps.step(x0=x0, dbs=dbs)
    keys = sorted(k for k in j_metrics if k.startswith("watch/"))
    assert keys == sorted(k for k in metrics if k.startswith("watch/")) == [
        "watch/grad_norm/generative_ctrl", "watch/param_norm/generative_ctrl"]
    for key in keys:
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]), rel=1e-5), key


def test_model_watcher_thins_to_its_log_freq(tmp_path):
    out = tmp_path / "run"
    entry.main(tiny("dis", "+utils@model_watcher=model_watcher", "model_watcher.log_freq=2",
                    "train_steps=3", "log_interval=1", "eval_batch_size=64")
               + ["device=cpu", f"out_dir={out}"])
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    steps = {l["train/step"]: l for l in lines if "train/loss" in l}
    assert sorted(steps) == [1, 2, 3]
    assert [any(k.startswith("watch/grad_norm") for k in steps[s]) for s in (1, 2, 3)] == [
        False, True, False]
    assert math.isfinite(steps[2]["watch/grad_norm/generative_ctrl"])


def test_eval_stddev_steps_match_jax(tmp_path):
    js, ps = solvers(tmp_path, "eval_stddev_steps=3")
    carry(js, ps)
    draws = iter(jax_draws(js, js.key, 3))  # the keys loss_and_grad_var splits off
    want = js.loss_and_grad_var()
    compute_loss = ps.compute_loss
    ps.compute_loss = lambda clips, x0=None, dbs=None: compute_loss(clips, *next(draws))
    got = ps.loss_and_grad_var()
    assert sorted(got) == sorted(want) == [
        "eval/grad_stddev_max", "eval/grad_stddev_mean", "eval/loss_stddev"]
    assert got["eval/loss_stddev"] == pytest.approx(want["eval/loss_stddev"], rel=1e-4)
    for key in ("eval/grad_stddev_mean", "eval/grad_stddev_max"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    assert all(p.grad is None for p in ps.params)


def test_eval_stddev_steps_join_the_evaluation(tmp_path):
    out = tmp_path / "run"
    solver = entry.main(tiny("dis", "eval_stddev_steps=2", "train_steps=2", "eval_batch_size=64")
                        + ["device=cpu", f"out_dir={out}"])
    final = solver.last_metrics
    for key in ("eval/loss_stddev", "eval/grad_stddev_mean", "eval/grad_stddev_max"):
        assert math.isfinite(final[key]) and final[key] >= 0.0, key
