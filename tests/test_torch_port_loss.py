"""Time-reversal loss of the port vs the JAX package.

Identical parameters (weight carry), x0 and noise: the noise comes from
JAX's own `_pregen_scan_inputs(key, ts, x)`, the buffer its loss draws
inside. Loss values agree to 1e-5 relative and parameter gradients to
1e-4 relative of the largest gradient of each tensor: float32 on both
sides, with the T x B sums of the running cost and the Ito term taken in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.losses.oc import BaseOCLoss as JBaseOCLoss
from sde_sampler_tpu.losses.oc import TimeReversalLoss as JTimeReversalLoss
from sde_sampler_torch.losses.oc import BaseOCLoss, TimeReversalLoss
from sde_sampler_torch.utils.params import flax_to_state_dict

from test_torch_port_models import flagship_pair

D, B, T = 10, 64, 12


def setup(method, seed=0):
    j_ctrl, ctrl, params = flagship_pair()
    j_prior, j_target = j_ctrl.prior_score.__self__, j_ctrl.target_score.__self__
    prior, target = ctrl.prior_score.__self__, ctrl.target_score.__self__
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    j_loss = JTimeReversalLoss(
        generative_ctrl=None, sde=j_ctrl.sde, method=method, max_rnd=1e8,
        noise_pregen=True, scan_unroll=1,  # unrolling only slows the compile
    )
    dbs, _ = j_loss._pregen_scan_inputs(key, jnp.asarray(ts), jnp.asarray(x0))
    loss = TimeReversalLoss(generative_ctrl=None, sde=ctrl.sde, method=method, max_rnd=1e8)
    return dict(
        j_ctrl=j_ctrl, ctrl=ctrl, params=params, j_prior=j_prior, j_target=j_target,
        prior=prior, target=target, x0=x0, ts=ts, key=key, j_loss=j_loss,
        loss=loss, dbs=np.array(dbs),
    )


@pytest.mark.parametrize("method", ["lv", "kl"])
def test_train_loss_and_gradients_match_jax(method):
    """lv: the two-phase loss (phase 1 through the fused rollout's plain
    twin, phase 2 one batched control call); kl: the autograd rollout."""
    c = setup(method)

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


def test_one_diverged_trajectory_poisons_the_gradient_on_both_sides():
    """A trajectory whose state overflows (the funnel's exp(-x_0) at
    x_0 = -200) is filtered out of the loss value, but phase 2 still runs the
    control net on its non-finite states, and 0 * inf in the backward pass
    makes every gradient non-finite: the trainer's guard then skips the
    step. The port shares this with the JAX package; the loss values agree
    to 1e-5 relative."""
    c = setup("lv")
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


def test_eval_estimators_match_jax():
    c = setup("lv", seed=1)
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


def test_compute_results_arrays_matches_jax_with_diverged_samples():
    rng = np.random.default_rng(5)
    rnd = rng.normal(size=(200, 1)).astype(np.float32) * 3.0
    rnd_no_ito = rnd + rng.normal(size=(200, 1)).astype(np.float32)
    rnd[3], rnd[17], rnd_no_ito[9] = np.inf, 5e9, np.nan
    got = BaseOCLoss.compute_results_arrays(
        torch.from_numpy(rnd), torch.from_numpy(rnd_no_ito), max_rnd=1e8)
    want = JBaseOCLoss.compute_results_arrays(
        jnp.asarray(rnd), jnp.asarray(rnd_no_ito), max_rnd=1e8)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_masked_reductions_and_noise_buffer_guard():
    loss = TimeReversalLoss(generative_ctrl=None, method="lv", max_rnd=10.0)
    rnd = torch.tensor([[1.0], [2.0], [4.0], [20.0], [float("inf")]])
    value, metrics = loss.compute_loss(rnd)
    assert float(value) == pytest.approx(float(torch.tensor([1.0, 2.0, 4.0]).var()))
    assert int(metrics["train/n_filtered"]) == 2
    # the (T, B, d) buffer has its own ceiling and raises a ValueError
    ts = torch.linspace(0, 1, 1001)
    huge = torch.empty(1).expand(2**22, 1000)
    with pytest.raises(ValueError, match="PREGEN_MAX_BYTES"):
        BaseOCLoss.draw_noise(ts, huge)
    # exploration of the sde control is accepted; its dropout needs the
    # loss's SDE for the neutral control -drift/diff
    assert TimeReversalLoss(generative_ctrl=None, method="lv", sde_ctrl_noise=0.1).explores
    with pytest.raises(ValueError, match="sde_ctrl_dropout"):
        TimeReversalLoss(generative_ctrl=None, method="lv", sde_ctrl_dropout=0.5)
    # an inference control (the Bridge) is accepted, an unknown divergence
    # estimator is not
    inference = lambda t, x: x
    assert TimeReversalLoss(generative_ctrl=None, method="lv",
                            inference_ctrl=inference).inference_ctrl is inference
    with pytest.raises(ValueError, match="div_estimator"):
        TimeReversalLoss(generative_ctrl=None, method="lv", inference_ctrl=inference,
                         div_estimator="uniform")
