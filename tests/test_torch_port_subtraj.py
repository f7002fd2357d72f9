"""SubtrajBridge and PotentialCtrl in the port vs the JAX package.

`solver=basic_dis_subtraj` (a PotentialCtrl generative control) and
`solver=basic_bridge_subtraj` (PotentialCtrl generative and inference
controls) on the grid mixture, piece by piece, on the same numpy-seeded
inputs and the JAX parameters carried across (`utils/params.py`):

- the prior's and the target's domains, and uniform samples on them;
- PotentialCtrl: Φ and σ∇ₓΦ, on rows where the clip is active and where it
  is not, to 1e-5; the parameter gradient of a sum of σ∇ₓΦ (second order)
  and of its exact divergence (third order, forward over reverse), to 1e-4
  of each tensor's largest JAX gradient plus 1e-6 of the control's largest
  (`assert_module_grads_match`), the former also against double backward
  in torch; the values under `torch.no_grad`;
- kernel 1's potential form: the plain twin against the JAX kernel
  `fused_sim_rollout` over `PotentialCtrl.__call__` (its `jax.grad` traces
  in interpret mode) and its scan, atol 2e-5 + rtol 1e-5 as
  tests/test_torch_port_rollout.py;
- the subtrajectory loss and its gradients on JAX's uniform samples and
  noise, for windows that start at 0, lie in the middle, end at T (the
  clipped target as terminal density, as `fix_terminal` makes every window)
  or not (the detached potential), and whose power-of-two bucket the JAX
  package clamps at the grid's end: the port runs the window exactly and is
  held against JAX's bucketed loss and its full clipped grid
  (`bucket_subtraj=False`), loss to 1e-5 relative, gradients as above;
- the host-side draws (coin, idx_init, idx_end) against JAX's;
- the weight carry of a JAX tree of one or two potential nets (Φ to 1e-5);
- four optimizer steps of each solver, both branches, parameters to 5e-5
  as tests/test_torch_port_bridge.py (save the Adam rule for elements whose
  gradient lay near its rounding level or vanishes, as the potential's
  out_layer bias does), losses and max gradients to 1e-4;
- CPU runs of the entry point, as tests/test_solvers.py:176-203.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.base import sample_uniform as j_sample_uniform
from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.losses.oc import divx_exact as j_divx_exact
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.reparam import PotentialCtrl as JPotentialCtrl
from sde_sampler_tpu.utils.config import compose, locate
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.base import sample_uniform
from sde_sampler_torch.distr.gauss import GMM, IsotropicGauss
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.losses.oc import divx_exact
from sde_sampler_torch.models.mlp import FourierMLP
from sde_sampler_torch.models.reparam import PotentialCtrl
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params, load_solver_params

from test_torch_port_rollout import jax_rollouts

REPO = Path(__file__).parents[1]
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
NETS = dict(num_layers=4, channels=16)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def perturb(params, scale=0.05, seed=1):
    """The JAX tree with every leaf perturbed (the configs zero the last
    layers, which would hide them from the comparisons)."""
    return jax.tree_util.tree_map(
        lambda a: a + scale * jax.random.normal(jax.random.PRNGKey(seed), a.shape), params)


def assert_module_grads_match(module, j_grads, rel=1e-4, floor=1e-6):
    """Port gradients against the JAX tree: atol `rel` times each tensor's
    largest JAX gradient plus `floor` times the module's largest (a tensor
    whose gradient vanishes, as the out_layer bias of a potential that
    enters only through ∇ₓΦ and a density's constant, holds rounding
    noise on the JAX side and 0 or noise on the port's)."""
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_grads))
    top = max(float(w.abs().max()) for w in want.values())
    for name, p in module.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        tol = rel * float(want[name].abs().max()) + floor * top
        np.testing.assert_allclose(got, want[name].numpy(), atol=tol, rtol=0.0, err_msg=name)


def test_domains_and_uniform_samples():
    """The truncated prior and the grid mixture have JAX's domain boxes;
    uniform samples fill the box they are given, lerped as SubtrajBridge
    lerps the prior's toward the target's."""
    pairs = ((JIsoGauss(dim=2, truncate_quartile=1e-4), IsotropicGauss(dim=2, truncate_quartile=1e-4)),
             (JIsoGauss(dim=2), IsotropicGauss(dim=2)), (JGMM(name="grid"), GMM(name="grid")))
    for j_distr, distr in pairs:
        np.testing.assert_allclose(distr.domain.numpy(), np.asarray(j_distr.domain), rtol=1e-6)
    prior, target = pairs[0][1].domain, pairs[2][1].domain
    domain = prior + (target - prior) * 0.25
    x = sample_uniform(domain, 20000, generator=torch.Generator().manual_seed(0))
    j_x = np.asarray(j_sample_uniform(jax.random.PRNGKey(0), jnp.asarray(domain.numpy()), 20000))
    for sample in (x.numpy(), j_x):
        assert sample.shape == (20000, 2)
        assert (sample >= domain[:, 0].numpy()).all() and (sample <= domain[:, 1].numpy()).all()
        np.testing.assert_allclose(sample.mean(0), domain.mean(1).numpy(), atol=0.1)


# ---------------------------------------------------------------------------
# PotentialCtrl
# ---------------------------------------------------------------------------


def potential_pair(d, scale=0.3):
    """A PotentialCtrl on VP in both packages with a perturbed JAX init."""
    j_ctrl = JPotentialCtrl(base_model=JFourierMLP(dim=d, dim_out=1, **NETS), clip_model=10.0,
                            sde=JVP(**VP_KW))
    ctrl = PotentialCtrl(base_model=FourierMLP(dim=d, dim_out=1, **NETS), clip_model=10.0,
                         sde=VP(**VP_KW))
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)),
                         method="unnorm_log_prob")["params"]
    params = perturb(params, scale)
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params


def median_clip(j_ctrl, params, t, x):
    """A clip_model at the median |Φ| of these rows: about half clip."""
    phi = j_ctrl.apply({"params": params}, jnp.float32(t), jnp.asarray(x),
                       method="unnorm_log_prob")
    return float(np.median(np.abs(np.asarray(phi))))


@pytest.mark.parametrize("clipped", [False, True])
def test_potential_ctrl_value_and_gradients_match_jax(clipped):
    d, t = 3, 0.37
    j_ctrl, ctrl, params = potential_pair(d)
    x = (np.random.default_rng(0).normal(size=(40, d)) * 2).astype(np.float32)
    clips = {"clip_model": median_clip(j_ctrl, params, t, x)} if clipped else None
    apply = lambda p, tt, xx, **kw: j_ctrl.apply({"params": p}, tt, xx, clips=clips, **kw)
    j_phi = apply(params, jnp.float32(t), jnp.asarray(x), method="unnorm_log_prob")
    j_u = apply(params, jnp.float32(t), jnp.asarray(x))
    if clipped:
        raw = j_ctrl.apply({"params": params}, jnp.float32(t), jnp.asarray(x),
                           method="unnorm_log_prob")
        active = np.abs(np.asarray(raw)[:, 0]) > clips["clip_model"]
        assert 10 <= active.sum() <= 30
        assert (np.asarray(j_u)[active] == 0).all()
    phi = ctrl.unnorm_log_prob(torch.tensor(t), t_(x), clips=clips)
    u = ctrl(torch.tensor(t), t_(x), clips=clips)
    np.testing.assert_allclose(phi.detach().numpy(), np.asarray(j_phi), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(j_u), rtol=1e-5, atol=1e-5)

    # second order: the parameter gradient of a weighted sum of σ∇ₓΦ
    w = np.random.default_rng(1).normal(size=(40, d)).astype(np.float32)
    j_grads = jax.jit(jax.grad(
        lambda p: (apply(p, jnp.float32(t), jnp.asarray(x)) * w).sum()))(params)
    (u * t_(w)).sum().backward()
    assert_module_grads_match(ctrl, j_grads)
    got = {n: p.grad.clone() for n, p in ctrl.named_parameters() if p.grad is not None}
    ctrl.zero_grad(set_to_none=True)
    # ... and by double backward in torch
    xx = t_(x).requires_grad_(True)
    (g,) = torch.autograd.grad(ctrl.unnorm_log_prob(torch.tensor(t), xx, clips=clips).sum(), xx,
                               create_graph=True)
    (ctrl.sde.diff(torch.tensor(t), xx) * g * t_(w)).sum().backward()
    for name, p in ctrl.named_parameters():
        if name in got:
            torch.testing.assert_close(got[name], p.grad, rtol=1e-5, atol=1e-6)
    ctrl.zero_grad(set_to_none=True)

    # third order: the exact divergence (forward over reverse) and its gradient
    fn = lambda p: lambda tt, xx: apply(p, tt, xx)
    j_div = j_divx_exact(fn(params), jnp.float32(t), jnp.asarray(x))[0]
    j_grads = jax.jit(jax.grad(
        lambda p: j_divx_exact(fn(p), jnp.float32(t), jnp.asarray(x))[0].sum()))(params)
    div, value = divx_exact(lambda tt, xx: ctrl(tt, xx, clips=clips), torch.tensor(t), t_(x))
    np.testing.assert_allclose(div.detach().numpy(), np.asarray(j_div), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(value, u)
    div.sum().backward()
    assert_module_grads_match(ctrl, j_grads)
    # the evaluation's rollout runs them under torch.no_grad
    with torch.no_grad():
        u_ng = ctrl(torch.tensor(t), t_(x), clips=clips)
        div_ng, _ = divx_exact(lambda tt, xx: ctrl(tt, xx, clips=clips), torch.tensor(t), t_(x))
    assert torch.equal(u_ng, u.detach()) and torch.equal(div_ng, div.detach())


@pytest.mark.parametrize("d,clipped", [(2, False), (2, True), (5, True), (50, True)])
def test_potential_plain_rollout_matches_jax_kernel_and_scan(d, clipped):
    """The plain twin of kernel 1's potential form (the net's hand-written
    backward pass, no autograd) against the JAX Pallas kernel (interpret
    mode) and its scan, both over PotentialCtrl.__call__ and its jax.grad;
    d = 50 is mw_50d's, the card's generic body."""
    j_ctrl, ctrl, params = potential_pair(d, scale=0.1)
    rng = np.random.default_rng(d)
    B, T = 32, 12
    x0 = (rng.normal(size=(B, d)) * 2).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, B, d)) * np.sqrt(np.diff(ts))[:, None, None]).astype(np.float32)
    clips = {"clip_model": median_clip(j_ctrl, params, 0.0, x0)} if clipped else None
    wants = jax_rollouts(j_ctrl, params, x0, ts, dbs, clips)
    xs, x_T = ro.fused_rollout(ctrl, t_(x0), t_(ts), t_(dbs), clips)
    assert torch.equal(xs[0], t_(x0)) and bool(torch.isfinite(xs).all())
    for want_xs, want_xT in wants:
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(x_T.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def test_potential_form_resolves_and_raises_on_other_nets():
    _, ctrl, _ = potential_pair(2)
    form, sde, prior, kind, target = ro.kernel_instance(ctrl)
    assert (form, kind, prior, target) == ("potential", "none", None, None)
    assert sde is ctrl.sde and ro.FORM_CODES[form] == 5
    x0, ts, dbs = torch.zeros(4, 2), torch.linspace(0, 1, 3), torch.zeros(2, 4, 2)
    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
        ro.fused_rollout_exp(ctrl, x0, ts, dbs, 1.0, 1.0)
    wide = PotentialCtrl(base_model=FourierMLP(dim=2, **NETS), sde=VP(**VP_KW))
    with pytest.raises(NotImplementedError, match="one output"):
        ro.fused_rollout(wide, x0, ts, dbs)
    relu = PotentialCtrl(base_model=FourierMLP(dim=2, dim_out=1, activation="relu"), sde=VP())
    with pytest.raises(NotImplementedError, match="GELU FourierMLP"):
        ro.fused_rollout(relu, x0, ts, dbs)
    with pytest.raises(ValueError, match="net takes dimension 2"):
        ro.fused_rollout(ctrl, torch.zeros(4, 3), ts, torch.zeros(2, 4, 3))


# ---------------------------------------------------------------------------
# the subtrajectory loss
# ---------------------------------------------------------------------------

S_B, S_STEPS = 16, 8  # 9 grid points


def tiny(solver):
    nets = ["generative_ctrl"] + (["inference_ctrl"] if "bridge" in solver else [])
    return [f"{net}.base_model.channels=16" for net in nets] + [
        "target=gmm", f"solver={solver}", f"train_batch_size={S_B}",
        f"train_timesteps.steps={S_STEPS}", "plot_results=False", "eval_init=False",
        "store_last_ckpt=False", "n_devices=1", "target.n_reference_samples=1000",
        "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
    ]


def solver_pair(solver, tmp_path, extra=(), perturbed=True):
    """The JAX solver and the port's from one config, with the same
    (perturbed) parameters and EMA shadows."""
    args = tiny(solver) + list(extra)
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    if perturbed:
        params = perturb(js.train_state.params)
        ema = js.train_state.ema_params
        js.train_state = js.train_state.replace(
            params=params,
            ema_params=None if ema is None else jax.tree_util.tree_map(jnp.copy, params))
    load_solver_params(ps.modules, jax.tree_util.tree_map(np.asarray, js.train_state.params))
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params or (), ps.params):
            shadow.copy_(p)
    return js, ps


def jax_window_inputs(js, key, idx_init, idx_end, bucket_len):
    """JAX's uniform samples and the noise of the window's live steps, as
    `compute_subtraj_loss_traced` draws them from `key`."""
    ts = js.train_ts
    n = ts.shape[0]
    k_unif, k_loss = jax.random.split(key)
    domain = js.target.domain
    if js.lerp_domain:
        domain = js.prior.domain + (domain - js.prior.domain) * (ts[idx_init] / js.sde.terminal_t)
    x = j_sample_uniform(k_unif, domain, batchsize=js.train_batch_size)
    if bucket_len is not None and bucket_len < n:
        start = min(idx_init, n - bucket_len)  # dynamic_slice's clamp
        sub_ts = jnp.clip(ts[start : start + bucket_len], ts[idx_init], ts[idx_end])
    else:
        sub_ts = jnp.clip(ts, ts[idx_init], ts[idx_end])
    dbs, _ = js.loss._pregen_scan_inputs(k_loss, sub_ts, x)
    live = np.asarray(sub_ts[1:] > sub_ts[:-1])
    assert live.sum() == idx_end - idx_init
    return np.asarray(x), np.asarray(dbs)[live]


# (idx_init, idx_end) on the 9-point grid, and what each exercises: the
# prior at t = 0 and a detached potential at the end; potentials at both
# ends; a window that ends at T (the clipped target, as with fix_terminal)
# whose bucket of 8 would run past the grid's end, which JAX clamps
WINDOWS = {"start": (0, 3), "middle": (2, 5), "clamped.end_T": (3, 8)}


@pytest.fixture(scope="module")
def loss_setup(tmp_path_factory):
    """Per solver, one solver pair and one jitted JAX loss per bucket length
    (the window's ends are traced, as in the JAX step), shared by the
    window cases."""
    cache = {}

    def get(solver):
        if solver not in cache:
            js, ps = solver_pair(solver, tmp_path_factory.mktemp(solver))
            clips, key, fns = js.current_clips(), jax.random.PRNGKey(7), {}

            def loss_fn(bucket_len):
                if bucket_len not in fns:
                    fns[bucket_len] = jax.jit(jax.value_and_grad(
                        lambda p, i0, i1: js.compute_subtraj_loss_traced(
                            p, key, clips, i0, i1, bucket_len=bucket_len)[0]))
                return fns[bucket_len]

            cache[solver] = js, ps, key, loss_fn
        return cache[solver]

    return get


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("solver", ["basic_dis_subtraj", "basic_bridge_subtraj"])
def test_subtraj_loss_and_gradients_match_jax(loss_setup, solver, window):
    js, ps, key, loss_fn = loss_setup(solver)
    idx_init, idx_end = WINDOWS[window]
    bucket = js._bucket_len(idx_end - idx_init + 1)
    for bucket_len in {bucket, None}:  # JAX's bucket, and its full clipped grid
        j_value, j_grads = loss_fn(bucket_len)(
            js.train_state.params, jnp.asarray(idx_init), jnp.asarray(idx_end))
        x, dbs = jax_window_inputs(js, key, idx_init, idx_end, bucket_len)
        for p in ps.params:
            p.grad = None
        value, metrics = ps.compute_subtraj_loss(ps.current_clips(), idx_init, idx_end,
                                                 x0=t_(x), dbs=t_(dbs))
        value.backward()
        assert int(metrics["train/n_filtered"]) == 0
        assert float(value.detach()) == pytest.approx(float(j_value), rel=1e-5)
        for name, module in ps.modules.items():
            assert_module_grads_match(module, j_grads[name])


def test_subtraj_draws_match_jax(tmp_path, monkeypatch):
    """The coin and the window of each step, from numpy's generator at seed
    + 1 in the JAX package's order: with a fixed terminal index, a fixed
    number of steps, and both ends drawn."""
    from sde_sampler_tpu.solver import oc as j_oc

    monkeypatch.setattr(j_oc.Bridge, "step", lambda self: {"branch": None}, raising=False)
    for extra in (["fix_terminal=True"], ["fix_terminal=False", "subtraj_steps=3"],
                  ["fix_terminal=False"]):
        js, ps = solver_pair("basic_dis_subtraj", tmp_path, extra + ["seed=3"], perturbed=False)
        seen = []

        def record(bucket, seen=seen):
            def fn(state, clips, idx_init, idx_end):
                seen.append((int(idx_init), int(idx_end)))
                return state, {}
            return fn

        js._subtraj_fn = record
        want = []
        for _ in range(60):
            n_seen = len(seen)
            js.step()
            want.append(seen[-1] if len(seen) > n_seen else None)
        got = [ps.draw_window() for _ in range(60)]
        assert got == want
        assert 15 < sum(w is not None for w in got) < 45, extra


@pytest.mark.parametrize("solver", ["basic_dis_subtraj", "basic_bridge_subtraj"])
def test_four_subtraj_optimizer_steps_match_jax(tmp_path, solver):
    """Both branches on the JAX package's inputs: the whole trajectory from
    prior samples, a window from uniform samples on the lerped domain.
    Adam's rule for near-zero gradients covers one more case here: the
    potential's out_layer bias reaches the loss only as a constant of the
    initial log-density, which the variance cancels, so its gradient is
    rounding noise on the JAX side (a full Adam step of noise) and 0 on the
    port's."""
    js, ps = solver_pair(solver, tmp_path, ["train_steps=10", "seed=2"])
    # the weight carry: each control's potential from the JAX tree
    x = np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32) * 3
    for name in ps.modules:
        assert type(ps.modules[name]).__name__ == "PotentialCtrl"
        want = getattr(js, name).apply({"params": js.train_state.params[name]}, jnp.float32(0.3),
                                       jnp.asarray(x), method="unnorm_log_prob")
        got = ps.modules[name].unnorm_log_prob(torch.tensor(0.3), t_(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert set(ps.modules) == ({"generative_ctrl", "inference_ctrl"}
                               if solver == "basic_bridge_subtraj" else {"generative_ctrl"})
    params = dict(ps.modules.named_parameters())
    low = {name: np.zeros(p.shape, dtype=bool) for name, p in params.items()}
    branches = []
    for _ in range(4):
        state = ps._rng.bit_generator.state
        window = ps.draw_window()
        ps._rng.bit_generator.state = state
        branches.append(window)
        _, k_loss = jax.random.split(js.train_state.key)
        if window is None:
            k_prior, k_noise = jax.random.split(k_loss)
            x0 = js.prior.sample(k_prior, (S_B,))
            dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        else:
            bucket = js._bucket_len(window[1] - window[0] + 1)
            x0, dbs = jax_window_inputs(js, k_loss, *window, bucket)
        j_metrics = js.step()
        metrics = ps.step(x0=t_(x0), dbs=t_(dbs))
        assert float(metrics["train/loss"]) == pytest.approx(float(j_metrics["train/loss"]), rel=1e-4)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=1e-4)
        top = max(float(p.grad.abs().max()) for p in params.values())
        for name, p in params.items():
            grad = p.grad.abs().numpy()
            low[name] |= grad < max(1e-2 * grad.max(), 1e-6 * top)
    assert any(w is None for w in branches) and any(w is not None for w in branches), branches
    assert ps.windows == [w for w in branches if w is not None]
    n_off, n_all = 0, 0
    for name in ps.modules:
        want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, js.train_state.params[name]))
        for key, value in ps.modules[name].state_dict().items():
            err = np.abs(value.numpy() - want[key].numpy())
            assert err[~low[f"{name}.{key}"]].max(initial=0.0) <= 5e-5, f"{name}.{key}"
            assert err.max() <= 4 * 2 * 1e-3, f"{name}.{key}"
            n_off += int((err > 5e-5).sum())
            n_all += err.size
    assert n_off < 1e-3 * n_all
    assert ps.n_steps == 4 and ps.n_updates == 4 and ps.n_steps_skip == 0


@pytest.mark.parametrize("solver", ["dis_subtraj", "bridge_subtraj"])
def test_entry_point_cpu_subtraj_run_writes_finite_metrics(tmp_path, solver):
    """The configs themselves (clips 10, max_rnd 1e4, the VP SDE), every
    step a subtrajectory, then the final evaluation."""
    out = tmp_path / "run"
    args = tiny(solver) + ["train_steps=4", "eval_batch_size=64", "device=cpu",
                           "subtraj_prob=1.0", f"out_dir={out}"]
    solver_obj = entry.main(args)
    assert type(solver_obj).__name__ == "SubtrajBridge"
    assert len(solver_obj.windows) == 4
    n = solver_obj.train_ts.shape[0]
    for idx_init, idx_end in solver_obj.windows:
        assert 0 <= idx_init < idx_end <= n - 1
        assert idx_end == n - 1 or solver == "bridge_subtraj"  # fix_terminal
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    final = lines[-1]
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb",
                "eval/log_norm_const_lb_ito", "eval/effective_sample_size", "error/sinkhorn"):
        assert math.isfinite(final[key]), key
    assert all(math.isfinite(l["train/loss"]) for l in lines if "train/loss" in l)
    assert solver_obj.n_steps_skip == 0
