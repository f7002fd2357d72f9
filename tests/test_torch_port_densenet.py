"""Kernels 1 and 2 with a DenseNet control net (`model/base@base_model=densenet`).

The JAX kernel `fused_sim_rollout` traces any step function, so it runs a
control over `conf/model/base/densenet.yaml`'s net ([200, 200], ReLU) as it
runs one over a FourierMLP; the port's kernels have a DenseNet body of their
own. On the CPU `fused_rollout` and `fused_rollout_exp` run its plain twin,
which must match the JAX kernel in interpret mode and the lax.scan reference
at B 32, T 12, with JAX's parameters (every leaf moved off its init, so that
the zeroed out layer is compared too) carried across and the same numpy
noise: the LerpCtrl on the grid mixture (d = 2), the funnel (d = 10, also
with a score net of d outputs) and mw_50d (d = 50), the PIS ScoreCtrl on the
funnel, the ClippedCtrl, the LerpTargetCtrl on the Bridge's scaled BM and the
CancelDriftCtrl of langevin_init on the mixture, and kernel 2's DDS ScoreCtrl
on the funnel's cosine grid. Float32 on both sides, the 200-wide sums in
another order: atol 2e-5 + rtol 1e-5, the tolerance of
tests/test_torch_port_rollout.py. Three DIS optimizer steps on the mixture
with the DenseNet match the JAX trainer's (losses to 1e-5 relative and the
largest gradient to 1e-4, as tests/test_torch_port_solver.py), with phase 1
on the kernel route; the parameters after them to 1e-4 absolute, 2% of one
Adam step (lr 5e-3): Adam normalises each update, so an element whose
gradient lies near its own rounding error moves by a fraction of a step
that depends on the rounding (one of the 40,600 weights of the second
hidden layer by 5.1e-5 here). The dispatch: a ReLU DenseNet has an instance
in every form but the potential one, and its launch passes the packed
weights, the t table and the widths and counts under the DenseNet keys.
The CUDA body is held against the twin in tests/test_torch_port_cuda.py.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.double_well import MultiWell as JMultiWell
from sde_sampler_tpu.distr.funnel import Funnel as JFunnel
from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.models import reparam as jreparam
from sde_sampler_tpu.models.mlp import DenseNet as JDenseNet
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.ops.rollout_pallas import (
    exp_integrator_step_fn,
    fused_sim_rollout,
    sde_step_fn,
)
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.double_well import MultiWell
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import GMM, IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.models import reparam
from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, MultilevelNet, TimeEmbed
from sde_sampler_torch.ops import build
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.utils.common import get_timesteps
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

from test_torch_port_kernel_dispatch import FakeLibrary
from test_torch_port_models import REPO

B, T = 32, 12
ARCH = (200, 200)  # conf/model/base/densenet.yaml
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
PIS_KW = dict(diff_coeff=0.4472135954999579, terminal_t=5.0)  # conf/sde/bm_pis.yaml
BRIDGE_KW = dict(diff_coeff=1.0, terminal_t=1.0)  # conf/sde/bm.yaml
ALPHA, SIGMA = 0.9, 1.1
TARGETS = {
    "gmm": lambda: (JGMM(name="grid"), GMM(name="grid"), 2),
    "funnel": lambda: (JFunnel(dim=10, n_reference_samples=100),
                       Funnel(dim=10, n_reference_samples=100), 10),
    "mw_50d": lambda: (JMultiWell(dim=50, n_double_wells=5, separation=2.0),
                       MultiWell(dim=50, n_double_wells=5, separation=2.0), 50),
}
CLASSES = {"lerp": "LerpCtrl", "score": "ScoreCtrl", "exp": "ScoreCtrl",
           "clipped": "ClippedCtrl", "lerp_target": "LerpTargetCtrl",
           "cancel_drift": "CancelDriftCtrl", "potential": "PotentialCtrl"}


def dense_pair(form, target, score_dim=False):
    """A control of `form` over densenet.yaml's net on `target`, in both
    packages, sharing a perturbed JAX init; returns (JAX control, port
    control, params, d, SDE pair)."""
    j_target, p_target, d = TARGETS[target]()
    if form == "score":
        sdes = JScaledBM(**PIS_KW), ScaledBM(**PIS_KW)
    elif form == "lerp_target":
        sdes = JScaledBM(**BRIDGE_KW), ScaledBM(**BRIDGE_KW)
    else:
        sdes = JVP(**VP_KW), VP(**VP_KW)
    net = dict(arch=ARCH, activation="relu", last_bias_init="zeros", last_weight_init="zeros")
    pair = []
    for pkg, sde, tgt, prior, dense, embed in (
            (jreparam, sdes[0], j_target, JIsoGauss(dim=d), JDenseNet, JTimeEmbed),
            (reparam, sdes[1], p_target, IsotropicGauss(dim=d), DenseNet, TimeEmbed)):
        kw = dict(base_model=dense(dim=d, **net), clip_model=10.0, sde=sde)
        if form not in ("clipped", "potential"):
            kw.update(target_score=tgt.score, clip_score=10.0, detach_score=False,
                      score_model=embed(dim_out=d if score_dim else 1, num_layers=4,
                                        last_bias_init={"constant": 1.0}))
        if form == "lerp" or (form == "lerp_target" and pkg is jreparam):
            kw["prior_score"] = prior.score
        if form == "cancel_drift":
            kw["langevin_init"] = True
        pair.append(getattr(pkg, CLASSES[form])(**kw))
    j_ctrl, ctrl = pair
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params, d, sdes


def em_inputs(d, terminal_t, scale=1.0, seed=1):
    """x0 (B, d), the last T steps of the configs' 200-step grid, and
    Brownian increments on it."""
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(B, d)) * scale).astype(np.float32)
    ts = np.linspace(terminal_t * (1 - T / 200), terminal_t, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, B, d)) * np.sqrt(np.diff(ts))[:, None, None]).astype(np.float32)
    return x0, ts, dbs


def exp_inputs(d, seed=1):
    """x0, a DDS cosine grid whose last steps have dt = 0, standard normals."""
    rng = np.random.default_rng(seed)
    ts = get_timesteps(0.0, 1.6, steps=T - 1, rescale_t="cosine").numpy()
    x0 = rng.normal(size=(B, d)).astype(np.float32)
    noise = rng.normal(size=(T, B, d)).astype(np.float32)
    return x0, ts, noise


CASES = [
    pytest.param("lerp", "gmm", False, id="lerp.gmm"),
    pytest.param("lerp", "funnel", False, id="lerp.funnel"),
    pytest.param("lerp", "funnel", True, id="lerp.funnel.dim"),
    pytest.param("lerp", "mw_50d", False, id="lerp.wells.mw_50d"),
    pytest.param("score", "funnel", False, id="score.funnel"),
    pytest.param("clipped", "gmm", False, id="clipped.none"),
    pytest.param("lerp_target", "gmm", False, id="lerp_target.gmm"),
    pytest.param("cancel_drift", "gmm", False, id="cancel_drift.gmm"),
    pytest.param("exp", "funnel", False, id="exp.funnel"),
]


@pytest.mark.parametrize("form,target,score_dim", CASES)
def test_plain_dense_rollout_matches_jax_kernel_and_scan(form, target, score_dim):
    j_ctrl, ctrl, params, d, (j_sde, sde) = dense_pair(form, target, score_dim)
    clips = {"clip_model": 5.0, "clip_score": 10.0}

    def apply_ctrl(p, s, x):
        return j_ctrl.apply({"params": p}, s, x, clips=clips)

    if form == "exp":
        x0, ts, noise = exp_inputs(d)
        step = exp_integrator_step_fn(apply_ctrl, alpha=ALPHA, sigma=SIGMA)
    else:
        x0, ts, noise = em_inputs(d, sde.terminal_t, scale=3.0 if target == "gmm" else 1.0)
        step = sde_step_fn(apply_ctrl, drift=j_sde.drift, diff=j_sde.diff)
    jx0, jts, jnoise = map(jnp.asarray, (x0, ts, noise))

    def body(x, inp):
        s, t, n = inp
        return step(params, s, t, x, n), x

    x_T, xs = jax.lax.scan(body, jx0, (jts[:-1], jts[1:], jnoise))
    wants = [fused_sim_rollout(step, params, jx0, jts, jnoise, block_b=16, interpret=True),
             (xs, x_T)]
    assert ro.phase1_route(ctrl, sde, "exp" if form == "exp" else "em",
                           sim_backend="pallas") == ("kernel", None)
    args = tuple(map(torch.from_numpy, (x0, ts, noise)))
    build.reset_launches()
    if form == "exp":
        got_xs, got_xT = ro.fused_rollout_exp(ctrl, *args, ALPHA, SIGMA, clips)
    else:
        got_xs, got_xT = ro.fused_rollout(ctrl, *args, clips,
                                          sde=sde if form == "score" else None)
    assert sum(build.LAUNCHES.values()) == 0 and build.ROUTES["route.scan"] == 0
    assert torch.equal(got_xs[0], args[0]) and bool(torch.isfinite(got_xs).all())
    for want_xs, want_xT in wants:
        np.testing.assert_allclose(got_xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got_xT.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def test_dense_time_table_and_packed_weights_give_the_nets_output():
    """The plain twin's split of the net (the t column tabulated, the rest
    packed in (in, out) layout with padded rows) gives the DenseNet's own
    output; the packed layout leaves zeros in its padding."""
    torch.manual_seed(3)
    for d, arch in ((2, ARCH), (5, (7, 13, 3)), (50, (200, 200)), (3, ())):
        net = DenseNet(dim=d, arch=arch)
        s = torch.tensor([0.25, 0.7])
        x = torch.randn(9, d)
        table = ro.dense_time_table(net, s)
        assert table.shape == (2, sum(arch) + d)
        packed = ro._dense_weights(net)[0]
        layers, total = ro.dense_layers(d, arch)
        assert packed.shape == (total,)
        assert [(K, N) for _, K, N in layers] == [
            (d + sum(arch[:l]), n) for l, n in enumerate((*arch, d))]
        for offset, K, N in layers:
            block = packed[offset : offset + K * ro._pad4(N)].view(K, ro._pad4(N))
            assert bool((block[:, N:] == 0).all())
        with torch.no_grad():
            for k in range(2):
                torch.testing.assert_close(ro._dense_out(x, table[k], packed, arch), net(s[k], x),
                                           atol=2e-6, rtol=1e-5)


def _control(form, base, d=3):
    sde = VP(**VP_KW)
    target = GMM(name="grid") if d == 2 else IsotropicGauss(dim=d, loc=1.0)
    if form in ("clipped", "potential"):
        return getattr(reparam, CLASSES[form])(base_model=base, clip_model=10.0, sde=sde)
    kw = dict(base_model=base, target_score=target.score, sde=sde, clip_model=10.0)
    if form == "lerp":
        kw["prior_score"] = IsotropicGauss(dim=d).score
    return getattr(reparam, CLASSES[form])(**kw)


def test_dense_nets_get_an_instance_in_every_form_but_the_potential_one():
    """phase1_route under sim_backend=pallas: the kernel for a ReLU DenseNet
    in every form but the potential one (and its depth and width within
    the body's); NoInstance("base_net") naming what is missing for the
    PotentialCtrl over a DenseNet, a tanh DenseNet, a DenseNet past the
    body's depth or width and a MultilevelNet, which take the scan route."""
    d = 3
    for form in ("lerp", "score", "clipped", "lerp_target", "cancel_drift", "exp"):
        ctrl = _control("score" if form == "exp" else form, DenseNet(dim=d))
        sde = None if form == "exp" else ctrl.sde
        update = "exp" if form == "exp" else "em"
        assert ro.kernel_instance(ctrl, sde, update)[0] == ("score" if form == "exp" else form)
        assert ro.phase1_route(ctrl, sde, update, sim_backend="pallas") == ("kernel", None)
        assert ro.phase1_route(ctrl, sde, update, on_card=True) == ("kernel", None)
    deep = (64,) * (ro.DENSE_MAX_LAYERS + 1)
    refused = [
        ("potential", DenseNet(dim=d, dim_out=1), "PotentialCtrl|potential form"),
        ("lerp", DenseNet(dim=d, activation="tanh"), "ReLU DenseNet"),
        ("score", DenseNet(dim=d, arch=deep), "at most"),
        ("clipped", DenseNet(dim=d, arch=(ro.DENSE_MAX_WIDTH + 1,)), "at most"),
        ("lerp", MultilevelNet(dim=d, factor=2, levels=2), "GELU FourierMLP or a ReLU DenseNet"),
        ("lerp", FourierMLP(dim=d, activation="relu"), "GELU FourierMLP or a ReLU DenseNet"),
    ]
    for form, base, match in refused:
        ctrl = _control(form, base)
        sde = ctrl.sde
        missing = ro.kernel_instance(ctrl, sde)
        assert isinstance(missing, ro.NoInstance) and missing.reason == "base_net", form
        assert ro.phase1_route(ctrl, sde) == ("scan", "base_net")
        with pytest.raises(NotImplementedError, match=match):
            ro.phase1_route(ctrl, sde, sim_backend="pallas")
    # the widest and deepest the body takes
    edge = DenseNet(dim=d, arch=(ro.DENSE_MAX_WIDTH,) * ro.DENSE_MAX_LAYERS)
    assert ro.phase1_route(_control("lerp", edge), None, sim_backend="pallas")[0] == "kernel"


@pytest.fixture
def fake_library(monkeypatch):
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


@pytest.mark.parametrize("reported", ["dense", "dense_streamed"])
@pytest.mark.parametrize("form", ["lerp", "exp"])
def test_dense_launch_passes_its_net_and_counts_under_its_keys(fake_library, form, reported):
    """A DenseNet's launch passes net 1, its hidden layers as H, their
    widths, its packed weights as w_in and its t table as temb, and counts
    under "<kernel>.<form>.<target>.dense" (the streamed ones also under
    "<kernel>.<form>.dense.streamed"), never under the FourierMLP's key."""
    fake_library.body = reported
    d, arch = 2, (12, 20, 8)
    ctrl = _control("lerp" if form == "lerp" else "score", DenseNet(dim=d, arch=arch), d=d)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32))
    ts = torch.linspace(0.0, 1.0, 5)
    noise = torch.from_numpy(rng.normal(size=(4, 5, d)).astype(np.float32))
    prepared = (ro._prepare(ctrl, x0, ts, noise, None) if form == "lerp"
                else ro._prepare(ctrl, x0, ts, noise, None, exp=(1.0, 1.0)))
    temb, packed = prepared[0][3], prepared[0][4]
    assert temb.shape == (4, sum(arch) + d) and packed.shape == (ro.dense_layers(d, arch)[1],)
    build.reset_launches()
    ro._launch(prepared)
    (args,) = fake_library.calls
    assert args.net == ro.NET_CODES["dense"] == 1
    assert (args.H, args.C, list(args.widths)) == (3, 0, [12, 20, 8, 0, 0, 0, 0, 0])
    assert args.w_in == packed.data_ptr() and args.temb == temb.data_ptr()
    kernel = "rollout" if form == "lerp" else "rollout_exp"
    key = f"{kernel}.{'lerp' if form == 'lerp' else 'score'}"
    counted = {k: v for k, v in build.FORM_LAUNCHES.items() if v}
    want = {key: 1, f"{key}.gmm.dense": 1}
    if reported == "dense_streamed":
        want[f"{key}.dense.streamed"] = 1
    assert counted == want and build.LAUNCHES[kernel] == 1


S_B, S_STEPS = 16, 6
TINY = [
    "target=gmm", "solver=dis", "loss.method=lv", "model/base@base_model=densenet",
    f"train_batch_size={S_B}", f"train_timesteps.steps={S_STEPS}", "plot_results=False",
    "eval_init=False", "store_last_ckpt=False", "target.n_reference_samples=1000",
    "n_devices=1", "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
]


def test_three_dense_dis_steps_match_jax(tmp_path):
    """The mixture's DIS with densenet.yaml's net: three optimizer steps of
    the port (phase 1 on the kernel route, its plain twin here) against the
    JAX trainer's from the same parameters, prior samples and noise."""
    from sde_sampler_tpu.utils.config import compose, locate

    cfg = compose(REPO / "conf", "base", TINY + ["train_steps=10", f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(TINY + ["train_steps=10", "device=cpu",
                                   f"out_dir={tmp_path / 'port'}"])
    assert isinstance(ps.generative_ctrl.base_model, DenseNet)
    j_params = jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"])
    load_flax_params(ps.generative_ctrl, j_params)
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)
    build.reset_launches()
    for _ in range(3):
        _, k_loss = jax.random.split(js.train_state.key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (S_B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        j_metrics = js.step()
        metrics = ps.step(x0=torch.from_numpy(np.array(x0)), dbs=torch.from_numpy(np.array(dbs)))
        assert float(metrics["train/loss"]) == pytest.approx(
            float(j_metrics["train/loss"]), rel=1e-5)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=1e-4)
        assert math.isfinite(float(metrics["train/loss"]))
    assert build.ROUTES["route.scan"] == 0  # phase 1 on the kernel route
    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    for name, value in ps.generative_ctrl.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)
    assert ps.n_steps == 3
