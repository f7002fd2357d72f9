"""PyTorch port vs the JAX package: utilities, distributions, SDEs, models.

The same numpy-seeded inputs go through each JAX function and its
counterpart in `sde_sampler_torch`; models share parameters through the
weight carry (`sde_sampler_torch/utils/params.py`). Tolerances are float32
ones: both sides compute in float32 with the same formulas, and differ only
in the order of additions and in transcendental-function rounding (a few
ulp), so 1e-5 relative unless stated otherwise.
"""
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.funnel import Funnel as JFunnel
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import LerpCtrl as JLerpCtrl
from sde_sampler_tpu.utils.common import get_timesteps as j_get_timesteps
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import LerpCtrl
from sde_sampler_torch.utils.common import get_timesteps
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = Path(__file__).parents[1]


def t_(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("rescale_t", [None, "quad", "cosine"])
def test_get_timesteps_matches_jax(rescale_t):
    want = j_get_timesteps(0.0, 1.0, steps=17, rescale_t=rescale_t)
    got = get_timesteps(0.0, 1.0, steps=17, rescale_t=rescale_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_distributions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 10)).astype(np.float32) * 2.0
    j_prior = JIsoGauss(dim=10, truncate_quartile=1e-4)
    prior = IsotropicGauss(dim=10, truncate_quartile=1e-4)
    # float32 erfinv near +-1 rounds differently in torch and XLA (3e-6)
    np.testing.assert_allclose(prior.truncate_quartile, j_prior.truncate_quartile, rtol=1e-5)
    j_funnel = JFunnel(dim=10, n_reference_samples=100)
    funnel = Funnel(dim=10, n_reference_samples=100)
    np.testing.assert_allclose(funnel.domain.numpy(), np.asarray(j_funnel.domain), rtol=1e-6)
    for jd, td in ((j_prior, prior), (j_funnel, funnel)):
        np.testing.assert_allclose(
            td.log_prob(t_(x)).numpy(), np.asarray(jd.log_prob(jnp.asarray(x))),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            td.score(t_(x)).numpy(), np.asarray(jd.score(jnp.asarray(x))),
            rtol=1e-5, atol=1e-5,
        )
    # the truncated prior stays inside its quartiles; the funnel sampler
    # has the right first-coordinate spread (3 = sqrt(d - 1))
    g = torch.Generator().manual_seed(0)
    s = prior.sample((4000,), generator=g)
    lo, hi = prior.truncate_quartile
    assert float(s.min()) >= lo and float(s.max()) <= hi
    f = funnel.sample((20000,), generator=g)
    assert abs(float(f[:, 0].std()) - 3.0) < 0.1


@pytest.mark.parametrize("generative", [True, False])
def test_vp_matches_jax(generative):
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0,
              generative=generative)
    j_sde, sde = JVP(**kw), VP(**kw)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    for s, t in ((0.0, 0.01), (0.3, 0.35), (0.97, 1.0)):
        js, jt = jnp.float32(s), jnp.float32(t)
        ts, tt = torch.tensor(s), torch.tensor(t)
        pairs = [
            (sde.drift(ts, t_(x)), j_sde.drift(js, jnp.asarray(x))),
            (sde.diff(ts, t_(x)), j_sde.diff(js, jnp.asarray(x))),
            (sde.drift_div_int(ts, tt, t_(x)), j_sde.drift_div_int(js, jt, jnp.asarray(x))),
            (sde.marginal_params(tt, t_(x))[0], j_sde.marginal_params(jt, jnp.asarray(x))[0]),
            (sde.marginal_params(tt, t_(x))[1], j_sde.marginal_params(jt, jnp.asarray(x))[1]),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-7)


_PARAMS = {}


def _flax_params(j_ctrl, d):
    """JAX init of the flagship control, once per width (eager flax init
    compiles op by op). The init zeroes the last layers: give them values
    so that the comparisons see every parameter."""
    if d not in _PARAMS:
        params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))
        _PARAMS[d] = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape),
            params["params"],
        )
    return _PARAMS[d]


def flagship_pair(d=10, hard_constrain=False):
    """The main-path control in both packages, sharing JAX's init."""
    j_prior, j_target = JIsoGauss(dim=d), JFunnel(dim=d, n_reference_samples=100)
    prior, target = IsotropicGauss(dim=d), Funnel(dim=d, n_reference_samples=100)
    kw = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
    j_sde, sde = JVP(**kw), VP(**kw)
    common = dict(clip_model=10.0, clip_score=10.0, detach_score=False,
                  hard_constrain=hard_constrain)
    j_ctrl = JLerpCtrl(
        base_model=JFourierMLP(dim=d, num_layers=4, channels=64),
        score_model=JTimeEmbed(dim_out=1, num_layers=4, channels=64,
                               last_bias_init={"constant": 1.0}),
        sde=j_sde, prior_score=j_prior.score, target_score=j_target.score, **common,
    )
    ctrl = LerpCtrl(
        base_model=FourierMLP(dim=d, num_layers=4, channels=64),
        score_model=TimeEmbed(dim_out=1, num_layers=4, channels=64,
                              last_bias_init={"constant": 1.0}),
        sde=sde, prior_score=prior.score, target_score=target.score, **common,
    )
    params = _flax_params(j_ctrl, d)
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params


def test_weight_carry_names_and_models_match_jax():
    j_ctrl, ctrl, params = flagship_pair()
    keys = set(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    assert keys == set(ctrl.state_dict())
    assert "base_model.timestep_embed.hidden_layer.0.weight" in keys
    assert "score_model.hidden_layer.2.weight" in keys
    assert "base_model.out_layer.bias" in keys

    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    for t in (0.0, 0.37, 1.0):
        want = j_ctrl.apply({"params": params}, jnp.float32(t), jnp.asarray(x))
        with torch.no_grad():
            got = ctrl(torch.tensor(t), t_(x))
            base = ctrl.base_model(torch.tensor(t), t_(x))
            score = ctrl.score_model(torch.tensor(t))
        # FourierMLP, TimeEmbed and LerpCtrl, to about 2e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        j_base = JFourierMLP(dim=10).apply(
            {"params": params["base_model"]}, jnp.float32(t), jnp.asarray(x))
        np.testing.assert_allclose(base.numpy(), np.asarray(j_base), rtol=2e-5, atol=2e-5)
        j_score = JTimeEmbed(dim_out=1, num_layers=4).apply(
            {"params": params["score_model"]}, jnp.float32(t))
        np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=2e-5, atol=2e-5)

    # per-call clips override the configured ones
    clips = {"clip_model": 0.5, "clip_score": 0.25}
    want = j_ctrl.apply({"params": params}, jnp.float32(0.5), jnp.asarray(x), clips=clips)
    with torch.no_grad():
        got = ctrl(torch.tensor(0.5), t_(x), clips=clips)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_batched_time_column_matches_per_step_calls():
    """The (T, 1, 1)-time / (T, B, d)-state call of phase 2 equals T calls."""
    _, ctrl, _ = flagship_pair(hard_constrain=True)
    rng = np.random.default_rng(3)
    ts = torch.linspace(0.0, 1.0, 6)
    xs = t_(rng.normal(size=(6, 16, 10)))
    with torch.no_grad():
        batched = ctrl(ts.reshape(-1, 1, 1), xs)
        for k in range(6):
            torch.testing.assert_close(batched[k], ctrl(ts[k], xs[k]), rtol=1e-5, atol=1e-5)


def test_reset_parameters_uses_the_generator_and_init_specs():
    a = LerpCtrl(
        base_model=FourierMLP(dim=3, last_bias_init="zeros", last_weight_init="zeros"),
        score_model=TimeEmbed(dim_out=1, last_bias_init={"constant": 1.0}),
    )
    b = LerpCtrl(
        base_model=FourierMLP(dim=3, last_bias_init="zeros", last_weight_init="zeros"),
        score_model=TimeEmbed(dim_out=1, last_bias_init={"constant": 1.0}),
    )
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert torch.count_nonzero(a.base_model.out_layer.weight) == 0
    assert torch.all(a.score_model.out_layer.bias == 1.0)
    bound = 1 / math.sqrt(64)
    assert float(a.base_model.hidden_layer[0].weight.detach().abs().max()) <= bound


def test_config_remaps_targets_into_the_port():
    from sde_sampler_torch.utils.config import ConfigError, compose, instantiate, locate

    cfg = compose(REPO / "conf", "base", ["target=funnel", "solver=dis", "loss.method=lv"])
    assert cfg["scale_loss"] == pytest.approx(0.1)  # ${eval:1/${target.dim}}
    target = instantiate(cfg["target"], n_reference_samples=10)
    assert type(target).__module__ == "sde_sampler_torch.distr.funnel"
    assert locate(cfg["solver"]["_target_"]).__module__ == "sde_sampler_torch.solver.oc"
    assert locate("sde_sampler_tpu.solver.oc.SubtrajBridge").__module__ == "sde_sampler_torch.solver.oc"
    assert locate("sde_sampler_tpu.models.reparam.CancelDriftCtrl").__module__ == (
        "sde_sampler_torch.models.reparam")
    for module in ("cox.Cox", "img.Img", "nice.Nice", "aladip.AlaDip"):
        assert locate(f"sde_sampler_tpu.distr.{module}").__module__ == (
            "sde_sampler_torch.distr." + module.split(".")[0])
    for name in ("debug.enable_debug_nans", "watch.ModelWatcher"):
        assert locate(f"sde_sampler_tpu.utils.{name}").__module__ == (
            "sde_sampler_torch.utils." + name.split(".")[0])
    # a module the port lacks is named, never the JAX one
    with pytest.raises(ConfigError, match="sde_sampler_torch.parallel.mesh"):
        locate("sde_sampler_tpu.parallel.mesh.get_mesh")


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the port, and the solvers of DIS, DDS, EulerDDS and
    PIS, the subtrajectory solvers with their PotentialCtrls, the Langevin
    solver under each integrator, DIS on the rings and the Rosenbrock and
    EulerDDS with the langevin_init control, DIS on the image, Cox, the
    smooth NICE flow and the alanine dipeptide, DIS, PIS and DDS with score
    nets of d outputs, and the setup hooks and the model watcher composed
    from conf/ and built, and the entry points with their launchers, sweep,
    wandb shim and NICE trainer, and the data-parallel layer, load no JAX
    module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sde_sampler_torch\n"
        "for m in pkgutil.walk_packages(sde_sampler_torch.__path__, 'sde_sampler_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from sde_sampler_torch import main\n"
        "runs = [('funnel', 'dis', []), ('funnel', 'dds', []), ('funnel', 'dds_euler', []),\n"
        "        ('funnel', 'pis', []), ('gmm', 'dis_subtraj', []), ('gmm', 'bridge_subtraj', []),\n"
        "        ('rings', 'dis', []), ('rosenbrock', 'dis', []),\n"
        "        ('gmm', 'dds_euler', ['model@generative_ctrl=langevin_init']),\n"
        "        ('img', 'dis', []), ('cox', 'dis', []), ('nice_smooth', 'dis', []),\n"
        "        ('aladip_vacuum', 'dis', ['+utils@setup=debug',\n"
        "                                  '+utils@model_watcher=model_watcher']),\n"
        "        ('funnel', 'dis', ['model@generative_ctrl=lerp_dim']),\n"
        "        ('funnel', 'pis', ['model@generative_ctrl=score_dim']),\n"
        "        ('funnel', 'dds', ['model@generative_ctrl=score_dim'])]\n"
        "runs += [('gmm', 'langevin', [f'integrator={i}']) for i in\n"
        "         ('euler', 'heun', 'euler_adjoint', 'torchsde_euler', 'torchsde_heun')]\n"
        "for i, (target, solver, extra) in enumerate(runs):\n"
        "    ref = (['target.n_reference_samples=100']\n"
        "           if target in ('funnel', 'gmm', 'img', 'nice_smooth') else [])\n"
        "    s = main.make_solver([f'target={target}', f'solver={solver}', 'device=cpu',\n"
        "                          *ref, *extra, 'plot_results=False',\n"
        "                          'out_dir=' + sys.argv[1] + str(i)])\n"
        "    assert type(s).__module__.startswith('sde_sampler_torch.solver.'), s\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sde_sampler_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('solver.oc', 'distr.delta', 'losses.oc', 'ops.rollout', 'models.reparam',\n"
        "          'solver.langevin', 'eq.integrator', 'distr.rings', 'distr.rosenbrock',\n"
        "          'distr.img', 'distr.cox', 'distr.nice', 'distr.aladip', 'distr.aladip_ff',\n"
        "          'distr.aladip_transform', 'utils.debug', 'utils.watch', 'main', 'sweep',\n"
        "          'train_nice', 'utils.launcher', 'utils.wandb', 'parallel.mesh'):\n"
        "    assert 'sde_sampler_torch.' + m in sys.modules, m\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, f"{tmp_path}/"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_device_policy_never_falls_back_to_the_cpu():
    from sde_sampler_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: null resolves to it")
    with pytest.raises(RuntimeError, match="No CUDA device"):
        resolve_device(None)
