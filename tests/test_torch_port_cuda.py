"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so that it runs on the card machine, which has
none; skip without a card. Run it there without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances (float32 on the card, sums in another order):
- rollouts (kernel 1 in both control forms, kernel 2), 12 steps: 1e-5
  absolute and relative;
- softmin: 1e-5 absolute; transport cost: 1e-5 relative.
"""
import math

import numpy as np
import pytest
import torch

from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import IsotropicGauss
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import LerpCtrl, ScoreCtrl
from sde_sampler_torch.utils.common import get_timesteps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from sde_sampler_torch.utils.device import resolve_device

    return resolve_device("cuda")


def lerp_ctrl(d=10, hard_constrain=False):
    prior, target = IsotropicGauss(dim=d), Funnel(dim=d, n_reference_samples=100)
    ctrl = LerpCtrl(
        base_model=FourierMLP(dim=d),
        score_model=TimeEmbed(dim_out=1, num_layers=4, last_bias_init={"constant": 1.0}),
        sde=VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0),
        prior_score=prior.score, target_score=target.score,
        clip_model=10.0, clip_score=10.0, hard_constrain=hard_constrain,
    )
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # give the zero-initialised last layer values
        ctrl.base_model.out_layer.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    return ctrl


@pytest.mark.parametrize("batch,hard_constrain", [(32, False), (29, True)])
def test_rollout_kernel_matches_plain_twin(cuda, batch, hard_constrain):
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops.rollout import fused_rollout, rollout_plain

    ctrl = lerp_ctrl(hard_constrain=hard_constrain).to(cuda)
    rng = np.random.default_rng(1)
    T = 12
    ts = torch.linspace(0.0, 1.0, T + 1, device=cuda)
    x0 = torch.tensor(rng.normal(size=(batch, 10)), dtype=torch.float32, device=cuda)
    dbs = torch.tensor(rng.normal(size=(T, batch, 10)), dtype=torch.float32, device=cuda)
    dbs *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    before = build.LAUNCHES["rollout"]
    xs, x_T = fused_rollout(ctrl, x0, ts, dbs, clips)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout"] == before + 1
    xs_p, xT_p = rollout_plain(ctrl, x0, ts, dbs, clips)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


def score_ctrl(d=10):
    ctrl = ScoreCtrl(
        base_model=FourierMLP(dim=d),
        score_model=TimeEmbed(dim_out=1, num_layers=4, last_bias_init={"constant": 0.01}),
        target_score=Funnel(dim=d, n_reference_samples=100).score,
        clip_model=10.0, clip_score=10.0, scale_score=0.7,
    )
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # give the zero-initialised last layers values
        g = torch.Generator().manual_seed(1)
        ctrl.base_model.out_layer.weight.normal_(0.0, 0.05, generator=g)
        ctrl.score_model.out_layer.weight.normal_(0.0, 0.05, generator=g)
    return ctrl


@pytest.mark.parametrize("batch,sde", [(32, "vp"), (29, "bm")])
def test_rollout_kernel_score_form_matches_plain_twin(cuda, batch, sde):
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops.rollout import fused_rollout, rollout_plain

    ctrl = score_ctrl().to(cuda)
    sde = (VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0) if sde == "vp"
           else ScaledBM(diff_coeff=0.4472135954999579, terminal_t=5.0))
    rng = np.random.default_rng(2)
    T = 12
    ts = torch.linspace(0.0, sde.terminal_t, T + 1, device=cuda)
    x0 = torch.tensor(rng.normal(size=(batch, 10)), dtype=torch.float32, device=cuda)
    dbs = torch.tensor(rng.normal(size=(T, batch, 10)), dtype=torch.float32, device=cuda)
    dbs *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = fused_rollout(ctrl, x0, ts, dbs, clips, sde=sde)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES["rollout.score"] == before["rollout.score"] + 1
    assert build.FORM_LAUNCHES["rollout.lerp"] == before["rollout.lerp"]
    xs_p, xT_p = rollout_plain(ctrl, x0, ts, dbs, clips, sde=sde)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [32, 29])
def test_exp_rollout_kernel_matches_plain_twin(cuda, batch):
    """Kernel 2 on a cosine grid whose last steps have dt = 0."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops.rollout import fused_rollout_exp, rollout_exp_plain

    ctrl = score_ctrl().to(cuda)
    rng = np.random.default_rng(3)
    T = 12
    ts = get_timesteps(0.0, 1.6, steps=T - 1, rescale_t="cosine", device=cuda)
    assert float(ts[-1] - ts[-2]) == 0.0
    x0 = torch.tensor(rng.normal(size=(batch, 10)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.normal(size=(T, batch, 10)), dtype=torch.float32, device=cuda)
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    before = build.LAUNCHES["rollout_exp"]
    xs, x_T = fused_rollout_exp(ctrl, x0, ts, noise, 0.9, 1.1, clips)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout_exp"] == before + 1
    xs_p, xT_p = rollout_exp_plain(ctrl, x0, ts, noise, 0.9, 1.1, clips)
    assert torch.equal(xs[0], x0)
    assert torch.equal(x_T, xs[-1])  # the dt = 0 step passes the state through
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [1, 10, 40])
def test_sinkhorn_kernels_match_plain_versions(cuda, d):
    """d = 40 takes the kernels' run-time-width path (d > 16)."""
    from sde_sampler_torch.ops.sinkhorn import (
        softmin,
        softmin_plain,
        transport_cost,
        transport_cost_plain,
    )

    rng = np.random.default_rng(d)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    x, y = f(rng.normal(size=(1000, d))), f(rng.normal(size=(777, d)) + 0.3)
    dual, u = f(rng.normal(size=777) * 0.01), f(rng.normal(size=1000) * 0.01)
    dual[:5] = -math.inf
    eps = 1e-2
    torch.testing.assert_close(
        softmin(x, y, dual, eps), softmin_plain(x, y, dual, eps), atol=1e-5, rtol=0
    )
    torch.testing.assert_close(
        transport_cost(x, y, u, dual, eps), transport_cost_plain(x, y, u, dual, eps),
        atol=0, rtol=1e-5,
    )
