"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so that it runs on the card machine, which has
none; skip without a card. Run it there without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances (float32 on the card, sums in another order):
- rollouts (kernel 1 in both control forms, kernel 2), 12 steps: 1e-5
  absolute and relative, in the fast body (width 64, two hidden layers,
  d <= 16) and in the generic one (any other shape); each (form, target)
  instance of the mixture, the wells, the rings, the Rosenbrock, the
  score-free ClippedCtrl, the CancelDriftCtrl and the image in both
  bodies the same, for one step from the plain twin's state and over 12
  steps of the configs' step size; the given-score form (one launch a
  step after the target's own score: Cox) the same at d = 196 in the
  generic and the wide body, which give the same bits, and at d = 1600 in
  the wide body; the PotentialCtrl's generic body the same (its register
  path at d = 2, 50 and 530, at ragged batches and rows asked for; the
  tiled body of 32- and 48-wide nets), and with a clip below every |net|
  1e-6 of the bare SDE's update in both bodies; the LerpPriorCtrl's
  instances, and the lerp forms over a diagonal Gauss prior (PIS's Delta,
  a Gauss of unequal coordinates) the same, where an IsotropicGauss and an
  equal Gauss give the same bits;
- the DenseNet body (a ReLU DenseNet, densenet.yaml's [200, 200]): each
  instance of the FourierMLP's targets, resident and streamed, which give
  the same bits, and the given score at d = 196: 1e-5 absolute and
  relative, one step from the plain twin's state and over 12 steps;
- the scan route of phase 1 (no kernel: a tanh DenseNet base net): 1e-4
  against the CPU over 12 steps;
- softmin: 1e-5 absolute; transport cost: 1e-5 relative at eps = 1e-2
  (1e-4 at the evaluation's eps = 1e-3, and for a plan of one normal
  entry), exactly 0 when every dual is -inf or every plan entry lies below
  2^-126; two transport calls give the same bits.

The kernel library also decides which body a rollout shape takes and how
the Sinkhorn kernels split their columns; both are checked here, where it
is built.
"""
import math

import numpy as np
import pytest
import torch

from sde_sampler_torch.distr.cox import Cox
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.double_well import DoubleWell, MultiWell
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import GMM, Gauss, IsotropicGauss
from sde_sampler_torch.distr.img import Img
from sde_sampler_torch.distr.rings import Rings
from sde_sampler_torch.distr.rosenbrock import Rosenbrock
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import (
    CancelDriftCtrl,
    ClippedCtrl,
    LerpCtrl,
    LerpPriorCtrl,
    LerpTargetCtrl,
    PotentialCtrl,
    ScoreCtrl,
)
from sde_sampler_torch.utils.common import get_timesteps

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from sde_sampler_torch.utils.device import resolve_device

    return resolve_device("cuda")


def lerp_ctrl(d=10, hard_constrain=False, channels=64, num_layers=4):
    prior, target = IsotropicGauss(dim=d), Funnel(dim=d, n_reference_samples=100)
    ctrl = LerpCtrl(
        base_model=FourierMLP(dim=d, channels=channels, num_layers=num_layers),
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
    generic = build.FORM_LAUNCHES["rollout.lerp.generic"]
    xs, x_T = fused_rollout(ctrl, x0, ts, dbs, clips)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout"] == before + 1
    assert build.FORM_LAUNCHES["rollout.lerp.generic"] == generic  # the fast body
    xs_p, xT_p = rollout_plain(ctrl, x0, ts, dbs, clips)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


def score_ctrl(d=10, channels=64):
    ctrl = ScoreCtrl(
        base_model=FourierMLP(dim=d, channels=channels),
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
    assert build.FORM_LAUNCHES["rollout.score.generic"] == before["rollout.score.generic"]
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
    generic = build.FORM_LAUNCHES["rollout_exp.score.generic"]
    xs, x_T = fused_rollout_exp(ctrl, x0, ts, noise, 0.9, 1.1, clips)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rollout_exp"] == before + 1
    assert build.FORM_LAUNCHES["rollout_exp.score.generic"] == generic  # the fast body
    xs_p, xT_p = rollout_exp_plain(ctrl, x0, ts, noise, 0.9, 1.1, clips)
    assert torch.equal(xs[0], x0)
    assert torch.equal(x_T, xs[-1])  # the dt = 0 step passes the state through
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("duals", ["random", "plan"])
@pytest.mark.parametrize("d", [1, 10, 40, 50, 60, 196])
def test_sinkhorn_kernels_match_plain_versions(cuda, d, duals):
    """d = 40 and up take the kernels' wide body (d > 16); 50, 60 and 196
    are the widths of mw_50d, the alanine dipeptide and NICE.

    Transport on random duals: at d = 1 many plan entries are normal floats
    and the kernel is held to the plain version. At d = 10 all plan entries
    but one lie below float32's smallest normal, 2^-126, and at d >= 40 all
    do: the kernel drops those (ex2.approx.ftz) where the plain version
    keeps them as subnormals, so there it is held to the sum over the
    normal entries alone (one entry at d = 10, whose exponent of about -117
    in log2 units gets no averaging: rtol 1e-4; exactly 0 at d >= 40). On
    the duals of one Sinkhorn iteration (`plan_duals`) the plan carries
    mass at every d."""
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
    v = dual
    if duals == "plan":
        u, v = plan_duals(x, y, eps)
        v[:5] = -math.inf
    got, want = transport_cost(x, y, u, v, eps), transport_cost_plain(x, y, u, v, eps)
    if duals == "plan" or d == 1:
        assert float(want) > 0
        torch.testing.assert_close(got, want, atol=0, rtol=1e-5)
        return
    assert 0.0 <= float(want) < 1e-30
    kept = normal_entries_cost(x, y, u, v, eps)
    assert (kept > 0) == (d == 10)
    assert math.isclose(float(got), kept, rel_tol=1e-4, abs_tol=0.0)


def normal_entries_cost(x, y, u, v, eps) -> float:
    """The transport cost in float64 over the plan entries that are normal
    float32 numbers (at least 2^-126), the ones the kernel keeps."""
    m = torch.cdist(x.double(), y.double(), compute_mode="donot_use_mm_for_euclid_dist")
    plan = torch.exp((-m + u.double()[:, None] + v.double()[None, :]) / eps)
    return float((plan * m).where(plan >= 2.0**-126, 0.0).sum())


def plan_duals(x, y, eps):
    """The duals after one Sinkhorn iteration from uniform weights, under
    which the plan carries mass (as the evaluation's Sinkhorn duals do)."""
    from sde_sampler_torch.ops.sinkhorn import softmin_plain

    n, m = x.shape[0], y.shape[0]
    v = torch.full((m,), eps * math.log(1 / m), device=x.device)
    u = eps * math.log(1 / n) - softmin_plain(x, y, v, eps)
    v = eps * math.log(1 / m) - softmin_plain(y, x, u, eps)
    return u, v


@pytest.mark.parametrize("d", [1, 10, 40])
def test_transport_kernel_at_the_evaluation_eps(cuda, d):
    """eps = 1e-3, the evaluation Sinkhorn's: the duals, in log2 units
    (u * log2(e) / eps), are about 1e3, so their rounding puts about 1e-4
    of random-signed error into each plan entry; held at the rtol of the
    100k check in chip_smoke.py."""
    from sde_sampler_torch.ops.sinkhorn import transport_cost, transport_cost_plain

    rng = np.random.default_rng(300 + d)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    x, y = f(rng.normal(size=(3000, d))), f(rng.normal(size=(2000, d)) * 1.2 + 0.3)
    eps = 1e-3
    u, v = plan_duals(x, y, eps)
    want = transport_cost_plain(x, y, u, v, eps)
    assert float(want) > 0
    torch.testing.assert_close(transport_cost(x, y, u, v, eps), want, atol=0, rtol=1e-4)


@pytest.mark.parametrize("form", ["lerp", "score", "exp"])
def test_generic_rollout_body_matches_plain_twin(cuda, form):
    """A 32-wide net takes the any-shape body, counted as such."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    rng = np.random.default_rng(4)
    T, batch = 12, 29
    x0 = torch.tensor(rng.normal(size=(batch, 10)), dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.normal(size=(T, batch, 10)), dtype=torch.float32, device=cuda)
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    if form == "lerp":
        ctrl = lerp_ctrl(channels=32).to(cuda)
        ts = torch.linspace(0.0, 1.0, T + 1, device=cuda)
        noise *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
        run = lambda: ro.fused_rollout(ctrl, x0, ts, noise, clips)
        plain = lambda: ro.rollout_plain(ctrl, x0, ts, noise, clips)
        key = "rollout.lerp.generic"
    elif form == "score":
        ctrl = score_ctrl(channels=32).to(cuda)
        sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
        ts = torch.linspace(0.0, 1.0, T + 1, device=cuda)
        noise *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
        run = lambda: ro.fused_rollout(ctrl, x0, ts, noise, clips, sde=sde)
        plain = lambda: ro.rollout_plain(ctrl, x0, ts, noise, clips, sde=sde)
        key = "rollout.score.generic"
    else:
        ctrl = score_ctrl(channels=32).to(cuda)
        ts = get_timesteps(0.0, 1.6, steps=T - 1, rescale_t="cosine", device=cuda)
        run = lambda: ro.fused_rollout_exp(ctrl, x0, ts, noise, 0.9, 1.1, clips)
        plain = lambda: ro.rollout_exp_plain(ctrl, x0, ts, noise, 0.9, 1.1, clips)
        key = "rollout_exp.score.generic"
    before = build.FORM_LAUNCHES[key]
    xs, x_T = run()
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[key] == before + 1
    xs_p, xT_p = plain()
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [1, 10, 12, 16, 17, 50, 60, 196, 400])
@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_softmin_kernel_splits_and_edges(cuda, d, case):
    """n = 1000 rows (no multiple of the block's rows, 512 for d <= 16, 128
    for the wide body) against m = 5001 columns in column splits, the last
    one ragged, as the library plans them; d = 1..16 hold the rows in
    registers, d = 17 and up take the wide body (a register-blocked tile
    over k-major copies of both clouds). d > 17 is drawn at standard
    deviation sqrt(10 / d), so that its distances are of the order of
    d = 10's and the same absolute tolerance applies. "dead_split": every
    dual of the second split is -inf (it merges as no contribution);
    "all_inf": every row sees only -inf and gives -inf."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops.sinkhorn import softmin, softmin_plain, softmin_plan

    n, m, eps = 1000, 5001, 1e-2
    plan = softmin_plan(n, m, d)
    assert plan.rows == (512 if d <= 16 else 128)
    # four splits for d <= 16; the wide body plans at least as many
    assert (plan.splits == 4) if d <= 16 else (plan.splits >= 4)
    assert m % plan.cols and n % plan.rows
    rng = np.random.default_rng(100 + d)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    scale = 1.0 if d <= 17 else math.sqrt(10 / d)
    x, y = f(rng.normal(size=(n, d)) * scale), f((rng.normal(size=(m, d)) + 0.3) * scale)
    dual = f(rng.normal(size=m) * 0.01)
    if case == "dead_split":
        dual[plan.cols : 2 * plan.cols] = -math.inf
        dual[:7] = -math.inf
    elif case == "all_inf":
        dual[:] = -math.inf
    before, wide = build.LAUNCHES["softmin"], build.FORM_LAUNCHES["softmin.wide"]
    got = softmin(x, y, dual, eps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["softmin"] == before + 1
    assert build.FORM_LAUNCHES["softmin.wide"] == wide + (d > 16)
    want = softmin_plain(x, y, dual, eps)
    if case == "all_inf":
        assert bool((got == -math.inf).all()) and bool((want == -math.inf).all())
        return
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [1, 10, 16, 17, 50, 60, 196, 400])
@pytest.mark.parametrize("case", ["ragged", "dead_split", "all_inf"])
def test_transport_kernel_splits_and_edges(cuda, d, case):
    """n = 1000 rows against m = 5001 columns in column splits, the last
    one ragged, as the library plans them; d = 1..16 hold the rows in
    registers, d = 17 and up take the wide body. d > 17 is drawn at
    standard deviation sqrt(10 / d), as in the softmin test. "dead_split":
    every column dual of the second split is -inf, and a few rows' duals
    too; "all_inf": every dual is -inf, and the cost is exactly 0."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops.sinkhorn import (
        transport_cost,
        transport_cost_plain,
        transport_plan,
    )

    n, m, eps = 1000, 5001, 1e-2
    plan = transport_plan(n, m, d)
    assert plan.rows == (512 if d <= 16 else 128)
    # four splits for d <= 16; the wide body plans at least as many
    assert (plan.splits == 4) if d <= 16 else (plan.splits >= 4)
    assert m % plan.cols and n % plan.rows
    rng = np.random.default_rng(200 + d)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    scale = 1.0 if d <= 17 else math.sqrt(10 / d)
    x, y = f(rng.normal(size=(n, d)) * scale), f((rng.normal(size=(m, d)) + 0.3) * scale)
    u, v = plan_duals(x, y, eps)
    if case == "dead_split":
        v[plan.cols : 2 * plan.cols] = -math.inf
        v[:7] = -math.inf
        u[:5] = -math.inf
    elif case == "all_inf":
        u[:] = -math.inf
        v[:] = -math.inf
    before, wide = build.LAUNCHES["transport"], build.FORM_LAUNCHES["transport.wide"]
    got = transport_cost(x, y, u, v, eps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["transport"] == before + 1
    assert build.FORM_LAUNCHES["transport.wide"] == wide + (d > 16)
    want = transport_cost_plain(x, y, u, v, eps)
    if case == "all_inf":
        assert float(got) == 0.0 and float(want) == 0.0
        return
    assert float(want) > 0
    torch.testing.assert_close(got, want, atol=0, rtol=1e-5)


def test_transport_kernel_is_deterministic(cuda):
    """The splits' partials are totalled in a fixed order, without atomics:
    two calls on the same inputs give the same bits."""
    from sde_sampler_torch.ops.sinkhorn import transport_cost

    rng = np.random.default_rng(7)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    x, y = f(rng.normal(size=(3000, 10))), f(rng.normal(size=(20000, 10)) + 0.3)
    u, v = plan_duals(x, y, 1e-2)
    first = transport_cost(x, y, u, v, 1e-2)
    assert all(torch.equal(transport_cost(x, y, u, v, 1e-2), first) for _ in range(3))


def test_wide_transport_kernel_is_deterministic(cuda):
    """The same at d = 50 in the wide body: its threads' partials are
    folded into the same fixed double-precision tree."""
    from sde_sampler_torch.ops.sinkhorn import transport_cost

    rng = np.random.default_rng(8)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    x, y = f(rng.normal(size=(3000, 50))), f(rng.normal(size=(20000, 50)) + 0.3)
    u, v = plan_duals(x, y, 1e-2)
    first = transport_cost(x, y, u, v, 1e-2)
    assert float(first) > 0
    assert all(torch.equal(transport_cost(x, y, u, v, 1e-2), first) for _ in range(3))


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
def test_wide_body_rows_past_the_row_tile(cuda, n):
    """Row counts that leave the last 128-row block partly empty (n = 1 and
    127 fill no block): the padded rows write no softmin output and carry a
    -inf u, so they add nothing to the transport cost."""
    from sde_sampler_torch.ops.sinkhorn import (
        softmin,
        softmin_plain,
        transport_cost,
        transport_cost_plain,
    )

    rng = np.random.default_rng(n)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    d, eps = 50, 1e-2
    scale = math.sqrt(10 / d)
    x, y = f(rng.normal(size=(n, d)) * scale), f((rng.normal(size=(999, d)) + 0.3) * scale)
    u, v = plan_duals(x, y, eps)
    torch.testing.assert_close(softmin(x, y, v, eps), softmin_plain(x, y, v, eps),
                               atol=1e-5, rtol=0)
    want = transport_cost_plain(x, y, u, v, eps)
    assert float(want) > 0
    torch.testing.assert_close(transport_cost(x, y, u, v, eps), want, atol=0, rtol=1e-5)


@pytest.mark.parametrize(
    "channels,layers,d,T,want",
    [
        (64, 4, 10, 200, "fast"),  # the main path: DIS at 200 steps, d = 10
        (64, 4, 10, 257, "fast"),  # DDS's cosine grid
        (64, 4, 16, 257, "fast"),
        (64, 4, 2, 12, "fast"),
        (32, 4, 10, 200, "generic"),
        (64, 3, 10, 200, "generic"),
        (64, 4, 17, 200, "generic"),
        (64, 4, 10, 2000, "generic"),  # tables past the H100's shared memory
    ],
)
def test_rollout_launch_picks_its_body_by_shape(cuda, channels, layers, d, T, want):
    """The kernel picks its body by shape and reports it for the count. Where
    the fast body fits, it gives the generic body's bits; where it does not,
    asking for it raises."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    ctrl = lerp_ctrl(d=d, channels=channels, num_layers=layers).to(cuda)
    rng = np.random.default_rng(5)
    x0 = torch.tensor(rng.normal(size=(5, d)), dtype=torch.float32, device=cuda)
    ts = torch.linspace(0.0, 1.0, T + 1, device=cuda)
    dbs = torch.tensor(rng.normal(size=(T, 5, d)), dtype=torch.float32, device=cuda)
    dbs *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
    generic = build.FORM_LAUNCHES["rollout.lerp.generic"]
    xs, x_T = ro.fused_rollout(ctrl, x0, ts, dbs)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES["rollout.lerp.generic"] == generic + (want == "generic")
    prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    xs_g, xT_g = ro._launch(prepared, "generic")
    assert torch.equal(xs, xs_g) and torch.equal(x_T, xT_g)
    if want == "generic":
        with pytest.raises(RuntimeError):
            ro._launch(prepared, "fast")


def test_fast_body_is_what_every_model_config_takes(cuda):
    """conf/model/base/*.yaml: channels 64, num_layers 4 (two hidden), on the
    DIS and DDS grids; also the widest d the fast body holds."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    for d, T in ((10, 200), (10, 257), (16, 257)):
        ctrl = score_ctrl(d=d).to(cuda)
        assert (ctrl.base_model.channels, len(ctrl.base_model.hidden_layer)) == (64, 2)
        x0 = torch.zeros(3, d, device=cuda)
        ts = get_timesteps(0.0, 12.8, steps=T - 1, rescale_t="cosine", device=cuda)
        before = build.FORM_LAUNCHES["rollout_exp.score.generic"]
        ro.fused_rollout_exp(ctrl, x0, ts, torch.zeros(T, 3, d, device=cuda), 1.0, 1.0)
        assert build.FORM_LAUNCHES["rollout_exp.score.generic"] == before


@pytest.mark.parametrize("n", [1, 777, 100_000])
@pytest.mark.parametrize("m", [1, 777, 100_000])
def test_softmin_plan_covers_every_column_once(cuda, n, m):
    """The library's column splits: each a multiple of 16 columns, none
    empty, together covering m rounded up to 16; the scratch holds the
    packed columns (point, dual, zeros to a multiple of 4 floats) and a max
    and a sum per row and split."""
    from sde_sampler_torch.ops.sinkhorn import softmin_plan

    d = 10
    plan = softmin_plan(n, m, d)
    m_pad = -(-m // 16) * 16
    assert plan.cols % 16 == 0
    owner = np.full(m_pad, -1)
    for s in range(plan.splits):
        lo, hi = s * plan.cols, min((s + 1) * plan.cols, m_pad)
        assert hi > lo, "empty split"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    assert plan.scratch_floats == m_pad * 12 + 2 * plan.splits * n


@pytest.mark.parametrize("n", [1, 777, 100_000])
@pytest.mark.parametrize("m", [1, 777, 100_000])
def test_transport_plan_covers_every_column_once(cuda, n, m):
    """As softmin's plan; the scratch holds the packed columns and one
    double (two floats) per block of 512 rows and split."""
    from sde_sampler_torch.ops.sinkhorn import transport_plan

    d = 10
    plan = transport_plan(n, m, d)
    m_pad = -(-m // 16) * 16
    assert plan.cols % 16 == 0
    owner = np.full(m_pad, -1)
    for s in range(plan.splits):
        lo, hi = s * plan.cols, min((s + 1) * plan.cols, m_pad)
        assert hi > lo, "empty split"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
    assert (owner >= 0).all()
    assert plan.rows == 512  # 128 threads x 4 rows
    assert plan.scratch_floats == m_pad * 12 + 2 * plan.splits * -(-n // plan.rows)


@pytest.mark.parametrize("d", [17, 50, 196])
@pytest.mark.parametrize("n", [1, 777, 100_000])
@pytest.mark.parametrize("m", [1, 777, 100_000])
def test_wide_plans_cover_every_column_once(cuda, d, n, m):
    """The wide body's splits (d > 16): each a multiple of the 128-column
    tile, none empty, together covering m rounded up to the tile; blocks of
    128 rows. The scratch holds the k-major columns and rows (d rounded up
    to the 8-coordinate slice, rows to whole blocks), the columns' duals,
    then softmin's max and sum per row and split, or transport's double per
    row block and split."""
    from sde_sampler_torch.ops.sinkhorn import softmin_plan, transport_plan

    m_pad, d_pad = -(-m // 128) * 128, -(-d // 8) * 8
    sm, tr = softmin_plan(n, m, d), transport_plan(n, m, d)
    assert sm[:3] == tr[:3]  # one plan for both kernels
    for plan in (sm, tr):
        assert plan.rows == 128 and plan.cols % 128 == 0
        owner = np.full(m_pad, -1)
        for s in range(plan.splits):
            lo, hi = s * plan.cols, min((s + 1) * plan.cols, m_pad)
            assert hi > lo, "empty split"
            assert (owner[lo:hi] == -1).all()
            owner[lo:hi] = s
        assert (owner >= 0).all()
    packed = d_pad * (m_pad + -(-n // 128) * 128) + m_pad
    assert sm.scratch_floats == packed + 2 * sm.splits * n
    assert tr.scratch_floats == packed + 2 * tr.splits * -(-n // 128)


def test_softmin_plan_fills_the_card_at_the_evaluation_size(cuda):
    from sde_sampler_torch.ops.sinkhorn import softmin_plan

    plan = softmin_plan(100_000, 100_000, 10)
    row_blocks = -(-100_000 // plan.rows)
    assert row_blocks * plan.splits >= 132 * 16
    assert plan.cols >= 1024


@pytest.mark.parametrize("n,m", [(100_000, 100_000), (10_000, 10_000), (4096, 4096),
                                 (50_000, 100_000)])
def test_wide_plan_fills_the_card(cuda, n, m):
    """The wide body at the evaluation's 100k, the short paths' 10k, the
    alanine dipeptide's 4096 and a data-parallel rank's 50k x 100k: at least
    one wave of two blocks on each of the 132 SMs."""
    from sde_sampler_torch.ops.sinkhorn import softmin_plan, transport_plan

    for plan in (softmin_plan(n, m, 50), transport_plan(n, m, 50)):
        assert -(-n // plan.rows) * plan.splits >= 2 * 132


# The (form, target) instances beyond the funnel's: form, target, d. The
# mixtures: conf/target/gmm.yaml (grid, K = 9), the multi preset (K = 80)
# and gauss_shift (K = 1, d = 1); the wells: mw (d = 5), dw_shift (d = 1)
# and a MultiWell with Gaussian coordinates (d = 12). The LerpTargetCtrl
# (solver=bridge) on the grid and on a three-component mixture at d = 5.
# The PotentialCtrl (solver=dis_subtraj, bridge_subtraj; the net's backward
# pass in every step) at the mixture's d = 2 and at d = 16, the widest the
# fast body holds. The rings (d = 2 only) and the Rosenbrock (conf's d = 15,
# and d = 5 under kernel 2); the CancelDriftCtrl of model=langevin_init on
# the grid mixture and the rings; the LerpPriorCtrl of model=lerp_prior (no
# target: the target given is not read) at d = 2 and 16.
TARGET_INSTANCES = {
    "lerp.gmm": ("lerp", lambda: GMM(name="grid"), 2),
    "lerp.gmm.multi": ("lerp", lambda: GMM(name="multi", domain_tol=None), 2),
    "lerp.gmm.d1": ("lerp", lambda: IsotropicGauss(dim=1, loc=3.0), 1),
    "score.gmm": ("score", lambda: GMM(name="grid"), 2),
    "score.wells": ("score", lambda: MultiWell(dim=5, n_double_wells=5, separation=4.0), 5),
    "score.wells.d1": ("score", lambda: DoubleWell(separation=2.0, shift=1.5), 1),
    "lerp.wells": ("lerp", lambda: MultiWell(dim=12, n_double_wells=5, separation=2.0), 12),
    "clipped.none": ("clipped", None, 2),
    "lerp_target.gmm": ("lerp_target", lambda: GMM(name="grid"), 2),
    "lerp_target.gmm.d5": ("lerp_target", lambda: GMM(
        dim=5, loc=np.linspace(-3, 3, 15).reshape(3, 5), scale=np.full((3, 5), 0.8),
        mixture_weights=np.array([0.2, 0.3, 0.5]), domain_tol=None), 5),
    "potential.none": ("potential", None, 2),
    "potential.none.d16": ("potential", None, 16),
    "exp.gmm": ("exp", lambda: GMM(name="grid"), 2),
    "exp.wells": ("exp", lambda: MultiWell(dim=5, n_double_wells=5, separation=4.0), 5),
    "lerp.rings": ("lerp", lambda: Rings(), 2),
    "lerp.rosenbrock": ("lerp", lambda: Rosenbrock(dim=15, flatness=10.0, scale=1e5), 15),
    "exp.rosenbrock": ("exp", lambda: Rosenbrock(dim=5, flatness=10.0), 5),
    "cancel_drift.gmm": ("cancel_drift", lambda: GMM(name="grid"), 2),
    "cancel_drift.rings": ("cancel_drift", lambda: Rings(), 2),
    "lerp.img": ("lerp", lambda: Img(n_reference_samples=None), 2),
    "exp.img": ("exp", lambda: Img(n_reference_samples=None), 2),
    "lerp_prior.none": ("lerp_prior", lambda: GMM(name="grid"), 2),
    "lerp_prior.none.d16": ("lerp_prior", lambda: IsotropicGauss(dim=16), 16),
}


def instance_setup(cuda, name, batch=29, T=12, seed=6, spec=None, score_dim=False, net=None,
                   dense=None, prior=None):
    """The control of an instance with seeded weights, and its inputs: the
    last T steps of a 200-step grid for the EM forms (VP for the LerpCtrl,
    ClippedCtrl and CancelDriftCtrl, the PIS scaled BM for the ScoreCtrl, the Bridge's
    scaled BM of conf/sde/bm.yaml for the LerpTargetCtrl), a cosine grid
    with dt = 0 steps for kernel 2. `score_dim`: a score net of d outputs,
    each its own; `net`: the base net's width and depth, if not the
    configs'; `dense`: a ReLU DenseNet of these widths in place of the
    FourierMLP; `prior`: the lerp forms' prior, if not a standard
    IsotropicGauss. Returns (prepare(x0, ts, noise), x0, ts, noise)."""
    from sde_sampler_torch.ops import rollout as ro

    form, make_target, d = spec or TARGET_INSTANCES[name]
    if form == "score":
        sde = ScaledBM(diff_coeff=0.4472135954999579, terminal_t=5.0)
    elif form == "lerp_target":
        sde = ScaledBM(diff_coeff=1.0, terminal_t=1.0)
    else:
        sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    base = FourierMLP(dim=d, **{"dim_out": 1 if form == "potential" else None, **(net or {})})
    if dense is not None:
        base = DenseNet(dim=d, arch=dense)
    if form == "clipped":
        ctrl = ClippedCtrl(base_model=base, clip_model=10.0, sde=sde)
    elif form == "potential":
        ctrl = PotentialCtrl(base_model=base, clip_model=10.0, sde=sde)
    else:
        target = make_target().to(cuda)
        # the score nets' last bias of conf/model/lerp.yaml and
        # langevin_init.yaml (1) and score.yaml (0.01)
        bias = 1.0 if form in ("lerp", "lerp_target", "cancel_drift", "lerp_prior") else 0.01
        common = dict(base_model=base, target_score=target.score, clip_model=10.0,
                      clip_score=10.0,
                      score_model=TimeEmbed(dim_out=d if score_dim else 1, num_layers=4,
                                            last_bias_init={"constant": bias}))
        prior_score = (prior or IsotropicGauss(dim=d)).to(cuda).score
        if form == "lerp":
            ctrl = LerpCtrl(sde=sde, prior_score=prior_score, **common)
        elif form == "lerp_prior":
            ctrl = LerpPriorCtrl(sde=sde, prior_score=prior_score, **common)
        elif form == "lerp_target":
            ctrl = LerpTargetCtrl(sde=sde, **common)
        elif form == "cancel_drift":
            ctrl = CancelDriftCtrl(sde=sde, langevin_init=True, **common)
        else:
            ctrl = ScoreCtrl(**common)
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # give the zero-initialised last layer values
        base.out_layer.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        if score_dim:
            ctrl.score_model.out_layer.weight.normal_(
                0.0, 0.05, generator=torch.Generator().manual_seed(2))
    ctrl = ctrl.to(cuda)
    rng = np.random.default_rng(seed)
    scale = 3.0 if ("gmm" in name or "rings" in name) and d > 1 else 1.0
    x0 = torch.tensor(rng.normal(size=(batch, d)) * scale, dtype=torch.float32, device=cuda)
    noise = torch.tensor(rng.normal(size=(T, batch, d)), dtype=torch.float32, device=cuda)
    clips = {"clip_model": 5.0, "clip_score": 10.0}
    if form == "exp":
        ts = get_timesteps(0.0, 1.6, steps=T - 1, rescale_t="cosine", device=cuda)
        return (lambda x, t, n: ro._prepare(ctrl, x, t, n, clips, exp=(0.9, 1.1))), x0, ts, noise
    end = sde.terminal_t
    ts = torch.linspace(end * (1 - T / 200), end, T + 1, device=cuda)
    noise *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]
    pass_sde = sde if form == "score" else None
    return (lambda x, t, n: ro._prepare(ctrl, x, t, n, clips, pass_sde)), x0, ts, noise


@pytest.mark.parametrize("body", ["fast", "generic"])
@pytest.mark.parametrize("name", list(TARGET_INSTANCES))
def test_target_instances_match_plain_twin(cuda, name, body):
    """One step from the plain twin's own states (no compounding), then the
    whole rollout, in the body asked for; counted under its target. The
    fast body gives the generic body's bits. The nets are those of the
    configs (a ScoreCtrl's score net starts near 0.01): with a score net
    near 1, kernel 2's 12-step grid on mw's stiff wells (slope up to about
    80) multiplies rounding differences by more than 2 a step. The image's
    score is constant on each pixel and jumps at its edges, so a rounding
    difference that puts a state on the other side of an edge changes the
    next step by a pixel's gradient (exp.img on the card: 12 of 696
    elements moved by up to 2.2e-3 over 12 steps): it is held one step
    from the twin's state at every step instead of over the whole
    rollout."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, name)
    form = TARGET_INSTANCES[name][0]
    kernel = "rollout_exp" if form == "exp" else "rollout"
    key = f"{kernel}.{'score' if form == 'exp' else form}.{name.split('.')[1]}"
    T = noise.shape[0]
    before = build.FORM_LAUNCHES[key]
    xs, x_T = ro._launch(prepare(x0, ts, noise), body)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[key] == before + 1
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    assert bool(torch.isfinite(xs_p).all())
    pixels = "img" in name
    for k in range(T) if pixels else (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        want = xT_p if k == T - 1 else xs_p[k + 1]
        torch.testing.assert_close(x1, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(xs[0], x0)
    if not pixels:
        torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    if body == "fast":
        xs_g, xT_g = ro._launch(prepare(x0, ts, noise), "generic")
        assert torch.equal(xs, xs_g) and torch.equal(x_T, xT_g)


# The DenseNet body (rollout.cuh rollout_dense_kernel): a ReLU DenseNet of
# conf/model/base/densenet.yaml's widths in each instance of
# TARGET_INSTANCES but the PotentialCtrl's (which has no DenseNet body),
# and mw_50d's d = 50; its weights resident in shared memory (at d = 50 and
# above they do not fit: the resident mode is refused there) and streamed.
DENSE_ARCH = (200, 200)
DENSE_MODES = ("dense", "dense_streamed")
DENSE_INSTANCES = {
    **{name: spec for name, spec in TARGET_INSTANCES.items() if spec[0] != "potential"},
    "lerp.wells.d50": ("lerp", lambda: MultiWell(dim=50, n_double_wells=5, separation=2.0), 50),
}


@pytest.mark.parametrize("body", DENSE_MODES)
@pytest.mark.parametrize("name", list(DENSE_INSTANCES))
def test_dense_instances_match_plain_twin(cuda, name, body):
    """One step from the plain twin's own states, then the whole rollout,
    in the mode asked for, counted under "<kernel>.<form>.<target>.dense"
    (and a streamed launch once more under "<kernel>.<form>.dense.streamed")
    and not under the FourierMLP's key; the streamed mode gives the bits of
    the resident mode where that takes the shape. The image is held
    one step from the twin's state at every step (its score jumps at pixel
    edges: test_target_instances_match_plain_twin)."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, name, spec=DENSE_INSTANCES[name],
                                            dense=DENSE_ARCH)
    form, _, d = DENSE_INSTANCES[name]
    prepared = prepare(x0, ts, noise)
    if body == "dense" and d >= 50:
        with pytest.raises(RuntimeError):
            ro._launch(prepared, body)
        return
    kernel = "rollout_exp" if form == "exp" else "rollout"
    key = f"{kernel}.{'score' if form == 'exp' else form}.{name.split('.')[1]}"
    T = noise.shape[0]
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = ro._launch(prepared, body)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[f"{key}.dense"] == before[f"{key}.dense"] + 1
    assert build.FORM_LAUNCHES[key] == before[key]
    streamed = f"{'.'.join(key.split('.')[:2])}.dense.streamed"
    assert build.FORM_LAUNCHES[streamed] == before[streamed] + (body == "dense_streamed")
    assert ro.rollout_plan(prepared, body).body == body
    xs_p, xT_p = ro._run_plain(prepared)
    assert bool(torch.isfinite(xs_p).all())
    pixels = "img" in name
    for k in range(T) if pixels else (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        want = xT_p if k == T - 1 else xs_p[k + 1]
        torch.testing.assert_close(x1, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(xs[0], x0)
    if not pixels:
        torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    if body == "dense_streamed" and d < 50:
        xs_r, xT_r = ro._launch(prepared, "dense")
        assert torch.equal(xs, xs_r) and torch.equal(x_T, xT_r)


# The modes that the configs' DenseNet shapes take by shape at the paths'
# batch of 2048 (None: any that fits), each layout within a block's 232,448
# bytes of shared memory: densenet.yaml's [200, 200] at d = 1 (gauss_shift),
# 2 (the mixture), 10 (the funnel), 15 (the Rosenbrock: its resident
# weights and activations take 244,184 bytes), 50 (mw_50d) and 196 (NICE's
# d, a given score), and the body's limit, 8 hidden layers of 1024, at d = 2.
DENSE_SHAPES = {
    "d1": (("lerp", lambda: IsotropicGauss(dim=1, loc=3.0), 1), DENSE_ARCH, "dense"),
    "d2": (("lerp", lambda: GMM(name="grid"), 2), DENSE_ARCH, "dense"),
    "d10": (("score", lambda: Funnel(dim=10, n_reference_samples=100), 10), DENSE_ARCH, "dense"),
    "d15": (("lerp", lambda: Rosenbrock(dim=15, flatness=10.0, scale=1e5), 15), DENSE_ARCH,
            "dense_streamed"),
    "d50": (("lerp", lambda: MultiWell(dim=50, n_double_wells=5, separation=2.0), 50), DENSE_ARCH,
            "dense_streamed"),
    "d196": (("lerp", lambda: Cox(dim=196, use_whitened=True), 196), DENSE_ARCH,
             "dense_streamed"),
    "8x1024": (("lerp", lambda: GMM(name="grid"), 2), (1024,) * 8, None),
}


@pytest.mark.parametrize("name", list(DENSE_SHAPES))
def test_dense_modes_by_shape_fit_a_block(cuda, name):
    """The plan of each configs' shape: the mode it takes by shape, within a
    block's shared memory; at d = 50 one block an SM at 16 rows; the
    resident mode asked for where no block holds its weights raises."""
    from sde_sampler_torch.ops import rollout as ro

    spec, arch, want = DENSE_SHAPES[name]
    prepare, x0, ts, noise = instance_setup(cuda, name, batch=2048, T=2, spec=spec, dense=arch)
    prepared = prepare(x0, ts, noise)
    plan = ro.rollout_plan(prepared)
    assert plan.body in DENSE_MODES and (want is None or plan.body == want)
    assert 0 < plan.smem_bytes <= 232448
    assert plan.blocks * plan.rows >= 2048
    if name == "d50":
        assert (plan.rows, plan.blocks) == (16, 128)
    if name in ("d50", "d196"):
        with pytest.raises(RuntimeError):
            ro._launch(prepared, "dense")


@pytest.mark.parametrize("form", ["lerp", "exp"])
def test_dense_given_score_matches_plain_twin(cuda, form):
    """The given-score form over the DenseNet at Cox's d = 196 (NICE's d):
    the streamed body by shape, one launch a step, within the rollouts'
    tolerance; a FourierMLP body asked for raises."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    spec = (form, lambda: Cox(dim=196, use_whitened=True), 196)
    prepare, x0, ts, noise = instance_setup(cuda, f"{form}.given", spec=spec, dense=DENSE_ARCH)
    kernel = "rollout_exp" if form == "exp" else "rollout"
    key = f"{kernel}.{'score' if form == 'exp' else form}"
    T = noise.shape[0]
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = ro._launch(prepare(x0, ts, noise))
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[f"{key}.given.dense"] == before[f"{key}.given.dense"] + T
    assert build.FORM_LAUNCHES[f"{key}.dense.streamed"] == before[f"{key}.dense.streamed"] + T
    assert build.FORM_LAUNCHES[f"{key}.given"] == before[f"{key}.given"]
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    assert bool(torch.isfinite(xs_p).all())
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    for body in ("fast", "generic", "wide"):
        with pytest.raises(RuntimeError):
            ro._launch(prepare(x0, ts, noise), body)


def test_wide_wells_take_the_generic_body_by_shape(cuda):
    """mw_50d (d = 50) under DIS: the generic body, by shape, at the
    rollout's tolerance."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    spec = ("lerp", lambda: MultiWell(dim=50, n_double_wells=5, separation=2.0), 50)
    prepare, x0, ts, noise = instance_setup(cuda, "lerp.wells.d50", spec=spec)
    before = build.FORM_LAUNCHES["rollout.lerp.generic"]
    xs, x_T = ro._launch(prepare(x0, ts, noise))
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES["rollout.lerp.generic"] == before + 1
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


def test_wide_potential_takes_the_generic_body_by_shape(cuda):
    """The PotentialCtrl at d = 50: the generic body, by shape, at the
    rollout's tolerance; asking for the fast body raises."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    spec = ("potential", None, 50)
    prepare, x0, ts, noise = instance_setup(cuda, "potential.none.d50", spec=spec)
    before = build.FORM_LAUNCHES["rollout.potential.generic"]
    xs, x_T = ro._launch(prepare(x0, ts, noise))
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES["rollout.potential.generic"] == before + 1
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    with pytest.raises(RuntimeError):
        ro._launch(prepare(x0, ts, noise), "fast")


def test_potential_clip_zeroes_the_control_on_the_card(cuda):
    """Rows whose |net| exceeds clip_model get no control: with a clip below
    every row's |net| the kernel integrates the bare SDE, bit for bit the
    plain twin's update with a zero gradient."""
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, "potential.none")
    prepared = prepare(x0, ts, noise)
    prepared[1]["clip_model"] = 0.0
    with torch.no_grad():  # every net output away from 0
        prepared[0][8].fill_(1.0)
    xs, x_T = ro._launch(prepared)
    xs_p, xT_p = ro._run_plain(prepared)
    torch.testing.assert_close(xs, xs_p, atol=1e-6, rtol=1e-6)
    tab = prepared[0][2]
    x = x0
    for k in range(noise.shape[0]):  # the bare EM update, no control
        drift, diff, dt = tab[k, 0], tab[k, 1], tab[k, 2]
        x = x + (drift * x) * dt + diff * noise[k]
    torch.testing.assert_close(x_T, x, atol=1e-6, rtol=1e-6)


# The PotentialCtrl's generic body (csrc/rollout_potential.cu): its register
# path for C = 64, H = 2 at mw_50d's d = 50, by shape at a batch no multiple
# of the plan's rows and with 8 rows a block asked for at 29 rows (a ragged
# last block), at d = 530, the widest the body before its redesign took at
# C = 64, H = 2, and at d = 2, asked for; the tiled body of other nets (C =
# 32 with H = 3, C = 48 with H = 1) at d = 2, 17 and 50. (d, net, batch,
# body asked for, rows asked for)
POTENTIAL_GENERIC = {
    "d50.b509": (50, None, 509, "shape", 0),
    "d50.b29.rows8": (50, None, 29, "generic", 8),
    "d530.b61": (530, None, 61, "shape", 0),
    "d2.b29": (2, None, 29, "generic", 0),
    "d2.c32.h3.b29": (2, dict(channels=32, num_layers=5), 29, "shape", 0),
    "d17.c32.h3.b509": (17, dict(channels=32, num_layers=5), 509, "shape", 0),
    "d50.c48.h1.b61": (50, dict(channels=48, num_layers=3), 61, "generic", 5),
}


@pytest.mark.parametrize("case", list(POTENTIAL_GENERIC))
def test_potential_generic_body_matches_plain_twin(cuda, case):
    """Counted as the generic body; one step from the plain twin's own
    states, then the whole rollout, within the rollouts' tolerance; the plan
    (the same launch asked `dry`) covers every row once within the H100's
    shared memory; a second launch gives the same bits."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    d, net, batch, body, rows = POTENTIAL_GENERIC[case]
    prepare, x0, ts, noise = instance_setup(cuda, f"potential.none.{case}", batch=batch,
                                            spec=("potential", None, d), net=net)
    T = noise.shape[0]
    before = build.FORM_LAUNCHES["rollout.potential.generic"]
    xs, x_T = ro._launch(prepare(x0, ts, noise), body, rows=rows)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES["rollout.potential.generic"] == before + 1
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    assert bool(torch.isfinite(xs_p).all())
    for k in (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body,
                           rows=rows)
        torch.testing.assert_close(x1, xT_p if k == T - 1 else xs_p[k + 1], atol=1e-5,
                                   rtol=1e-5)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    again = ro._launch(prepare(x0, ts, noise), body, rows=rows)
    assert torch.equal(again[0], xs) and torch.equal(again[1], x_T)
    plan = ro.rollout_plan(prepare(x0, ts, noise), body, rows=rows)
    assert plan.body == "generic" and 1 <= plan.rows <= (8 if net is None else 16)
    assert rows == 0 or plan.rows == rows
    assert plan.rows * (plan.blocks - 1) < batch <= plan.rows * plan.blocks
    assert 0 < plan.smem_bytes <= 232448 and plan.slice == 0


@pytest.mark.parametrize("case", ["d2.generic", "d50", "d17.c32.h3"])
def test_potential_clip_zeroes_the_control_in_the_generic_body(cuda, case):
    """test_potential_clip_zeroes_the_control_on_the_card in the generic
    body: its register path asked for at d = 2 and by shape at d = 50, and
    the tiled body of a 32-wide net of three hidden layers."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    d, net = {"d2.generic": (2, None), "d50": (50, None),
              "d17.c32.h3": (17, dict(channels=32, num_layers=5))}[case]
    prepare, x0, ts, noise = instance_setup(cuda, f"potential.none.{case}",
                                            spec=("potential", None, d), net=net)
    prepared = prepare(x0, ts, noise)
    prepared[1]["clip_model"] = 0.0
    with torch.no_grad():  # every net output away from 0
        prepared[0][8].fill_(1.0)
    before = build.FORM_LAUNCHES["rollout.potential.generic"]
    xs, x_T = ro._launch(prepared, "generic")
    assert build.FORM_LAUNCHES["rollout.potential.generic"] == before + 1
    xs_p, xT_p = ro._run_plain(prepared)
    torch.testing.assert_close(xs, xs_p, atol=1e-6, rtol=1e-6)
    tab = prepared[0][2]
    x = x0
    for k in range(noise.shape[0]):  # the bare EM update, no control
        drift, diff, dt = tab[k, 0], tab[k, 1], tab[k, 2]
        x = x + (drift * x) * dt + diff * noise[k]
    torch.testing.assert_close(x_T, x, atol=1e-6, rtol=1e-6)


def test_unsupported_target_instances_raise_before_the_launch(cuda):
    """No quiet fallback on the card: a ClippedCtrl under kernel 2 and a
    score net with two outputs raise (a target without an inline score
    takes the given-score form, test_given_score_instances_match_plain_twin),
    and so does the fast body asked for a given score."""
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, "clipped.none")
    ctrl = ClippedCtrl(base_model=FourierMLP(dim=2), sde=VP()).to(cuda)
    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
        ro.fused_rollout_exp(ctrl, x0, ts, noise, 1.0, 1.0)
    three = ScoreCtrl(base_model=FourierMLP(dim=2), target_score=GMM(name="grid").to(cuda).score,
                      score_model=TimeEmbed(dim_out=3)).to(cuda)
    with pytest.raises(NotImplementedError, match="score net with one output"):
        ro.fused_rollout(three, x0, ts, noise, sde=VP())
    prepare, x0, ts, noise = instance_setup(cuda, "lerp.given", spec=GIVEN["lerp.d196"][:3])
    with pytest.raises(RuntimeError):
        ro._launch(prepare(x0, ts, noise), "fast")


# The given-score form (kernel 1 once a step, after the target's own score
# on the card) on the whitened Cox target: at d = 196 (a 14 x 14 grid,
# NICE's d) in the wide body that its shape takes and in the generic one,
# at the configs' d = 1600 in the wide body by shape; every form with a
# score. (form, Cox's d, body asked for, body expected)
GIVEN = {
    "lerp.d196": ("lerp", lambda: Cox(dim=196, use_whitened=True), 196, "shape", "wide"),
    "lerp.d196.wide": ("lerp", lambda: Cox(dim=196, use_whitened=True), 196, "wide", "wide"),
    "lerp.d196.generic": ("lerp", lambda: Cox(dim=196, use_whitened=True), 196, "generic",
                          "generic"),
    "lerp.d1600": ("lerp", lambda: Cox(dim=1600, use_whitened=True), 1600, "shape", "wide"),
    "score.d196": ("score", lambda: Cox(dim=196, use_whitened=True), 196, "shape", "wide"),
    "lerp_target.d196": ("lerp_target", lambda: Cox(dim=196), 196, "shape", "wide"),
    "cancel_drift.d196": ("cancel_drift", lambda: Cox(dim=196, use_whitened=True), 196,
                          "shape", "wide"),
    "exp.d196": ("exp", lambda: Cox(dim=196, use_whitened=True), 196, "shape", "wide"),
}


@pytest.mark.parametrize("case", list(GIVEN))
def test_given_score_instances_match_plain_twin(cuda, case):
    """One launch a step, counted under "<kernel>.<form>.given" (and
    ".given.wide" in the wide body): one step from the plain twin's own
    states, then the whole rollout, within the rollouts' tolerance; the
    wide body gives the generic body's bits."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    form, make_target, d, body, want = GIVEN[case]
    prepare, x0, ts, noise = instance_setup(cuda, f"{form}.given", spec=(form, make_target, d))
    kernel = "rollout_exp" if form == "exp" else "rollout"
    key = f"{kernel}.{'score' if form == 'exp' else form}"
    T = noise.shape[0]
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = ro._launch(prepare(x0, ts, noise), body)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[f"{key}.given"] == before[f"{key}.given"] + T
    assert build.FORM_LAUNCHES[f"{key}.given.wide"] == (
        before[f"{key}.given.wide"] + T * (want == "wide"))
    assert build.FORM_LAUNCHES[f"{key}.generic"] == (
        before[f"{key}.generic"] + T * (want == "generic"))
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    assert bool(torch.isfinite(xs_p).all())
    for k in (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        want_x = xT_p if k == T - 1 else xs_p[k + 1]
        torch.testing.assert_close(x1, want_x, atol=1e-5, rtol=1e-5)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    if want == "wide" and d == 196:
        xs_g, xT_g = ro._launch(prepare(x0, ts, noise), "generic")
        assert torch.equal(xs, xs_g) and torch.equal(x_T, xT_g)


class GivenGauss(IsotropicGauss):
    """A Gaussian whose score no kernel inlines (TARGETS is an exact-type
    map): the given-score form at any d."""


# The tiled bodies (rollout.cuh: the generic body, by shape past the fast
# body; the wide body, one step of a given score, where the generic body
# would hold fewer than two blocks an SM) at the widths past the fast body
# (d = 17, 33, 50, 60 and 196 no multiple of the 64-wide slices and
# items), at batches no multiple of the plan's rows (1, 509, 2047), with a
# 32-wide and a 3-hidden-layer net, in the lerp, score and clipped forms,
# kernel 2 and the given score. (form, target, d, batch, net, body by shape)
TILED = {
    "lerp.funnel.d17.b509": ("lerp", lambda: Funnel(dim=17, n_reference_samples=100), 17, 509,
                             None, "generic"),
    "score.wells.d33.b1": ("score", lambda: MultiWell(dim=33, n_double_wells=5,
                                                      separation=4.0), 33, 1, None, "generic"),
    "clipped.none.d50.b2047": ("clipped", None, 50, 2047, None, "generic"),
    "lerp.wells.d50.b2047.c32": ("lerp", lambda: MultiWell(dim=50, n_double_wells=5,
                                                           separation=2.0), 50, 2047,
                                 dict(channels=32), "generic"),
    "exp.wells.d50.b509.h3": ("exp", lambda: MultiWell(dim=50, n_double_wells=5,
                                                       separation=4.0), 50, 509,
                              dict(num_layers=5), "generic"),
    "lerp.given.d60.b509.h3": ("lerp", lambda: GivenGauss(dim=60), 60, 509,
                               dict(num_layers=5), "generic"),
    "score.given.d60.b1": ("score", lambda: GivenGauss(dim=60), 60, 1, None, "generic"),
    "score.given.d196.b2047": ("score", lambda: Cox(dim=196, use_whitened=True), 196, 2047,
                               None, "wide"),
    "lerp.given.d196.b509.c32.h3": ("lerp", lambda: Cox(dim=196, use_whitened=True), 196, 509,
                                    dict(channels=32, num_layers=5), "wide"),
    "clipped.none.d196.b509": ("clipped", None, 196, 509, None, "generic"),
    "exp.given.d196.b1": ("exp", lambda: Cox(dim=196, use_whitened=True), 196, 1, None, "wide"),
    "lerp.given.d1600.b509": ("lerp", lambda: Cox(dim=1600, use_whitened=True), 1600, 509,
                              None, "wide"),
    "lerp.given.d1600.b2047": ("lerp", lambda: Cox(dim=1600, use_whitened=True), 1600, 2047,
                               None, "wide"),
}


@pytest.mark.parametrize("case", list(TILED))
def test_tiled_bodies_match_plain_twin(cuda, case):
    """By shape, the body the case names, counted as such; one step from the
    plain twin's own states, then the whole rollout, within the rollouts'
    tolerance; a second launch and launches at 1 and 5 rows a block give
    the same bits; the plan covers every row once within the H100's
    shared memory."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    form, make_target, d, batch, net, want = TILED[case]
    prepare, x0, ts, noise = instance_setup(cuda, case, batch=batch, spec=(form, make_target, d),
                                            net=net)
    kernel = "rollout_exp" if form == "exp" else "rollout"
    key = f"{kernel}.{'score' if form == 'exp' else form}"
    given = "given" in case
    T = noise.shape[0]
    launches = T if given else 1
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = ro._launch(prepare(x0, ts, noise))
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[f"{key}.generic"] == (
        before[f"{key}.generic"] + launches * (want == "generic"))
    if given:
        assert build.FORM_LAUNCHES[f"{key}.given.wide"] == (
            before[f"{key}.given.wide"] + launches * (want == "wide"))
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    assert bool(torch.isfinite(xs_p).all())
    for k in (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]))
        torch.testing.assert_close(x1, xT_p if k == T - 1 else xs_p[k + 1], atol=1e-5,
                                   rtol=1e-5)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    for rows in (0, 1, 5):
        again = ro._launch(prepare(x0, ts, noise), rows=rows)
        assert torch.equal(again[0], xs) and torch.equal(again[1], x_T)
    plan = ro.rollout_plan(prepare(x0, ts, noise))
    assert plan.body == want and 1 <= plan.rows <= 16
    assert plan.rows * (plan.blocks - 1) < batch <= plan.rows * plan.blocks
    assert 0 < plan.smem_bytes <= 232448
    assert plan.slice == (256 if want == "wide" else 0)


@pytest.mark.parametrize("rows", [0, 1, 7, 16])
def test_generic_body_gives_the_fast_bodys_bits_at_any_rows(cuda, rows):
    """A forced generic launch at d <= 16 (the funnel at d = 10, and the
    mixture at d = 2), at the plan's rows a block and at 1, 7 and 16, gives
    the fast body's bits."""
    from sde_sampler_torch.ops import rollout as ro

    for name in ("lerp.gmm", "score.wells"):
        prepare, x0, ts, noise = instance_setup(cuda, name, batch=61)
        fast = ro._launch(prepare(x0, ts, noise), "fast")
        generic = ro._launch(prepare(x0, ts, noise), "generic", rows=rows)
        assert torch.equal(fast[0], generic[0]) and torch.equal(fast[1], generic[1])
    ctrl = lerp_ctrl().to(cuda)
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.normal(size=(61, 10)), dtype=torch.float32, device=cuda)
    ts = torch.linspace(0.0, 1.0, 201, device=cuda)
    dbs = torch.tensor(rng.normal(size=(200, 61, 10)) * 0.07, dtype=torch.float32, device=cuda)
    prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    fast, generic = ro._launch(prepared, "fast"), ro._launch(prepared, "generic", rows=rows)
    assert torch.equal(fast[0], generic[0]) and torch.equal(fast[1], generic[1])


@pytest.mark.parametrize("batch", [1, 509, 512, 2047, 2048])
@pytest.mark.parametrize("d", [50, 60, 196, 1600])
def test_rollout_plan_fills_the_card(cuda, d, batch):
    """The tiled bodies' plan at mw_50d's shape (the generic body, 200 steps
    in a launch), the alanine dipeptide's d = 60 (a given score, the
    generic body) and NICE's and Cox's d = 196 and 1600 (a given score, the
    wide body): every row in one block, at most 16 rows a block, within
    the H100's shared memory. The generic body takes as many blocks as the
    card holds at once, so that from a batch of 512 every multiprocessor
    has work; the wide body one block a multiprocessor, each pass over its
    streamed weights serving the most rows (at 2048 rows, 16 a block: 128
    blocks)."""
    from sde_sampler_torch.ops import rollout as ro

    if d == 50:
        target, T, want = MultiWell(dim=50, n_double_wells=5, separation=2.0), 200, "generic"
    else:
        target = GivenGauss(dim=d) if d == 60 else Cox(dim=d, use_whitened=True)
        T, want = 1, "generic" if d == 60 else "wide"
    prepare, x0, ts, noise = instance_setup(cuda, f"lerp.plan.d{d}", batch=batch, T=T,
                                            spec=("lerp", lambda: target, d))
    plan = ro.rollout_plan(prepare(x0, ts, noise))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.body == want and 1 <= plan.rows <= 16
    assert plan.rows * (plan.blocks - 1) < batch <= plan.rows * plan.blocks
    assert 0 < plan.smem_bytes <= 232448
    if want == "wide":
        assert plan.rows == min(16, -(-batch // sms))
    elif batch >= 512:
        assert plan.blocks >= sms


def test_image_score_casts_saturating_on_the_card(cuda):
    """Far outside the image, at +-inf and NaN the kernel's pixel cast
    saturates (NaN to 0) as the plain twin's: one step of lerp.img from
    such states gives the twin's bits where the twin is finite."""
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, "lerp.img")
    rows = torch.tensor([[1e8, -1e8], [-3e7, 2e9], [math.inf, 0.5], [-math.inf, -math.inf],
                         [math.nan, 0.1], [0.3, math.nan], [1e30, -1e30], [0.0, 0.0]],
                        device=cuda)
    x = x0.clone()
    x[: rows.shape[0]] = rows
    prepared = prepare(x, ts[:2], noise[:1])
    _, got = ro._launch(prepared, "fast")
    _, got_g = ro._launch(prepared, "generic")
    _, want = ro._run_plain(prepared)
    torch.testing.assert_close(got, got_g, atol=0.0, rtol=0.0, equal_nan=True)
    finite = torch.isfinite(want)
    torch.testing.assert_close(got[finite], want[finite], atol=1e-5, rtol=1e-5)
    assert torch.equal(torch.isnan(got), torch.isnan(want))


def test_brownian_tree_is_the_same_path_on_the_card(cuda):
    """The tree's node noise is a counter-based hash: the same int64 bits on
    the card as on the CPU, and W(t) equal up to the float rounding of log,
    cos and the weighted sum (1e-5)."""
    from sde_sampler_torch.eq.integrator import VirtualBrownianTree, splitmix64

    z = torch.arange(-5000, 5000, dtype=torch.int64) * 0x9E3779B1
    assert torch.equal(splitmix64(z.to(cuda)).cpu(), splitmix64(z))
    cpu = VirtualBrownianTree(0.0, 2.0, 3, (256, 3))
    card = VirtualBrownianTree(0.0, 2.0, 3, (256, 3), device=cuda)
    for t in (0.0, 0.37, 1.5, 2.0):
        torch.testing.assert_close(card(t).cpu(), cpu(t), atol=1e-5, rtol=1e-5)


# Score nets of d outputs (model=lerp_dim, score_dim): the per-coordinate
# instances of kernel 1's lerp and score forms and of kernel 2, in the fast
# and the generic body, and with a given score (the whitened Cox process at
# d = 196), each counted under "<kernel>.<form>.dim". (spec, body)
SCORE_DIM = {
    "lerp.funnel.fast": (("lerp", lambda: Funnel(dim=10, n_reference_samples=100), 10), "fast"),
    "lerp.funnel.generic": (("lerp", lambda: Funnel(dim=10, n_reference_samples=100), 10),
                            "generic"),
    "lerp.gmm.fast": (("lerp", lambda: GMM(name="grid"), 2), "fast"),
    "score.funnel.fast": (("score", lambda: Funnel(dim=10, n_reference_samples=100), 10),
                          "fast"),
    "score.wells.generic": (("score", lambda: MultiWell(dim=5, n_double_wells=5,
                                                        separation=4.0), 5), "generic"),
    "exp.funnel.fast": (("exp", lambda: Funnel(dim=10, n_reference_samples=100), 10), "fast"),
    "exp.funnel.generic": (("exp", lambda: Funnel(dim=10, n_reference_samples=100), 10),
                           "generic"),
    "lerp.given.d196": (("lerp", lambda: Cox(dim=196, use_whitened=True), 196), "shape"),
    "lerp_target.gmm.fast": (("lerp_target", lambda: GMM(name="grid"), 2), "fast"),
    "lerp_target.funnel.generic": (("lerp_target", lambda: Funnel(dim=10,
                                                                   n_reference_samples=100),
                                    10), "generic"),
    "cancel_drift.gmm.fast": (("cancel_drift", lambda: GMM(name="grid"), 2), "fast"),
    "cancel_drift.funnel.generic": (("cancel_drift", lambda: Funnel(dim=10,
                                                                     n_reference_samples=100),
                                     10), "generic"),
    "lerp_prior.none.fast": (("lerp_prior", lambda: GMM(name="grid"), 2), "fast"),
    "lerp_prior.none.generic": (("lerp_prior", lambda: IsotropicGauss(dim=10), 10), "generic"),
}


@pytest.mark.parametrize("name", list(SCORE_DIM))
def test_score_dim_instances_match_plain_twin(cuda, name):
    """One step from the plain twin's own states, then the whole rollout,
    within the rollouts' tolerance; counted under ".dim". A table whose d
    columns all equal the one-output column gives the one-output bits."""
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    spec, body = SCORE_DIM[name]
    prepare, x0, ts, noise = instance_setup(cuda, name, spec=spec, score_dim=True)
    form = spec[0]
    key = "rollout_exp.score" if form == "exp" else f"rollout.{form}"
    T = noise.shape[0] if "given" in name else 1
    before = build.FORM_LAUNCHES[f"{key}.dim"]
    prepared = prepare(x0, ts, noise)
    assert prepared[0][2].shape[1] == 6 + spec[2]
    xs, x_T = ro._launch(prepared, body)
    torch.cuda.synchronize()
    assert build.FORM_LAUNCHES[f"{key}.dim"] == before + T
    xs_p, xT_p = ro._run_plain(prepare(x0, ts, noise))
    steps = noise.shape[0]
    for k in (0, steps // 2, steps - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        torch.testing.assert_close(x1, xT_p if k == steps - 1 else xs_p[k + 1], atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    # equal columns: the one-output instance's bits
    tensors, consts, form_, update = prepared
    tab = tensors[2]
    one = tab[:, :6].clone()
    one[:, 4] = tab[:, 6]
    equal = torch.cat([one, one[:, 4:5].expand(-1, tab.shape[1] - 6)], dim=1).contiguous()
    got = ro._launch(([*tensors[:2], equal, *tensors[3:]], consts, form_, update), body)
    want = ro._launch(([*tensors[:2], one, *tensors[3:]], consts, form_, update), body)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("body", ["fast", "generic"])
def test_one_output_net_is_broadcast_on_the_card(cuda, body):
    """A base net of one output outside the potential form (solver=bridge
    model=potential: a LerpTargetCtrl over it) is broadcast over the
    coordinates, as on the CPU: one step from the plain twin's states,
    then the whole rollout."""
    from sde_sampler_torch.ops import rollout as ro

    prepare, x0, ts, noise = instance_setup(cuda, "lerp_target.gmm", net={"dim_out": 1})
    prepared = prepare(x0, ts, noise)
    assert prepared[0][7].shape == (64, 2)  # the out layer's column, twice
    xs, x_T = ro._launch(prepared, body)
    xs_p, xT_p = ro._run_plain(prepared)
    T = noise.shape[0]
    for k in (0, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        torch.testing.assert_close(x1, xT_p if k == T - 1 else xs_p[k + 1], atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)


# The lerp forms' priors: PIS's Delta and a Gauss of unequal coordinates
# (their locs and variances read per coordinate), in the LerpCtrl's and the
# LerpPriorCtrl's form, on the mixture
GAUSS_PRIORS = {
    "delta": lambda: Delta(dim=2),
    "unequal": lambda: Gauss(dim=2, loc=[0.5, -1.0], scale=[1.0, 2.0]),
}


@pytest.mark.parametrize("body", ["fast", "generic", "dense"])
@pytest.mark.parametrize("prior", list(GAUSS_PRIORS))
@pytest.mark.parametrize("form", ["lerp", "lerp_prior"])
def test_gauss_prior_instances_match_plain_twin(cuda, form, prior, body):
    """One step from the plain twin's own states, then the whole rollout,
    in the body asked for (the DenseNet body's too); an IsotropicGauss prior
    and an equal Gauss give the same bits."""
    from sde_sampler_torch.ops import rollout as ro

    spec = (form, lambda: GMM(name="grid"), 2)
    dense = DENSE_ARCH if body == "dense" else None
    prepare, x0, ts, noise = instance_setup(cuda, f"{form}.gmm", spec=spec, dense=dense,
                                            prior=GAUSS_PRIORS[prior]())
    prepared = prepare(x0, ts, noise)
    assert ro.rollout_plan(prepared, body).body == body
    xs, x_T = ro._launch(prepared, body)
    xs_p, xT_p = ro._run_plain(prepared)
    assert bool(torch.isfinite(xs_p).all())
    T = noise.shape[0]
    for k in (0, T // 2, T - 1):
        _, x1 = ro._launch(prepare(xs_p[k].contiguous(), ts[k : k + 2], noise[k : k + 1]), body)
        torch.testing.assert_close(x1, xT_p if k == T - 1 else xs_p[k + 1], atol=1e-5,
                                   rtol=1e-5)
    torch.testing.assert_close(xs, xs_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, xT_p, atol=1e-5, rtol=1e-5)
    outs = []
    for same in (IsotropicGauss(dim=2, loc=0.5, scale=1.5), Gauss(dim=2, loc=0.5, scale=1.5)):
        prepare, x0, ts, noise = instance_setup(cuda, f"{form}.gmm", spec=spec, dense=dense,
                                                prior=same)
        outs.append(ro._launch(prepare(x0, ts, noise), body))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _lerp_on(device, base=None):
    """lerp_ctrl's control with its prior and target on `device` (the scan
    route calls the control itself, scores and all), on `base` if given."""
    prior = IsotropicGauss(dim=10).to(device)
    target = Funnel(dim=10, n_reference_samples=100).to(device)
    ctrl = lerp_ctrl()
    if base is not None:
        ctrl.base_model = base
    ctrl.prior_score, ctrl.target_score = prior.score, target.score
    return ctrl.to(device)


def _scan_loss(ctrl, sim_backend="auto"):
    from sde_sampler_torch.losses.oc import TimeReversalLoss

    clips = {"clip_model": 10.0, "clip_score": 10.0}
    return TimeReversalLoss(generative_ctrl=None, sde=ctrl.sde, method="lv",
                            sim_backend=sim_backend).with_ctrls(
        generative_ctrl=lambda t, x: ctrl(t, x, clips=clips), ctrl_module=ctrl,
        ctrl_clips=clips)


def _phase1_inputs(device, batch=32, T=12, d=10, seed=8):
    rng = np.random.default_rng(seed)
    ts = torch.linspace(0.0, 1.0, T + 1, device=device)
    x0 = torch.tensor(rng.normal(size=(batch, d)), dtype=torch.float32, device=device)
    dbs = torch.tensor(rng.normal(size=(T, batch, d)), dtype=torch.float32, device=device)
    return ts, x0, dbs * torch.sqrt(ts[1:] - ts[:-1])[:, None, None]


def test_scan_route_on_the_card_matches_the_cpu(cuda):
    """A tanh DenseNet base net has no kernel body: phase 1 takes the scan
    route on the card, counted once and launching no rollout kernel, and
    gives the CPU's (xs, x_T) to 1e-4 (cuBLAS and the CPU sum the 200-wide
    layers in another order over 12 steps)."""
    from sde_sampler_torch.ops import build

    base = DenseNet(dim=10, activation="tanh")
    base.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        base.out_layer.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    ts, x0, dbs = _phase1_inputs("cpu")
    want = _scan_loss(_lerp_on("cpu", base))._phase1(ts, x0, dbs, (None, None))
    ctrl = _lerp_on(cuda, base)
    build.reset_launches()
    got = _scan_loss(ctrl)._phase1(ts.to(cuda), x0.to(cuda), dbs.to(cuda), (None, None))
    torch.cuda.synchronize()
    assert build.ROUTES["route.scan"] == 1 and build.LAUNCHES["rollout"] == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


def test_sim_backend_xla_on_the_card_keeps_the_kernel(cuda):
    """sim_backend=xla no longer raises on the card: where a kernel instance
    exists it launches kernel 1, bit for bit `auto`'s rollout, and takes no
    scan route; on a tanh DenseNet base net (no instance) it takes the scan
    route, once."""
    from sde_sampler_torch.ops import build

    ctrl = _lerp_on(cuda)
    ts, x0, dbs = _phase1_inputs(cuda)
    build.reset_launches()
    xla = _scan_loss(ctrl, "xla")._phase1(ts, x0, dbs, (None, None))
    auto = _scan_loss(ctrl, "auto")._phase1(ts, x0, dbs, (None, None))
    torch.cuda.synchronize()
    assert build.ROUTES["route.scan"] == 0 and build.FORM_LAUNCHES["rollout.lerp.funnel"] == 2
    assert all(torch.equal(a, b) for a, b in zip(xla, auto))
    dense = _lerp_on(cuda, DenseNet(dim=10, activation="tanh"))
    _scan_loss(dense, "xla")._phase1(ts, x0, dbs, (None, None))
    torch.cuda.synchronize()
    assert build.ROUTES["route.scan"] == 1 and build.LAUNCHES["rollout"] == 2
