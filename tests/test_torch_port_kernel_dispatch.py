"""The Python side of the port's kernel launches, on the CPU.

The kernels themselves run only on a card (tests/test_torch_port_cuda.py).
What surrounds them is checked here, against a stand-in for the kernel
library: that the rollout wrappers pass the arguments the C interface
declares, let the kernel pick its body by shape and count the body it
reports; that the softmin and transport wrappers allocate the scratch the
library sizes and pass it in the declared order; and that CPU tensors take
the plain versions and never reach the library. The body choice and the
Sinkhorn kernels' splits themselves live in the library and are tested on
the card. No JAX: the plain versions' parity with the JAX package is held
in tests/test_torch_port_{rollout,dds,sinkhorn}.py.
"""
import math
import types

import numpy as np
import pytest
import torch

from sde_sampler_torch.distr.cox import Cox
from sde_sampler_torch.distr.double_well import MultiWell
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.gauss import GMM, IsotropicGauss
from sde_sampler_torch.distr.img import Img
from sde_sampler_torch.distr.rings import Rings
from sde_sampler_torch.distr.rosenbrock import Rosenbrock
from sde_sampler_torch.eq.sdes import VP
from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import (
    CancelDriftCtrl,
    ClippedCtrl,
    LerpCtrl,
    PotentialCtrl,
    ScoreCtrl,
)
from sde_sampler_torch.ops import build
from sde_sampler_torch.ops import rollout as ro
from sde_sampler_torch.ops import sinkhorn as sk


def lerp_ctrl(d=10, **mlp):
    prior, target = IsotropicGauss(dim=d), Funnel(dim=d, n_reference_samples=100)
    ctrl = LerpCtrl(
        base_model=FourierMLP(dim=d, **mlp),
        score_model=TimeEmbed(dim_out=1, num_layers=4),
        sde=VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0),
        prior_score=prior.score, target_score=target.score,
        clip_model=10.0, clip_score=10.0,
    )
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    return ctrl


def score_ctrl(d=10, **mlp):
    ctrl = ScoreCtrl(
        base_model=FourierMLP(dim=d, **mlp),
        score_model=TimeEmbed(dim_out=1, num_layers=4),
        target_score=Funnel(dim=d, n_reference_samples=100).score,
        clip_model=10.0, clip_score=10.0,
    )
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    return ctrl


def rollout_inputs(d, B=5, T=4, seed=0):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32))
    ts = torch.linspace(0.0, 1.0, T + 1)
    dbs = torch.from_numpy(rng.normal(size=(T, B, d)).astype(np.float32)) * 0.1
    return x0, ts, dbs


class FakeLibrary:
    """Stands in for the kernel library: records each launch's arguments (a
    rollout launch's structure as a namespace of its fields, as they were
    at the call), reports the body `body` (a Sinkhorn launch
    `sinkhorn_body`) and the plan `plan`, and returns `code`."""

    def __init__(self, body="fast", code=0, sinkhorn_body="staged"):
        self.calls, self.body, self.code = [], body, code
        self.sinkhorn_body = sinkhorn_body
        self.plan = (16, 3, 4096, 0)

    def rollout_launch(self, args):
        launch = args._obj
        self.calls.append(types.SimpleNamespace(
            **{name: getattr(launch, name) for name, _ in launch._fields_}))
        launch.used = ro.BODY_CODES[self.body]
        launch.plan_rows, launch.plan_blocks, launch.plan_smem, launch.plan_slice = self.plan
        return self.code

    def softmin_scratch(self, n, m, d, splits, cols, rows):
        splits._obj.value, cols._obj.value, rows._obj.value = 3, 1024, 512
        return 17 * n + m

    def transport_scratch(self, n, m, d, splits, cols, rows):
        splits._obj.value, cols._obj.value, rows._obj.value = 5, 2048, 128
        return 13 * m + 2 * n

    def _record(self, *args):
        self.calls.append(args)
        args[-2]._obj.value = {"staged": 0, "wide": 1}[self.sinkhorn_body]  # the `body` out
        return self.code

    softmin_launch = transport_launch = _record


@pytest.fixture
def fake_library(monkeypatch):
    """Lets the launch paths run on CPU tensors against a FakeLibrary."""
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0)
    )
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


def prepared_rollout(form, d=10, T=4, **mlp):
    x0, ts, dbs = rollout_inputs(d, T=T)
    if form == "lerp":
        return ro._prepare(lerp_ctrl(d, **mlp), x0, ts, dbs, None)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    if form == "score":
        return ro._prepare(score_ctrl(d, **mlp), x0, ts, dbs, None, sde)
    return ro._prepare(score_ctrl(d, **mlp), x0, ts, dbs, None, exp=(1.0, 1.0))


@pytest.mark.parametrize("reported", ["fast", "generic"])
@pytest.mark.parametrize("form", ["lerp", "score", "exp"])
def test_rollout_launch_counts_the_body_the_kernel_reports(fake_library, form, reported):
    """The wrapper lets the kernel pick its body by shape and counts the
    launch under the body the kernel reports."""
    fake_library.body = reported
    prepared = prepared_rollout(form, d=7, T=5, channels=16, num_layers=3)
    name = "rollout_exp" if form == "exp" else "rollout"
    key = f"{name}.{'score' if form == 'exp' else form}"
    before = dict(build.FORM_LAUNCHES)
    launches = build.LAUNCHES[name]
    xs, x_T = ro._launch(prepared)
    (args,) = fake_library.calls
    assert (args.B, args.D, args.C, args.H, args.T, args.K) == (5, 7, 16, 1, 5, 0)
    assert args.body == ro.BODY_CODES["shape"] and args.rows == 0 and args.dry == 0
    assert args.target == ro.TARGET_CODES["funnel"]
    assert args.update == (form == "exp")
    if form != "exp":
        assert args.form == ro.FORM_CODES[form]
    assert (args.xs, args.x_T) == (xs.data_ptr(), x_T.data_ptr())
    assert xs.shape == (5, 5, 7) and x_T.shape == (5, 7)
    assert build.LAUNCHES[name] == launches + 1
    assert build.FORM_LAUNCHES[key] == before[key] + 1
    assert build.FORM_LAUNCHES[f"{key}.funnel"] == before[f"{key}.funnel"] + 1
    assert build.FORM_LAUNCHES[f"{key}.generic"] == before[f"{key}.generic"] + (reported == "generic")


@pytest.mark.parametrize("case", ["lerp.gmm", "score.wells", "exp.gmm", "clipped.none",
                                  "lerp.rings", "score.rosenbrock", "cancel_drift.gmm",
                                  "lerp.img", "exp.img"])
def test_rollout_launch_passes_the_target_and_its_table(fake_library, case):
    """The mixture's table (loc, 1/scale², log-weight constants) goes by
    pointer with its K, the rings' radii with their count, the image's
    energy table with its width and height; the wells' count, separation
    and shift, the rings' scale and eps, the Rosenbrock's flatness and the
    image's mean and scale by value; the launch counts under its target."""
    form, target = case.split(".")
    d = 2
    x0, ts, dbs = rollout_inputs(d)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    mixture = GMM(dim=d, loc=[[1.0, 2.0], [-1.0, 0.5], [0.0, 0.0]],
                  scale=[[0.5, 1.0], [2.0, 1.0], [1.0, 1.0]],
                  mixture_weights=[1.0, 2.0, 1.0], domain_tol=None)
    wells = MultiWell(dim=d, n_double_wells=1, separation=3.0, shift=0.5)
    distr = {"gmm": mixture, "wells": wells, "rings": Rings(scale=50.0),
             "rosenbrock": Rosenbrock(dim=d, flatness=4.0),
             "img": Img(mean=(300, 400), scale=(90, 110))}.get(target)
    if form == "lerp":
        ctrl = lerp_ctrl(d)
        ctrl.target_score = distr.score
        prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    elif form == "clipped":
        ctrl = ClippedCtrl(base_model=FourierMLP(dim=d), clip_model=3.0, sde=sde)
        prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    elif form == "cancel_drift":
        ctrl = CancelDriftCtrl(base_model=FourierMLP(dim=d), target_score=distr.score, sde=sde,
                               langevin_init=True)
        prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    else:
        ctrl = ScoreCtrl(base_model=FourierMLP(dim=d), target_score=distr.score)
        exp = (1.0, 1.0) if form == "exp" else None
        prepared = ro._prepare(ctrl, x0, ts, dbs, None, None if exp else sde, exp=exp)
    kernel = "rollout_exp" if form == "exp" else "rollout"
    form_key = "score" if form == "exp" else form
    key = f"{kernel}.{form_key}.{target}"
    before = build.FORM_LAUNCHES[key]
    ro._launch(prepared)
    (args,) = fake_library.calls
    table = prepared[0][9]
    assert args.gmm == (table.data_ptr() or None)
    K = 3 if target in ("gmm", "rings") else 0
    assert args.K == K
    assert (args.tab_w, args.tab_h) == ((700, 700) if target == "img" else (0, 0))
    assert args.target == ro.TARGET_CODES[target]
    if form != "exp":
        assert args.form == ro.FORM_CODES[form]
    scalars = (args.t0, args.t1, args.t2, args.t3)  # float32 fields of the structure
    f32 = lambda *values: tuple(float(np.float32(v)) for v in values)
    if target == "gmm":
        want = torch.cat([mixture.loc.reshape(-1), (1 / mixture.scale**2).reshape(-1),
                          torch.log(torch.tensor([0.25, 0.5, 0.25]))
                          - torch.log(mixture.scale).sum(-1)])
        torch.testing.assert_close(table, want)
    elif target == "wells":
        assert scalars == f32(1.0, 3.0, 0.5, 0.0) and table.numel() == 0
    elif target == "rings":
        torch.testing.assert_close(table, torch.tensor([1.0, 3.0, 5.0]))
        assert scalars == f32(50.0, 1e-8, 0.0, 0.0)
    elif target == "rosenbrock":
        assert scalars == f32(4.0, 0.0, 0.0, 0.0) and table.numel() == 0
    elif target == "img":
        assert torch.equal(table, distr.pixel_energy.reshape(-1))
        assert scalars == f32(300.0, 400.0, 90.0, 110.0)
    else:
        assert table.numel() == 0
    assert build.FORM_LAUNCHES[key] == before + 1


@pytest.mark.parametrize("reported", ["generic", "wide"])
def test_given_score_launches_once_per_step(fake_library, reported):
    """A target without an inline score (Cox) takes the given form: before
    each step the wrapper computes the target's score of the step's state
    and launches one step (T = 1) that reads it from the table's slot, with
    the step's noise, table row and time embedding; the state comes from
    x0, then from xs[k], where the previous launch wrote it, and goes to
    xs[k + 1], the last to x_T. Each launch counts under "given", and under
    "given.wide" in the wide body."""
    fake_library.body = reported
    d, T = 16, 5
    x0, ts, dbs = rollout_inputs(d, T=T)
    target = Cox(dim=d, use_whitened=True)
    seen = []

    def score(x):
        seen.append(x.data_ptr())
        return target.score(x)

    ctrl = ScoreCtrl(base_model=FourierMLP(dim=d), target_score=score)
    prepared = ro._prepare(ctrl, x0, ts, dbs, None, VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0))
    assert prepared[1]["kind"] == "given" and prepared[0][9].numel() == 0
    before = dict(build.FORM_LAUNCHES)
    xs, x_T = ro._launch(prepared)
    assert len(fake_library.calls) == T
    tab, temb = prepared[0][2], prepared[0][3]
    for k, args in enumerate(fake_library.calls):
        state = x0 if k == 0 else xs[k]
        assert seen[k] == state.data_ptr() == args.x0
        assert (args.dbs, args.tab, args.temb) == (
            dbs[k].data_ptr(), tab[k].data_ptr(), temb[k].data_ptr())
        assert args.xs == xs[k].data_ptr()
        assert args.x_T == (x_T if k == T - 1 else xs[k + 1]).data_ptr()
        assert (args.B, args.D, args.C, args.H, args.T, args.K) == (5, d, 64, 2, 1, 0)
        assert args.target == ro.TARGET_CODES["given"] and args.form == ro.FORM_CODES["score"]
    assert build.FORM_LAUNCHES["rollout.score.given"] == before["rollout.score.given"] + T
    assert build.FORM_LAUNCHES["rollout.score.given.wide"] == (
        before["rollout.score.given.wide"] + T * (reported == "wide"))
    assert build.FORM_LAUNCHES["rollout.score.generic"] == (
        before["rollout.score.generic"] + T * (reported == "generic"))


@pytest.mark.parametrize("body", ["fast", "generic"])
def test_rollout_launch_passes_a_requested_body(fake_library, body):
    fake_library.body = body
    ro._launch(prepared_rollout("lerp"), body)
    (args,) = fake_library.calls
    assert args.body == ro.BODY_CODES[body]


@pytest.mark.parametrize("reported", ["fast", "generic"])
def test_potential_rollout_launch_passes_its_one_output_net(fake_library, reported):
    """A PotentialCtrl launches kernel 1's form 5 with no target: the
    out_layer goes as (C, 1), its bias as one float, and the clip_model by
    value; the launch counts as rollout.potential.none."""
    fake_library.body = reported
    d = 3
    x0, ts, dbs = rollout_inputs(d, T=6)
    ctrl = PotentialCtrl(base_model=FourierMLP(dim=d, dim_out=1, channels=16), clip_model=4.0,
                         sde=VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0))
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    prepared = ro._prepare(ctrl, x0, ts, dbs, {"clip_model": 2.5})
    w_out, b_out = prepared[0][7], prepared[0][8]
    assert w_out.shape == (16, 1) and b_out.shape == (1,)
    before = dict(build.FORM_LAUNCHES)
    ro._launch(prepared)
    (args,) = fake_library.calls
    assert args.w_out == w_out.data_ptr() and args.b_out == b_out.data_ptr()
    # B, d, C, H, T, K, the table's width and height, one sscore column
    assert (args.B, args.D, args.C, args.H, args.T, args.K, args.tab_w, args.tab_h,
            args.score_cols) == (5, d, 16, 2, 6, 0, 0, 0, 1)
    assert args.clip_model == 2.5 and math.isinf(args.clip_score)
    assert args.form == ro.FORM_CODES["potential"] == 5
    assert args.target == ro.TARGET_CODES["none"]
    for key in ("rollout.potential", "rollout.potential.none"):
        assert build.FORM_LAUNCHES[key] == before[key] + 1
    assert build.FORM_LAUNCHES["rollout.potential.generic"] == (
        before["rollout.potential.generic"] + (reported == "generic"))


@pytest.mark.parametrize("given", [False, True])
def test_rollout_plan_asks_for_a_dry_launch(fake_library, given):
    """`rollout_plan` passes the launch's structure with `dry` set, the body
    and rows asked for (a given score's as one step), reads back the body
    and plan the library reports, and counts no launch."""
    fake_library.body, fake_library.plan = ("wide", (8, 256, 102912, 64)) if given else (
        "generic", (6, 342, 81920, 0))
    d = 16
    x0, ts, dbs = rollout_inputs(d, T=5)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0)
    target = Cox(dim=d, use_whitened=True) if given else Funnel(dim=d, n_reference_samples=100)
    ctrl = ScoreCtrl(base_model=FourierMLP(dim=d, channels=32), target_score=target.score)
    prepared = ro._prepare(ctrl, x0, ts, dbs, None, sde)
    before = dict(build.LAUNCHES), dict(build.FORM_LAUNCHES)
    plan = ro.rollout_plan(prepared, "shape", rows=3)
    (args,) = fake_library.calls
    assert args.dry == 1 and args.rows == 3 and args.body == ro.BODY_CODES["shape"]
    assert args.T == (1 if given else 5) and args.C == 32
    assert plan == ro.RolloutPlan(fake_library.body, *fake_library.plan)
    assert (build.LAUNCHES, build.FORM_LAUNCHES) == before


@pytest.mark.parametrize("d,reported,plan", [(2, "fast", (8, 1, 42144, 0)),
                                              (50, "generic", (8, 1, 57696, 0))])
def test_potential_rollout_plan_asks_for_a_dry_launch(fake_library, d, reported, plan):
    """The PotentialCtrl's plan comes from the library as the other forms':
    `rollout_plan` passes form 5 with no target, `dry` set and the body and
    rows asked for, reads back the body and plan the library reports, and
    counts no launch."""
    fake_library.body, fake_library.plan = reported, plan
    x0, ts, dbs = rollout_inputs(d, T=5)
    ctrl = PotentialCtrl(base_model=FourierMLP(dim=d, dim_out=1), clip_model=10.0,
                         sde=VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0))
    prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    before = dict(build.LAUNCHES), dict(build.FORM_LAUNCHES)
    got = ro.rollout_plan(prepared, "generic" if d > 16 else "shape", rows=4)
    (args,) = fake_library.calls
    assert args.dry == 1 and args.rows == 4
    assert args.body == ro.BODY_CODES["generic" if d > 16 else "shape"]
    assert args.form == ro.FORM_CODES["potential"] and args.target == ro.TARGET_CODES["none"]
    assert (args.B, args.D, args.C, args.H, args.T) == (5, d, 64, 2, 5)
    assert got == ro.RolloutPlan(reported, *plan)
    assert (build.LAUNCHES, build.FORM_LAUNCHES) == before


def test_failed_rollout_launch_raises_and_counts_nothing(fake_library):
    fake_library.code = 1
    before = dict(build.LAUNCHES), dict(build.FORM_LAUNCHES)
    with pytest.raises(RuntimeError, match="rollout"):
        ro._launch(prepared_rollout("lerp"))
    assert (build.LAUNCHES, build.FORM_LAUNCHES) == before


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (777, 100_000, 10), (100_000, 777, 17)])
def test_softmin_launch_allocates_the_scratch_the_library_sizes(fake_library, monkeypatch, n, m, d):
    sizes = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda size, **kw: sizes.append(size) or empty(size, **kw))
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    x, y, dual = f(rng.normal(size=(n, d))), f(rng.normal(size=(m, d))), f(rng.normal(size=m))
    launches = build.LAUNCHES["softmin"]
    out = sk._softmin_launch(x, y, dual, 0.1)
    (args,) = fake_library.calls
    assert len(args) == len(build.SIGNATURES["softmin_launch"])
    assert args[5:8] == (n, m, d) and args[8] == pytest.approx(0.1)
    assert sizes == [n, 17 * n + m]  # out, then the scratch
    assert out.shape == (n,)
    assert sk.softmin_plan(n, m, d) == (3, 1024, 512, 17 * n + m)
    assert build.LAUNCHES["softmin"] == launches + 1


def transport_inputs(n, m, d):
    rng = np.random.default_rng(1)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return (f(rng.normal(size=(n, d))), f(rng.normal(size=(m, d))),
            f(rng.normal(size=n) * 0.01), f(rng.normal(size=m) * 0.01))


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (777, 100_000, 10), (100_000, 777, 17)])
def test_transport_launch_allocates_the_scratch_the_library_sizes(fake_library, monkeypatch, n, m, d):
    """The wrapper allocates the scalar and the scratch the library reports,
    and passes pointers and sizes in the order the C interface declares."""
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda size, **kw: made.append(empty(size, **kw)) or made[-1])
    x, y, u, v = transport_inputs(n, m, d)
    launches = build.LAUNCHES["transport"]
    total = sk._transport_launch(x, y, u, v, 0.1)
    (args,) = fake_library.calls
    assert len(args) == len(build.SIGNATURES["transport_launch"])
    assert [t.shape for t in made] == [(), (13 * m + 2 * n,)]  # the scalar, then the scratch
    assert total is made[0]
    pointers = [t.data_ptr() for t in (x, y, u, v, *made)]
    assert list(args[:6]) == pointers
    assert args[6:9] == (n, m, d) and args[9] == pytest.approx(0.1)
    assert sk.transport_plan(n, m, d) == (5, 2048, 128, 13 * m + 2 * n)
    assert build.LAUNCHES["transport"] == launches + 1


@pytest.mark.parametrize("reported", ["staged", "wide"])
@pytest.mark.parametrize("name", ["softmin", "transport"])
def test_sinkhorn_launch_counts_the_body_the_library_reports(fake_library, name, reported):
    """The library picks the body by width and reports it: every launch
    counts under the kernel, a wide one once more under "<kernel>.wide"."""
    fake_library.sinkhorn_body = reported
    x, y, u, v = transport_inputs(40, 30, 20)
    before, wide = build.LAUNCHES[name], build.FORM_LAUNCHES[f"{name}.wide"]
    if name == "softmin":
        sk._softmin_launch(x, y, v, 0.1)
    else:
        sk._transport_launch(x, y, u, v, 0.1)
    assert build.LAUNCHES[name] == before + 1
    assert build.FORM_LAUNCHES[f"{name}.wide"] == wide + (reported == "wide")


def test_failed_transport_launch_raises_and_counts_nothing(fake_library):
    fake_library.code = 700
    before = dict(build.LAUNCHES)
    with pytest.raises(RuntimeError, match="transport"):
        sk._transport_launch(*transport_inputs(40, 30, 3), 0.1)
    assert build.LAUNCHES == before


def _no_library():
    raise AssertionError("a CPU tensor reached the kernel library")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    monkeypatch.setattr(build, "library", _no_library)
    before = dict(build.LAUNCHES)
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    x, y = f(rng.normal(size=(40, 3))), f(rng.normal(size=(30, 3)))
    v, u = f(rng.normal(size=30) * 0.01), f(rng.normal(size=40) * 0.01)
    assert torch.equal(sk.softmin(x, y, v, 0.1), sk.softmin_plain(x, y, v, 0.1))
    assert torch.equal(
        sk.transport_cost(x, y, u, v, 0.1), sk.transport_cost_plain(x, y, u, v, 0.1)
    )
    ctrl = lerp_ctrl()
    x0, ts, dbs = rollout_inputs(10)
    for got, want in zip(ro.fused_rollout(ctrl, x0, ts, dbs), ro.rollout_plain(ctrl, x0, ts, dbs)):
        assert torch.equal(got, want)
    sctrl = score_ctrl()
    for got, want in zip(
        ro.fused_rollout_exp(sctrl, x0, ts, dbs, 1.0, 1.0),
        ro.rollout_exp_plain(sctrl, x0, ts, dbs, 1.0, 1.0),
    ):
        assert torch.equal(got, want)
    assert build.LAUNCHES == before


@pytest.mark.parametrize("mode", ["dense", "dense_streamed"])
def test_dense_modes_count_under_their_keys(fake_library, mode):
    """A DenseNet's launch asks for the mode given and counts the one the
    library reports under "rollout.lerp.<target>.dense", the streamed mode
    once more under "rollout.lerp.dense.streamed"; `rollout_plan` reads back
    the plan that the library reports."""
    d = 3
    x0, ts, dbs = rollout_inputs(d, T=3)
    ctrl = LerpCtrl(
        base_model=DenseNet(dim=d, arch=(12, 20)),
        score_model=TimeEmbed(dim_out=1, num_layers=4),
        sde=VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0),
        prior_score=IsotropicGauss(dim=d).score,
        target_score=MultiWell(dim=d, n_double_wells=2, separation=2.0).score,
        clip_model=10.0, clip_score=10.0,
    )
    ctrl.reset_parameters(torch.Generator().manual_seed(0))
    prepared = ro._prepare(ctrl, x0, ts, dbs, None)
    fake_library.body, fake_library.plan = mode, (1, 6, 90112, 8 * (mode == "dense_streamed"))
    build.reset_launches()
    ro._launch(prepared, mode)
    (args,) = fake_library.calls
    assert args.body == ro.BODY_CODES[mode] and args.net == ro.NET_CODES["dense"]
    counted = {k: v for k, v in build.FORM_LAUNCHES.items() if v}
    want = {"rollout.lerp": 1, "rollout.lerp.wells.dense": 1}
    if mode == "dense_streamed":
        want["rollout.lerp.dense.streamed"] = 1
    assert counted == want and build.LAUNCHES["rollout"] == 1
    plan = ro.rollout_plan(prepared, mode)
    assert plan == ro.RolloutPlan(mode, *fake_library.plan)
    assert build.LAUNCHES["rollout"] == 1
