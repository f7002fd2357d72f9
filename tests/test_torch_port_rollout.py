"""Fused rollout of the port (kernel 1) vs the JAX package.

On the CPU `fused_rollout` runs its plain twin (`rollout_plain`), which
must match the JAX kernel `fused_sim_rollout` in interpret mode and the
lax.scan reference at B 32, T 12, with the parameters carried across and
the same numpy noise: the flagship stack (LerpCtrl over FourierMLP and a
TimeEmbed score net, VP SDE, funnel target), and each other (form, target)
case of the kernel: the LerpCtrl on the grid mixture (d = 2), on a
MultiWell with Gaussian coordinates (d = 6) and on `mw_50d` (d = 50, the
generic body's shape on the card), the score-free ClippedCtrl,
the LerpCtrl on the rings (d = 2) and on the Rosenbrock (d = 15, whose
score the JAX package takes by `jax.grad`), the CancelDriftCtrl of
`model=langevin_init` on the mixture and the rings, and at d = 1, where the JAX kernel refuses the shape and only its scan
runs, the PIS ScoreCtrl on the shifted double well and the LerpCtrl on the
shifted Gaussian. The LerpCtrl on the image (d = 2, kernel 1's img form),
and the given-score form on the whitened Cox process (d = 1600) and the
smooth NICE flow (d = 196): for these two only the scan, which is what
the JAX loss's phase 1 runs for them (the JAX kernel moves every array
the step closes over into VMEM under a 10 MB budget, and Cox's L^-1 alone
is 10.24 MB). Float32 on both sides, summed in another order: atol
2e-5 + rtol 1e-5, the tolerance of the JAX package's own kernel test
(tests/test_rollout_pallas.py:54). The new cases run the last T steps of
the configs' 200-step grid, where the lerp weight is near 1: at the step
of a 12-step grid the quartic wells' score, of slope up to about 100,
makes each EM step multiply rounding differences by 2 to 3, and the JAX
kernel and its own scan part by 2.5e-4 after 12 steps. The CUDA kernel is held against the
twin in tests/test_torch_port_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.cox import Cox as JCox
from sde_sampler_tpu.distr.double_well import DoubleWell as JDoubleWell
from sde_sampler_tpu.distr.double_well import MultiWell as JMultiWell
from sde_sampler_tpu.distr.gauss import GMM as JGMM
from sde_sampler_tpu.distr.gauss import IsotropicGauss as JIsoGauss
from sde_sampler_tpu.distr.img import Img as JImg
from sde_sampler_tpu.distr.nice import Nice as JNice
from sde_sampler_tpu.distr.rings import Rings as JRings
from sde_sampler_tpu.distr.rosenbrock import Rosenbrock as JRosenbrock
from sde_sampler_tpu.eq.sdes import VP as JVP
from sde_sampler_tpu.eq.sdes import ScaledBM as JScaledBM
from sde_sampler_tpu.models.mlp import FourierMLP as JFourierMLP
from sde_sampler_tpu.models.mlp import TimeEmbed as JTimeEmbed
from sde_sampler_tpu.models.reparam import CancelDriftCtrl as JCancelDriftCtrl
from sde_sampler_tpu.models.reparam import ClippedCtrl as JClippedCtrl
from sde_sampler_tpu.models.reparam import LerpCtrl as JLerpCtrl
from sde_sampler_tpu.models.reparam import ScoreCtrl as JScoreCtrl
from sde_sampler_tpu.ops.rollout_pallas import fused_sim_rollout, sde_step_fn
from sde_sampler_torch.distr.base import Distribution
from sde_sampler_torch.distr.cox import Cox
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.double_well import DoubleWell, MultiWell
from sde_sampler_torch.distr.gauss import GMM, IsotropicGauss
from sde_sampler_torch.distr.img import Img
from sde_sampler_torch.distr.nice import Nice
from sde_sampler_torch.distr.rings import Rings
from sde_sampler_torch.distr.rosenbrock import Rosenbrock
from sde_sampler_torch.eq.sdes import VP, ScaledBM
from sde_sampler_torch.models.mlp import FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import CancelDriftCtrl, ClippedCtrl, LerpCtrl, ScoreCtrl
from sde_sampler_torch.ops.rollout import fused_rollout, fused_rollout_exp
from sde_sampler_torch.utils.params import load_flax_params

from test_torch_port_models import flagship_pair

D, B, T = 10, 32, 12

# the targets of the cases, in both packages: (JAX, port, d)
TARGETS = {
    "gmm": lambda: (JGMM(name="grid"), GMM(name="grid"), 2),
    "mw": lambda: (JMultiWell(dim=6, n_double_wells=2, separation=2.0, shift=0.5),
                   MultiWell(dim=6, n_double_wells=2, separation=2.0, shift=0.5), 6),
    # conf/target/mw_50d.yaml
    "mw_50d": lambda: (JMultiWell(dim=50, n_double_wells=5, separation=2.0),
                       MultiWell(dim=50, n_double_wells=5, separation=2.0), 50),
    "dw_shift": lambda: (JDoubleWell(separation=2.0, shift=1.5),
                         DoubleWell(separation=2.0, shift=1.5), 1),
    "gauss_shift": lambda: (JIsoGauss(dim=1, loc=3.0, scale=1.0),
                            IsotropicGauss(dim=1, loc=3.0, scale=1.0), 1),
    "rings": lambda: (JRings(), Rings(), 2),
    "rosenbrock": lambda: (JRosenbrock(dim=15, flatness=10.0, scale=1e5),
                           Rosenbrock(dim=15, flatness=10.0, scale=1e5), 15),
    "img": lambda: (JImg(n_reference_samples=None), Img(n_reference_samples=None), 2),
    "cox": lambda: (JCox(use_whitened=True), Cox(use_whitened=True), 1600),
    "nice_smooth": lambda: (JNice(checkpoint="data/nice_smooth.npz", n_reference_samples=None),
                            Nice(checkpoint="data/nice_smooth.npz", n_reference_samples=None),
                            196),
}
# the given-score targets, whose JAX phase 1 is the scan
SCAN_ONLY = ("cox", "nice_smooth")
VP_KW = dict(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
BM_KW = dict(diff_coeff=0.4472135954999579, terminal_t=5.0)


def ctrl_pair(form, target):
    """A control of `form` on `target` in both packages (the model configs'
    nets, conf/model/{lerp,score,clipped}.yaml), sharing a perturbed JAX
    init; returns (JAX control, port control, params, d, terminal time)."""
    j_target, p_target, d = TARGETS[target]()
    nets = dict(num_layers=4, channels=64)
    if form == "score":  # PIS: scaled BM
        j_sde, sde = JScaledBM(**BM_KW), ScaledBM(**BM_KW)
    else:
        j_sde, sde = JVP(**VP_KW), VP(**VP_KW)
    if form == "clipped":
        j_ctrl = JClippedCtrl(base_model=JFourierMLP(dim=d, **nets), clip_model=10.0, sde=j_sde)
        ctrl = ClippedCtrl(base_model=FourierMLP(dim=d, **nets), clip_model=10.0, sde=sde)
    else:
        cls, j_cls = {"lerp": (LerpCtrl, JLerpCtrl), "score": (ScoreCtrl, JScoreCtrl),
                      "cancel_drift": (CancelDriftCtrl, JCancelDriftCtrl)}[form]
        common = dict(clip_model=10.0, clip_score=10.0, detach_score=False)
        extra, j_extra = {}, {}
        if form == "cancel_drift":  # conf/model/langevin_init.yaml
            extra = j_extra = dict(langevin_init=True)
        if form == "lerp":
            extra = dict(prior_score=IsotropicGauss(dim=d).score)
            j_extra = dict(prior_score=JIsoGauss(dim=d).score)
        j_ctrl = j_cls(
            base_model=JFourierMLP(dim=d, **nets),
            score_model=JTimeEmbed(dim_out=1, **nets, last_bias_init={"constant": 1.0}),
            sde=j_sde, target_score=j_target.score, **common, **j_extra,
        )
        ctrl = cls(
            base_model=FourierMLP(dim=d, **nets),
            score_model=TimeEmbed(dim_out=1, **nets, last_bias_init={"constant": 1.0}),
            sde=sde, target_score=p_target.score, **common, **extra,
        )
    params = j_ctrl.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, d)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params
    )
    load_flax_params(ctrl, jax.tree_util.tree_map(np.asarray, params))
    return j_ctrl, ctrl, params, d, sde.terminal_t


def inputs(seed=1, d=D, terminal_t=1.0, scale=1.0, start=0.0):
    """x0 (B, d) at standard deviation `scale`, a grid of T steps from
    `start` to `terminal_t`, and Brownian increments on it."""
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(B, d)) * scale).astype(np.float32)
    ts = np.linspace(start, terminal_t, T + 1).astype(np.float32)
    dbs = (rng.normal(size=(T, B, d)) * np.sqrt(np.diff(ts))[:, None, None]).astype(
        np.float32
    )
    return x0, ts, dbs


def jax_rollouts(j_ctrl, params, x0, ts, dbs, clips, kernel=True):
    def apply_ctrl(p, s, x):
        return j_ctrl.apply({"params": p}, s, x, clips=clips)

    sde = j_ctrl.sde
    step = sde_step_fn(apply_ctrl, drift=sde.drift, diff=sde.diff)
    x0, ts, dbs = map(jnp.asarray, (x0, ts, dbs))

    def body(x, inp):
        s, t, db = inp
        return step(params, s, t, x, db), x

    x_T, xs = jax.lax.scan(body, x0, (ts[:-1], ts[1:], dbs))
    if not kernel:  # the JAX kernel refuses d = 1
        return [(xs, x_T)]
    return [fused_sim_rollout(step, params, x0, ts, dbs, block_b=16, interpret=True),
            (xs, x_T)]


CASES = [
    pytest.param("lerp", "funnel", None, id="clips0"),
    pytest.param("lerp", "funnel", {"clip_model": 0.3, "clip_score": 2.0}, id="clips1"),
    pytest.param("lerp", "gmm", {"clip_model": 5.0, "clip_score": 10.0}, id="lerp.gmm"),
    pytest.param("clipped", "gmm", {"clip_model": 0.3}, id="clipped.gmm"),
    pytest.param("lerp", "mw", {"clip_model": 5.0, "clip_score": 10.0}, id="lerp.wells"),
    pytest.param("lerp", "mw_50d", {"clip_model": 5.0, "clip_score": 10.0},
                 id="lerp.wells.mw_50d"),
    pytest.param("score", "dw_shift", {"clip_model": 5.0, "clip_score": 10.0},
                 id="score.wells.d1"),
    pytest.param("lerp", "gauss_shift", None, id="lerp.gmm.d1"),
    pytest.param("lerp", "rings", {"clip_model": 5.0, "clip_score": 10.0}, id="lerp.rings"),
    pytest.param("lerp", "rosenbrock", {"clip_model": 5.0, "clip_score": 10.0},
                 id="lerp.rosenbrock"),
    pytest.param("cancel_drift", "gmm", {"clip_model": 5.0, "clip_score": 10.0},
                 id="cancel_drift.gmm"),
    pytest.param("cancel_drift", "rings", None, id="cancel_drift.rings"),
    pytest.param("lerp", "img", {"clip_model": 5.0, "clip_score": 10.0}, id="lerp.img"),
    pytest.param("lerp", "cox", {"clip_model": 5.0, "clip_score": 10.0}, id="lerp.given.cox"),
    pytest.param("lerp", "nice_smooth", {"clip_model": 5.0, "clip_score": 10.0},
                 id="lerp.given.nice_smooth"),
]


@pytest.mark.parametrize("form,target,clips", CASES)
def test_plain_rollout_matches_jax_kernel_and_scan(form, target, clips):
    if target == "funnel":
        j_ctrl, ctrl, params = flagship_pair()
        d, terminal_t = D, 1.0
    else:
        j_ctrl, ctrl, params, d, terminal_t = ctrl_pair(form, target)
    # the mixture's states spread over its modes, 5 apart; the new cases
    # take the last T steps of the configs' 200-step grid
    start = 0.0 if target == "funnel" else terminal_t * (1 - T / 200)
    x0, ts, dbs = inputs(d=d, terminal_t=terminal_t,
                         scale=3.0 if target in ("gmm", "rings") else 1.0, start=start)
    wants = jax_rollouts(j_ctrl, params, x0, ts, dbs, clips,
                         kernel=d > 1 and target not in SCAN_ONLY)
    xs, x_T = fused_rollout(
        ctrl, torch.from_numpy(x0), torch.from_numpy(ts), torch.from_numpy(dbs), clips,
        sde=ctrl.sde if form == "score" else None,
    )
    assert torch.equal(xs[0], torch.from_numpy(x0))
    assert bool(torch.isfinite(xs).all())
    for want_xs, want_xT in wants:
        np.testing.assert_allclose(xs.numpy(), np.asarray(want_xs), atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(x_T.numpy(), np.asarray(want_xT), atol=2e-5, rtol=1e-5)


def test_plain_twin_matches_the_generic_loop_with_hard_constraint():
    """The per-step tables (incl. the hard-constraint factors) reproduce the
    generic control call step by step (the EM loop of the JAX scan)."""
    _, ctrl, _ = flagship_pair(hard_constrain=True)
    x0, ts, dbs = map(torch.from_numpy, inputs(seed=4))
    clips = {"clip_model": 5.0, "clip_score": 3.0}
    xs, x_T = fused_rollout(ctrl, x0, ts, dbs, clips)
    sde, x, xs_g = ctrl.sde, x0, []
    with torch.no_grad():
        for k in range(T):
            s, t = ts[k], ts[k + 1]
            xs_g.append(x)
            u = ctrl(s, x, clips=clips)
            x = x + (sde.drift(s, x) + sde.diff(s, x) * u) * (t - s) + sde.diff(s, x) * dbs[k]
    torch.testing.assert_close(xs, torch.stack(xs_g), atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(x_T, x, atol=2e-5, rtol=1e-5)


class Ring(Distribution):
    """A target without an inline score in the kernels (autograd score)."""

    def unnorm_log_prob(self, x):
        return -((x.norm(dim=-1, keepdim=True) - 2.0) ** 2)


def test_rollout_raises_on_an_unsupported_step():
    """Controls, score nets and updates the kernels lack raise on the CPU
    as on the card: no plain fallback. A target without an inline score,
    including a subclass of a supported one, takes the given-score form,
    whose twin runs the generic EM loop."""
    _, ctrl, _ = flagship_pair()
    x0, ts, dbs = map(torch.from_numpy, inputs())
    sde = ctrl.sde

    class Subclassed(LerpCtrl):
        pass

    other = Subclassed(base_model=FourierMLP(dim=D), sde=sde, prior_score=ctrl.prior_score,
                       target_score=ctrl.target_score)
    with pytest.raises(NotImplementedError, match="LerpCtrl, a ScoreCtrl or a ClippedCtrl"):
        fused_rollout(other, x0, ts, dbs)
    # the score-free ClippedCtrl runs the EM kernel only
    plain = ClippedCtrl(base_model=FourierMLP(dim=D), sde=sde)
    assert fused_rollout(plain, x0, ts, dbs)[0].shape == dbs.shape
    with pytest.raises(NotImplementedError, match="needs a ScoreCtrl"):
        fused_rollout_exp(plain, x0, ts, dbs, 1.0, 1.0)
    two_outputs = ScoreCtrl(base_model=FourierMLP(dim=D), target_score=ctrl.target_score,
                            score_model=TimeEmbed(dim_out=2))
    with pytest.raises(NotImplementedError, match="score net with one output"):
        fused_rollout(two_outputs, x0, ts, dbs, sde=sde)
    # targets without an inline score, including subclasses of the supported ones
    for target in (Ring(dim=D), Delta(dim=D, loc=0.5)):
        score = ScoreCtrl(base_model=FourierMLP(dim=D), target_score=target.score)
        clips = {"clip_model": 5.0, "clip_score": 10.0}
        xs, x_T = fused_rollout(score, x0, ts, dbs, clips, sde=sde)
        x = x0
        with torch.no_grad():
            for k in range(T):
                torch.testing.assert_close(xs[k], x, atol=2e-5, rtol=1e-5)
                s, t = ts[k], ts[k + 1]
                u = score(s, x, clips=clips)
                x = x + (sde.drift(s, x) + sde.diff(s, x) * u) * (t - s) + sde.diff(s, x) * dbs[k]
        torch.testing.assert_close(x_T, x, atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_rollout(ctrl, x0[:5], ts, dbs)
    mixture = ScoreCtrl(base_model=FourierMLP(dim=D), target_score=GMM(name="grid").score)
    with pytest.raises(ValueError, match="dimension 2"):
        fused_rollout(mixture, x0, ts, dbs, sde=sde)
