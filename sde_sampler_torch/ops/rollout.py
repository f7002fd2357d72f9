"""Fused rollouts of the SDE controls: kernel 1 (EM) and kernel 2 (DDS).

Port of `fused_sim_rollout` (`sde_sampler_tpu/ops/rollout_pallas.py:68`)
with its two step functions:

- kernel 1, `fused_rollout`: `sde_step_fn` (`:214`), the Euler-Maruyama
  step x' = x + (f(s, x) + σ(s)·u)·dt + σ(s)·db of an OU-family SDE
  (drift c(s)·x, diffusion σ(s)) with Brownian increments db ~ N(0, dt);
- kernel 2, `fused_rollout_exp`: `exp_integrator_step_fn` (`:229`), the
  DDS exponential integrator x' = a·x + β²σ²·u + σβ·ε with
  β = clip(α√dt, 0, 1), a = √(1 − β²) and standard normals ε.

The JAX kernel traces any step function; CUDA cannot, so these are
specialised to control forms over a GELU `FourierMLP` or, in every form but
the potential one, a ReLU `DenseNet` (`conf/model/base/densenet.yaml`; at
most DENSE_MAX_LAYERS hidden layers of at most DENSE_MAX_WIDTH), with an
optional `TimeEmbed` score net, of one output or of d outputs
(`model=lerp_dim`, `score_dim`: a per-coordinate scale of the score term,
a (T, d) table), to the control forms:

- "lerp", a `LerpCtrl` with a Gauss prior (DIS: an `IsotropicGauss`; PIS:
  the `Delta`; any diagonal `Gauss`), its loc and variance passed per
  coordinate (`prior_terms`), kernel 1 only;
- "lerp_target", a `LerpTargetCtrl` (the generative control of
  `solver=bridge`), u = clip(net)·c + σ·sscore·clip(w·target score) with
  no prior term, kernel 1 only;
- "lerp_prior", a `LerpPriorCtrl` (`model=lerp_prior`),
  u = clip(net)·c + σ·sscore·clip(w·prior score) with w = 1 − t/T and no
  target (its hard constraint's factor 2t/T), over the lerp form's priors,
  kernel 1 only;
- "score", a `ScoreCtrl` (PIS and EulerDDS on kernel 1, DDS on kernel 2);
- "clipped", a `ClippedCtrl`, u = clip(net, clip_model) with no score
  (`solver=dis_no_score`, `pis_no_score`), kernel 1 only;
- "potential", a `PotentialCtrl` over a one-output net (`solver=dis_subtraj`,
  `bridge_subtraj`), u = σ(s)·∇ₓclip(net, clip_model): every step runs the
  net forward, keeping its pre-activations, then its backward pass to the
  state, with the clip's gradient 0 where |net| > clip_model; kernel 1 only;
- "cancel_drift", a `CancelDriftCtrl` (`model=langevin_init`),
  u = clip(net) + ((scale·clip(score))·clip(score net) − c(s)·x)/σ(s) with
  scale = σ(s)²/2 under langevin_init (else scale_score), in the JAX
  package's order: the drift is subtracted inside u and added back by the
  EM update; kernel 1 only, on the control's own SDE;

and, for the forms with a target score, to the targets whose score the
kernel evaluates inline (`TARGET_CODES`): "funnel" (`Funnel`), "gmm" (`GMM`,
and `Gauss` and `IsotropicGauss` as one-component mixtures), "wells"
(`DoubleWell`, `MultiWell`), "rings" (`Rings`, d = 2), "rosenbrock"
(`Rosenbrock`) and "img" (`Img`, d = 2). A ClippedCtrl, a PotentialCtrl and
a LerpPriorCtrl have no target ("none"). A base net of one output outside
the potential form is broadcast over the coordinates, as the JAX package's
control broadcasts it. Each target has a float32 table, built on the
tensors' device per call: the mixture's loc (K, d), 1/scale² (K, d) and
log w_k − Σ_j log scale_kj (K), the rings' radii, or the image's energy
table (its width and height by value); and up to four scalars passed by
value: the funnel's first-coordinate variance, the wells' number,
separation and shift, the rings' scale and eps, the Rosenbrock's
flatness, or the image's mean and scale.

Every other target takes the "given" form: its score has no inline form
(Cox's two (B, d) x (d, d) products, NICE's backward pass through the
flow), so the wrapper computes `ctrl.target_score` of each step's state
with torch on the tensors' device and launches the kernel for that one
step (T = 1), which reads the score as a tensor: T launches a rollout.

The wrappers raise on anything else. A DenseNet takes the kernels' DenseNet
body (`csrc/rollout.cuh::rollout_dense_kernel`), its weights resident in
shared memory where they fit at the plan's rows and streamed in K-slices
where they do not; each of its layers' t row and bias are folded into a
per-step table (`step_tables`), as the FourierMLP's time embedding is, and
its launches count under "<kernel>.<form>.<target>.dense" (and the
streamed ones once more under "<kernel>.<form>.dense.streamed"), not under
the FourierMLP's "<kernel>.<form>.<target>". A FourierMLP, on the card,
takes the body the kernel picks by shape (`csrc/rollout.cuh::launch`): the
fast body for the width, depth and dimensions of every model config of the
repo (64 channels, 2 hidden layers, d <= 16, tables that fit shared memory;
never a given score), and otherwise one of two tiled bodies: the generic body, which
stages every weight once and runs all T steps, for any shape whose weights
fit shared memory, or, for a given score, the wide body, which streams the
input and output layers through a ring of slices, where the generic body
would hold fewer than two blocks a multiprocessor (d = 196 and up). Both
choose their rows a block from the batch and the card
(`rollout_plan`). A launch reports the body it took, and the wrapper counts
it (`build.count_launch`: by kernel, by "<kernel>.<form>", by
"<kernel>.<form>.<target>", and once more under "<kernel>.<form>.generic"
for the generic body or "<kernel>.<form>.given.wide" for the wide one).
Everything that depends only on the step start s = ts[k] is computed here,
by plain torch on the tensors' device, as per-step tables; the kernel
(`csrc/rollout.cuh`) or, for a CPU tensor, the plain twin (`rollout_plain`,
`rollout_exp_plain`) then runs the whole loop. All return `xs` (T, B, d),
the state before every step (xs[0] = x0), and `x_T`, the state after the
last one. The rollouts are value-only: nothing here records a gradient.

A loss's phase 1 picks its route from the configuration before anything
runs (`phase1_route`): the kernel instance of `kernel_instance`, or the
scan route (`scan_rollout`, the JAX package's `lax.scan` as a plain torch
loop over the loss's own step) for a base net without a kernel body
(FeedForward, MultilevelNet, a FourierMLP or DenseNet of another
activation, a DenseNet past the body's depth or width, a DenseNet under
the PotentialCtrl),
for exploration of the sde control, or, on a CPU tensor, when
`sim_backend=xla` asks for it. Every other refusal raises. The scan route
is counted under "route.scan" (`build.count_route`), never as a launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sde_sampler_torch.distr.double_well import DoubleWell, MultiWell
from sde_sampler_torch.distr.funnel import Funnel
from sde_sampler_torch.distr.base import Distribution
from sde_sampler_torch.distr.delta import Delta
from sde_sampler_torch.distr.gauss import GMM, Gauss, IsotropicGauss
from sde_sampler_torch.distr.img import Img, img_score
from sde_sampler_torch.distr.rings import Rings, rings_score
from sde_sampler_torch.distr.rosenbrock import Rosenbrock, rosenbrock_score
from sde_sampler_torch.eq.sdes import OU
from sde_sampler_torch.models.mlp import DenseNet, FourierMLP, TimeEmbed
from sde_sampler_torch.models.reparam import (
    CancelDriftCtrl,
    ClippedCtrl,
    LerpCtrl,
    LerpPriorCtrl,
    LerpTargetCtrl,
    PotentialCtrl,
    ScoreCtrl,
    _pick,
)
from sde_sampler_torch.ops import build

# kernel 1's control forms (kernel 2 has only the ScoreCtrl one)
FORM_CODES = {"lerp": 0, "score": 1, "clipped": 3, "lerp_target": 4, "potential": 5,
              "cancel_drift": 6, "lerp_prior": 7}
FORMS = {LerpCtrl: "lerp", ScoreCtrl: "score", ClippedCtrl: "clipped",
         LerpTargetCtrl: "lerp_target", PotentialCtrl: "potential",
         CancelDriftCtrl: "cancel_drift", LerpPriorCtrl: "lerp_prior"}
# the forms without a score, whose control is the net alone
NET_FORMS = ("clipped", "potential")
# the forms that read no target score
NO_TARGET_FORMS = (*NET_FORMS, "lerp_prior")
# the forms that interpolate a score along t / T and roll out their own SDE
LERP_FORMS = ("lerp", "lerp_target", "lerp_prior")
# the forms with a prior score, and the priors whose score the kernel inlines
PRIOR_FORMS = ("lerp", "lerp_prior")
PRIORS = (IsotropicGauss, Gauss, Delta)
# the targets whose score the kernels inline; "given" takes any other score
TARGET_CODES = {"funnel": 0, "gmm": 1, "wells": 2, "none": 3, "rings": 4, "rosenbrock": 5,
                "img": 6, "given": 7}
TARGETS = {Funnel: "funnel", GMM: "gmm", Gauss: "gmm", IsotropicGauss: "gmm",
           DoubleWell: "wells", MultiWell: "wells", Rings: "rings",
           Rosenbrock: "rosenbrock", Img: "img"}
# the body a launch asks for (by shape, or one of the five) and reports: a
# DenseNet's with its weights resident in shared memory or streamed
BODY_CODES = {"shape": 0, "fast": 1, "generic": 2, "wide": 3, "dense": 4, "dense_streamed": 5}
BODY_NAMES = {code: name for name, code in BODY_CODES.items()}
# the base nets of the kernels' bodies (csrc/rollout.cuh kFourierNet, kDenseNet)
NET_CODES = {"fourier": 0, "dense": 1}
# the DenseNet body's hidden layers and their widths at most (kDenseMaxLayers,
# kDenseMaxWidth); the launch structure holds DENSE_MAX_LAYERS widths
DENSE_MAX_LAYERS, DENSE_MAX_WIDTH = build.DENSE_MAX_LAYERS, 1024


def _owner(method, classes):
    """The object a bound score method belongs to, if it is exactly one of
    `classes` and the method is that class's own score."""
    owner = getattr(method, "__self__", None)
    cls = type(owner)
    if cls in classes and getattr(method, "__func__", None) is cls.score:
        return owner
    return None


class NoInstance(NamedTuple):
    """Why no kernel instance runs a control's step: `reason` names the
    refusal ("base_net": a base net without a kernel body, the one refusal
    that the scan route serves), `message` says it."""
    reason: str
    message: str


def net_kind(base, form: str | None = None):
    """The kernel body's kind of base net: "fourier" for a GELU FourierMLP,
    "dense" for a ReLU DenseNet of at most DENSE_MAX_LAYERS hidden layers of
    at most DENSE_MAX_WIDTH, in every form but the potential one; else a
    NoInstance("base_net") naming what is missing."""
    if isinstance(base, FourierMLP) and base.activation == "gelu":
        return "fourier"
    if not isinstance(base, DenseNet) or base.act is not F.relu:
        return NoInstance("base_net", (
            "the rollout kernels need a GELU FourierMLP or a ReLU DenseNet, got a "
            f"{type(base).__name__} of activation {getattr(base, 'activation', None)!r}"))
    if form == "potential":
        return NoInstance("base_net", (
            "the potential form's kernel needs a GELU FourierMLP: it has no DenseNet body"))
    widths = dense_widths(base)
    if len(widths) > DENSE_MAX_LAYERS or max(widths, default=1) > DENSE_MAX_WIDTH:
        return NoInstance("base_net", (
            f"the DenseNet body takes at most {DENSE_MAX_LAYERS} hidden layers of at most "
            f"{DENSE_MAX_WIDTH}, got {widths}"))
    return "dense"


def dense_widths(base: DenseNet) -> tuple[int, ...]:
    return tuple(layer.out_features for layer in base.hidden_layer)


def kernel_instance(ctrl, sde=None, update: str = "em"):
    """(form, sde, prior, target kind, target) of the kernel instance that
    runs `ctrl`'s step, or a NoInstance naming why none does.

    `sde` is the SDE the EM update integrates (a LerpCtrl's,
    LerpTargetCtrl's or CancelDriftCtrl's own, and by default a
    ClippedCtrl's or a PotentialCtrl's); the exponential integrator
    (`update="exp"`) takes none. The base net is checked last, so that a
    control refused for anything else is refused for that.
    """
    form = FORMS.get(type(ctrl))
    if form is None:
        return NoInstance("control", (
            "the rollout kernels need a LerpCtrl, a ScoreCtrl or a ClippedCtrl, a "
            "LerpTargetCtrl, a PotentialCtrl, a CancelDriftCtrl or a LerpPriorCtrl, got "
            f"{type(ctrl).__name__}"))
    if form != "score" and update != "em":
        return NoInstance("update", "the exponential integrator needs a ScoreCtrl")
    base = ctrl.base_model
    score_model = getattr(ctrl, "score_model", None)
    if score_model is not None:
        if not isinstance(score_model, TimeEmbed) or score_model.dim_out not in (
                1, getattr(base, "dim", None)):
            return NoInstance("score_net", (
                "the rollout kernels need a TimeEmbed score net with one output or one "
                "per coordinate"))
    kind, target = "none", None
    if form not in NO_TARGET_FORMS:
        target = _owner(ctrl.target_score, TARGETS)
        if target is not None:
            kind = TARGETS[type(target)]
        else:  # the score of each step is computed before its launch
            kind = "given"
            owner = getattr(ctrl.target_score, "__self__", None)
            target = owner if isinstance(owner, Distribution) else None
    prior = None
    if form in LERP_FORMS or form == "cancel_drift":
        if sde is not None and sde is not ctrl.sde:
            return NoInstance("sde", f"a {type(ctrl).__name__} rolls out its own SDE")
        sde = ctrl.sde
    if form in PRIOR_FORMS:
        prior = _owner(ctrl.prior_score, PRIORS)
        if prior is None:
            return NoInstance("prior", "the rollout kernel needs a Gauss prior (an "
                              "IsotropicGauss, a diagonal Gauss or a Delta)")
    elif form in NET_FORMS and sde is None:
        sde = ctrl.sde
    if update == "em" and (not isinstance(sde, OU) or type(sde).drift is not OU.drift):
        return NoInstance("sde", "the rollout kernel needs an OU-family SDE")
    net = net_kind(base, form)
    if isinstance(net, NoInstance):
        return net
    if form == "potential" and base.out_layer.out_features != 1:
        return NoInstance("potential_net",
                          "the rollout kernel needs a potential net with one output")
    return form, sde, prior, kind, target


def phase1_route(ctrl, sde=None, update: str = "em", sim_backend: str = "auto",
                 explore: bool = False, on_card: bool = False) -> tuple[str, str | None]:
    """The route of a loss's phase 1, decided from the control, the loss's
    configuration and the tensors' device before anything is launched:
    ("kernel", None) for the kernel instance of `kernel_instance` (its plain
    twin on a CPU tensor), or ("scan", reason) for `scan_rollout`.

    - "auto": the kernel wherever an instance exists and the step draws no
      exploration; the scan route for a base net without a kernel body
      ("base_net") or for exploration noise or dropout ("explore");
    - "xla": on a CPU tensor the scan route ("sim_backend=xla"); on the card
      as "auto": an instance that exists is never set aside;
    - "pallas": the kernel, raising where there is none or where the step
      explores.

    Every other refusal of `kernel_instance` raises NotImplementedError,
    whatever the backend.
    """
    step = kernel_instance(ctrl, sde, update)
    missing = step if isinstance(step, NoInstance) else None
    if missing is not None and missing.reason != "base_net":
        raise NotImplementedError(missing.message)
    if sim_backend == "pallas":
        if missing is not None:
            raise NotImplementedError(f"sim_backend=pallas: {missing.message}")
        if explore:
            raise NotImplementedError(
                "sim_backend=pallas: the rollout kernels draw no exploration noise or "
                "dropout of the sde control")
        return "kernel", None
    if explore:
        return "scan", "explore"
    if missing is not None:
        return "scan", missing.reason
    if sim_backend == "xla" and not on_card:
        return "scan", "sim_backend=xla"
    return "kernel", None


@torch.no_grad()
def scan_rollout(step, x0: torch.Tensor, ts: torch.Tensor, noise: torch.Tensor):
    """The scan route of phase 1, the counterpart of the JAX package's
    `lax.scan` simulation: a value-only torch loop over the T = len(ts) - 1
    steps, `x_{k+1} = step(k, x_k)`, for the steps that no kernel instance
    covers (`phase1_route`). Records every pre-step state and returns
    (xs (T, B, d), x_T), as `fused_rollout` does; counts one call under
    "route.scan" (`build.count_route`)."""
    T = noise.shape[0]
    if ts.shape != (T + 1,) or noise.shape[1:] != x0.shape:
        raise ValueError(f"shape mismatch: x0 {tuple(x0.shape)}, ts {tuple(ts.shape)}, "
                         f"noise {tuple(noise.shape)}")
    xs = torch.empty_like(noise)
    x = x0.detach()
    for k in range(T):
        xs[k] = x
        x = step(k, x)
    build.count_route("scan")
    return xs, x


@torch.no_grad()
def exp_coeffs(ts: torch.Tensor, alpha: float, sigma: float):
    """Per-step (a, β²σ², σβ) of the exponential integrator, float32, with
    the JAX package's formula: β = clip(α·sqrt(t − s), 0, 1), a = sqrt(1 − β²)."""
    beta = (alpha * torch.sqrt(ts[1:] - ts[:-1])).clamp(0.0, 1.0)
    return torch.sqrt(1.0 - beta**2), beta**2 * sigma**2, sigma * beta


def per_coord(ctrl) -> bool:
    """Whether `ctrl` scales its score per coordinate: a score net of d > 1
    outputs."""
    score_model = getattr(ctrl, "score_model", None)
    return score_model is not None and score_model.dim_out > 1


@torch.no_grad()
def step_tables(ctrl, sde, ts: torch.Tensor, clips=None, exp=None):
    """Per-step tables: the time-embedding rows (T, C) (a DenseNet's t
    table, `dense_time_table`, in their place) and six scalars per
    step (T, 6) in the column order of csrc/rollout.cuh. EM: drift
    coefficient, diffusion, dt, lerp weight, scale_score * clip(score net)
    (0 for a ClippedCtrl and a PotentialCtrl) and the hard-constraint factor
    of the net output;
    the lerp weight is t / T for the lerp and lerp_target forms, 1 − t / T
    for the lerp_prior form and 0 for the others. A
    CancelDriftCtrl takes the score's scale (σ(s)²/2 under langevin_init,
    else scale_score) in the lerp weight's column and clip(score net) alone
    in the next.
    Exponential integrator (`exp=(alpha, sigma)`): a, β²σ², σβ, 0,
    scale_score * clip(score net), 1.
    A score net of d outputs (`per_coord`) gives (T, 6 + d): its d columns
    of scale_score * clip(score net) follow, and column 4 is NaN, read by
    no instance."""
    s = ts[:-1]
    base = ctrl.base_model
    clip_model = _pick(clips, "clip_model", ctrl.clip_model)
    if isinstance(base, DenseNet):
        temb = dense_time_table(base, s)
    else:
        temb = base.timestep_embed(s) + base.input_embed.bias
    ones = torch.ones_like(s)
    hard = getattr(ctrl, "hard_constrain", False)
    ctrl_scale = ctrl.constrain(ones, s) if hard else ones
    form = FORMS[type(ctrl)]
    if form in NET_FORMS:
        sscore = torch.zeros_like(s)
    elif form == "cancel_drift":
        sscore = ones
    else:
        sscore = ctrl.scale_score * ones
    scale_dim = None
    if getattr(ctrl, "score_model", None) is not None:
        score_net = ctrl.score_model(s)  # (T, 1) or (T, d)
        if clip_model is not None:
            score_net = score_net.clamp(-clip_model, clip_model)
        if hard:
            score_net = ctrl.constrain(score_net, s[:, None])
        if per_coord(ctrl):
            scale_dim = sscore[:, None] * score_net
            sscore = torch.full_like(s, math.nan)
        else:
            sscore = sscore * score_net[:, 0]
    if exp is not None:
        columns = [*exp_coeffs(ts, *exp), torch.zeros_like(s), sscore, ones]
    else:
        diff = sde.diff_coeff_t(s) * ones
        if form == "lerp_prior":
            w = 1.0 - s / sde.terminal_t
        elif form in LERP_FORMS:
            w = s / sde.terminal_t
        elif form == "cancel_drift":
            w = diff**2 / 2 if ctrl.langevin_init else ctrl.scale_score * ones
        else:
            w = torch.zeros_like(s)
        columns = [
            sde.drift_coeff_t(s) * ones,
            diff,
            ts[1:] - s,
            w,
            sscore,
            ctrl_scale,
        ]
    tab = torch.stack(columns, dim=1)
    if scale_dim is not None:
        tab = torch.cat([tab, scale_dim], dim=1)
    return tab.contiguous(), temb.contiguous()


@torch.no_grad()
def target_table(kind: str, target, device) -> tuple[torch.Tensor, tuple, tuple]:
    """The target's table on `device`, its four scalars and the table's
    (width, height): the mixture's loc (K, d), 1/scale² (K, d) and component
    constants log w_k − Σ_j log scale_kj (K), flattened in that order, the
    rings' radii, or the image's energy table (height, width) flattened; the
    funnel's first-coordinate variance, the wells' number, separation and
    shift, the rings' scale and eps, the Rosenbrock's flatness, or the
    image's mean and scale (x, then y)."""
    empty = torch.zeros(0, device=device)
    none = (0.0, 0.0, 0.0, 0.0)
    if kind == "gmm":
        loc, scale = target.loc.to(device), target.scale.to(device)
        const = target.log_mix_weights.to(device) - torch.log(scale).sum(dim=-1)
        table = torch.cat([loc.reshape(-1), (1.0 / scale**2).reshape(-1), const])
        return table.contiguous(), none, (0, 0)
    if kind == "funnel":
        return empty, (target.distr_first.scale0**2, 0.0, 0.0, 0.0), (0, 0)
    if kind == "wells":
        if isinstance(target, MultiWell):
            n, well = target.n_double_wells, target.double_well
        else:
            n, well = 1, target
        return empty, (float(n), well.separation, well.shift, 0.0), (0, 0)
    if kind == "rings":
        radii = target.r_centers.to(device=device, dtype=torch.float32)
        return radii.contiguous(), (target.scale, target.eps, 0.0, 0.0), (0, 0)
    if kind == "rosenbrock":
        return empty, (target.flatness, 0.0, 0.0, 0.0), (0, 0)
    if kind == "img":
        energy = target.pixel_energy.to(device)
        mean, scale = target.mean.tolist(), target.scale.tolist()
        height, width = energy.shape
        return energy.reshape(-1).contiguous(), (*mean, *scale), (width, height)
    return empty, none, (0, 0)


def _weights(base: FourierMLP):
    """Net weights in (in, out) layout; hidden layers stacked."""
    hidden = list(base.hidden_layer)
    C = base.channels
    dev = base.out_layer.weight.device
    w_hid = (
        torch.stack([l.weight.t() for l in hidden])
        if hidden else torch.zeros(0, C, C, device=dev)
    )
    b_hid = torch.stack([l.bias for l in hidden]) if hidden else torch.zeros(0, C, device=dev)
    return [
        base.input_embed.weight.t().contiguous(),
        w_hid.contiguous(),
        b_hid.contiguous(),
        base.out_layer.weight.t().contiguous(),
        base.out_layer.bias.contiguous(),
    ]


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def dense_layers(d: int, widths) -> tuple[list[tuple[int, int, int]], int]:
    """The DenseNet body's layers in its packed weights (csrc/rollout.cuh
    dense_offset): each hidden layer, then the out layer, as (offset, K, N):
    layer l reads K = d + sum(widths[:l]) inputs (the state and the earlier
    layers' activations; the t column is tabulated apart) and writes N =
    widths[l] outputs (d for the out layer), its (K, N) weight in (in, out)
    layout with rows padded to a multiple of 4 floats; and the packed
    floats in all."""
    layers, offset, K = [], 0, d
    for N in (*widths, d):
        layers.append((offset, K, N))
        offset += K * _pad4(N)
        K += N
    return layers, offset


def _dense_modules(base: DenseNet):
    return (*base.hidden_layer, base.out_layer)


def dense_time_table(base: DenseNet, s: torch.Tensor) -> torch.Tensor:
    """A DenseNet's per-step t table (T, sum(widths) + d): each layer's
    t·W[:, 0] + b at the step starts s, the hidden layers' then the out
    layer's, in the packed order of `dense_layers`; the body and its plain
    twin start every sum there."""
    modules = _dense_modules(base)
    t_row = torch.cat([layer.weight[:, 0] for layer in modules])
    bias = torch.cat([layer.bias for layer in modules])
    return s[:, None] * t_row[None] + bias[None]


def _dense_weights(base: DenseNet):
    """A DenseNet's weights without their t column, packed as
    `dense_layers` lays them out (zero in the padding), then four empty
    tensors in the places of the FourierMLP's other weights."""
    d = base.dim
    if base.out_layer.out_features != d:
        raise ValueError(f"the DenseNet outputs {base.out_layer.out_features} values, the state "
                         f"has {d}")
    layers, total = dense_layers(d, dense_widths(base))
    dev = base.out_layer.weight.device
    packed = torch.zeros(total, device=dev)
    for (offset, K, N), layer in zip(layers, _dense_modules(base)):
        packed[offset : offset + K * _pad4(N)].view(K, _pad4(N))[:, :N] = layer.weight[:, 1:].t()
    empty = torch.zeros(0, device=dev)
    return [packed, empty, empty, empty, empty]


def prior_terms(prior: Gauss | None, device):
    """A Gauss prior's loc and variance per coordinate, as its score reads
    them: two (d,) float32 tensors on `device` (an IsotropicGauss's filled
    with its host floats loc0 and scale0², a diagonal Gauss's, a Delta's
    among them, its loc and scale²); (None, None) without a prior."""
    if prior is None:
        return None, None
    if isinstance(prior, IsotropicGauss):
        return tuple(torch.full((prior.dim,), v, dtype=torch.float32, device=device)
                     for v in (prior.loc0, prior.scale0**2))
    loc, scale = (t[0].to(device=device, dtype=torch.float32) for t in (prior.loc, prior.scale))
    return loc.contiguous(), (scale**2).contiguous()


def _consts(ctrl, prior: Gauss | None, clips, device):
    inf = math.inf
    clip_model = _pick(clips, "clip_model", ctrl.clip_model)
    clip_score = _pick(clips, "clip_score", getattr(ctrl, "clip_score", None))
    prior_loc, prior_var = prior_terms(prior, device)
    return dict(
        clip_model=inf if clip_model is None else float(clip_model),
        clip_score=inf if clip_score is None else float(clip_score),
        prior_loc=prior_loc,
        prior_var=prior_var,
    )


def _clip(v, c):
    return v if math.isinf(c) else v.clamp(-c, c)


def _target_score(kind, x, table, scalars, dims=(0, 0), score_fn=None):
    """The target score of the kernel's inline device functions, or the
    given score's."""
    d = x.shape[1]
    if kind == "given":
        return score_fn(x)
    if kind == "img":
        energy = table.reshape(dims[1], dims[0])
        pair = lambda a, b: torch.tensor([a, b], dtype=torch.float32, device=x.device)
        return img_score(x, energy, pair(*scalars[:2]), pair(*scalars[2:]))
    if kind == "funnel":
        first = x[:, :1]
        inv_var_other = torch.exp(-first)
        sq = (x[:, 1:] ** 2).sum(dim=1, keepdim=True)
        return torch.cat(
            [
                (-first / scalars[0] - 0.5 * (d - 1)) + 0.5 * sq * inv_var_other,
                -x[:, 1:] * inv_var_other,
            ],
            dim=1,
        )
    if kind == "gmm":
        K = table.shape[0] // (2 * d + 1)
        loc = table[: K * d].reshape(K, d)
        inv_var = table[K * d : 2 * K * d].reshape(K, d)
        const = table[2 * K * d :]
        diff = x[:, None, :] - loc[None]
        log_w = const - 0.5 * (diff * diff * inv_var).sum(dim=-1)  # (B, K)
        e = torch.exp(log_w - log_w.max(dim=1, keepdim=True).values)
        weighted = (e[:, :, None] * ((loc[None] - x[:, None, :]) * inv_var)).sum(dim=1)
        return weighted / e.sum(dim=1, keepdim=True)
    if kind == "rings":
        return rings_score(x, table, scalars[0], scalars[1])
    if kind == "rosenbrock":
        return rosenbrock_score(x, scalars[0])
    # wells: the first n coordinates in the quartic wells, the rest N(shift, 1)
    n, sep, shift = int(scalars[0]), scalars[1], scalars[2]
    xw = x[:, :n] - shift
    return torch.cat([-4.0 * (xw * xw - sep) * xw, shift - x[:, n:]], dim=1)


def gelu_grad(z):
    """The exact GELU's derivative: ½(1 + erf(z/√2)) + z·exp(−z²/2)/√(2π)."""
    return 0.5 * (1.0 + torch.erf(z * math.sqrt(0.5))) + z * torch.exp(
        -0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _potential_grad(x, temb_k, weights, clip_model):
    """∇ₓclip(net(x), clip_model) of a one-output net by its hand-written
    backward pass (no autograd): the forward keeping the pre-activations
    h_0..h_H, δ_H = w_out ⊙ gelu'(h_H), δ_l = (W_l^T δ_{l+1}) ⊙ gelu'(h_l),
    ∇ₓnet = W_in^T δ_0, set to 0 on rows where |net| > clip_model."""
    w_in, w_hid, b_hid, w_out, b_out = weights
    pre = [x @ w_in + temb_k]
    for l in range(w_hid.shape[0]):
        pre.append(F.gelu(pre[-1]) @ w_hid[l] + b_hid[l])
    net = F.gelu(pre[-1]) @ w_out + b_out  # (B, 1)
    delta = w_out[:, 0] * gelu_grad(pre[-1])
    for l in reversed(range(w_hid.shape[0])):
        delta = (delta @ w_hid[l].T) * gelu_grad(pre[l])
    return torch.where(net.abs() <= clip_model, delta @ w_in.T, 0.0)


def _dense_out(x, temb_k, packed, widths):
    """A DenseNet's output from its packed weights and this step's row of
    its t table: h = x, then h = [h, relu(t_l + h W_l)] for each hidden
    layer, and t_out + h W_out."""
    layers, _ = dense_layers(x.shape[1], widths)
    h, col = x, 0
    for l, (offset, K, N) in enumerate(layers):
        w = packed[offset : offset + K * _pad4(N)].view(K, _pad4(N))[:, :N]
        z = temb_k[col : col + N] + h @ w
        col += N
        if l == len(widths):
            return z
        h = torch.cat([h, F.relu(z)], dim=1)


@torch.no_grad()
def _plain_loop(x0, dbs, tab, temb, weights, target_tab, form, update, *, kind,
                scalars, dims, score_fn, clip_model, clip_score, prior_loc, prior_var, net,
                widths):
    """The kernel's arithmetic in plain PyTorch: the same step, the same tables."""
    w_in, w_hid, b_hid, w_out, b_out = weights
    T = dbs.shape[0]
    xs = torch.empty_like(dbs)
    x = x0.clone()
    for k in range(T):
        drift, diff, dt, w, sscore, cscale = tab[k, :6]
        if tab.shape[1] > 6:  # a per-coordinate sscore
            sscore = tab[k, 6:]
        xs[k] = x
        if form == "potential":
            u = diff * _potential_grad(x, temb[k], weights, clip_model)
            x = x + (drift * x + diff * u) * dt + diff * dbs[k]
            continue
        if net == "dense":
            out = _dense_out(x, temb[k], w_in, widths)
        else:
            h = F.gelu(x @ w_in + temb[k])
            for l in range(w_hid.shape[0]):
                h = F.gelu(h @ w_hid[l] + b_hid[l])
            out = h @ w_out + b_out
        if form == "clipped":
            u = _clip(out, clip_model)
        elif form == "lerp_prior":  # w = 1 - t / T
            lerp = _clip(w * ((prior_loc - x) / prior_var), clip_score)
            u = _clip(out, clip_model) * cscale + diff * (sscore * lerp)
        else:
            target = _target_score(kind, x, target_tab, scalars, dims, score_fn)
            if form == "lerp":
                prior = (prior_loc - x) / prior_var
                lerp = _clip(prior + (target - prior) * w, clip_score)
                u = _clip(out, clip_model) * cscale + diff * (sscore * lerp)
            elif form == "lerp_target":
                lerp = _clip(w * target, clip_score)
                u = _clip(out, clip_model) * cscale + diff * (sscore * lerp)
            elif form == "cancel_drift":  # w holds the score's scale
                score = (w * _clip(target, clip_score)) * sscore
                u = _clip(out, clip_model) + (score - drift * x) / diff
            else:
                u = _clip(out, clip_model) + sscore * _clip(target, clip_score)
        if update == "em":
            x = x + (drift * x + diff * u) * dt + diff * dbs[k]
        else:  # the first three columns hold a, β²σ², σβ
            x = (x * drift + diff * u) + dt * dbs[k]
    return xs, x


@torch.no_grad()
def _prepare(ctrl, x0, ts, dbs, clips, sde=None, exp=None):
    """Checked inputs, tables, weights and constants of one rollout: the
    tensors x0, dbs, the step table, the time table (a DenseNet's t table),
    the five weights (a DenseNet's packed weights and four empty tensors)
    and the target's table; the constants with the net's kind and a
    DenseNet's widths."""
    update = "em" if exp is None else "exp"
    step = kernel_instance(ctrl, sde, update)
    if isinstance(step, NoInstance):
        raise NotImplementedError(step.message)
    form, sde, prior, kind, target = step
    T, B, d = dbs.shape
    if x0.shape != (B, d) or ts.shape != (T + 1,):
        raise ValueError(
            f"shape mismatch: x0 {tuple(x0.shape)}, ts {tuple(ts.shape)}, "
            f"noise {tuple(dbs.shape)}"
        )
    if target is not None and target.dim != d:
        raise ValueError(f"the target has dimension {target.dim}, the state {d}")
    if ctrl.base_model.dim != d:
        raise ValueError(f"the net takes dimension {ctrl.base_model.dim}, the state {d}")
    x0 = x0.detach().contiguous()
    dbs = dbs.detach().contiguous()
    tab, temb = step_tables(ctrl, sde, ts.detach(), clips, exp)
    base = ctrl.base_model
    net = net_kind(base)
    weights = _dense_weights(base) if net == "dense" else _weights(base)
    if net == "fourier" and form != "potential" and weights[3].shape[1] == 1 and d > 1:
        # a net of one output: its column broadcast over the coordinates
        weights[3] = weights[3].expand(-1, d).contiguous()
        weights[4] = weights[4].expand(d).contiguous()
    target_tab, scalars, dims = target_table(kind, target, x0.device)
    tensors = [x0, dbs, tab, temb, *weights, target_tab]
    consts = _consts(ctrl, prior, clips, x0.device)
    priors = [t for t in (consts["prior_loc"], consts["prior_var"]) if t is not None]
    if any(t.dtype != torch.float32 or t.device != x0.device for t in tensors + priors):
        raise TypeError("rollout inputs must be float32 on one device")
    if any(t.shape != (d,) for t in priors):
        raise ValueError(f"the prior has dimension {priors[0].numel()}, the state {d}")
    score_fn = ctrl.target_score if kind == "given" else None
    consts = dict(consts, kind=kind, scalars=scalars, dims=dims,
                  score_fn=score_fn, net=net,
                  widths=dense_widths(base) if net == "dense" else ())
    return tensors, consts, form, update


def _run_plain(prepared):
    (x0, dbs, tab, temb, *weights, target_tab), consts, form, update = prepared
    return _plain_loop(x0, dbs, tab, temb, weights, target_tab, form, update, **consts)


def _check_device(x0):
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")


def rollout_plain(ctrl, x0, ts, dbs, clips=None, sde=None):
    """Plain PyTorch twin of kernel 1 on any device; returns (xs, x_T)."""
    return _run_plain(_prepare(ctrl, x0, ts, dbs, clips, sde))


def rollout_exp_plain(ctrl, x0, ts, noise, alpha, sigma, clips=None):
    """Plain PyTorch twin of kernel 2 on any device; returns (xs, x_T)."""
    return _run_plain(_prepare(ctrl, x0, ts, noise, clips, exp=(alpha, sigma)))


class RolloutPlan(NamedTuple):
    """What a launch of kernel 1 or 2 takes, as the kernel library plans it:
    its body, rows a block, blocks, shared memory in bytes and the slice of
    the wide body (its input-layer rows and output-layer columns) or of the
    streamed DenseNet body (the weight rows of a ring stage); 0 for the
    other bodies."""
    body: str
    rows: int
    blocks: int
    smem_bytes: int
    slice: int


def _launch_args(prepared, body: str, rows: int) -> build.RolloutLaunch:
    """The C launch structure of `prepared` (in the order of `_prepare`),
    on the inputs' stream, for all its steps; a given score's loop moves
    its pointers a step at a time."""
    tensors, c, form, update = prepared
    x0, dbs, tab, temb, _, w_hid, *_, target_tab = tensors
    T, B, d = dbs.shape
    # the table's count: the mixture's components, or the rings' radii
    K = target_tab.numel() // (2 * d + 1) if c["kind"] == "gmm" else (
        target_tab.numel() if c["kind"] == "rings" else 0)
    widths = c["widths"]
    # a FourierMLP's channels and hidden layers; a DenseNet's hidden layers
    C, H = (temb.shape[1], w_hid.shape[0]) if c["net"] == "fourier" else (0, len(widths))
    prior = [None if t is None else t.data_ptr() for t in (c["prior_loc"], c["prior_var"])]
    return build.RolloutLaunch(
        *(t.data_ptr() for t in tensors), 0, 0,
        torch.cuda.current_stream(x0.device).cuda_stream,
        B, d, C, H, T, K, *c["dims"],
        # the columns of sscore a step: one, or d after the six scalars
        tab.shape[1] - 6 if tab.shape[1] > 6 else 1,
        int(update == "exp"), FORM_CODES[form], TARGET_CODES[c["kind"]], BODY_CODES[body], rows, 0,
        c["clip_model"], c["clip_score"], *c["scalars"],
        net=NET_CODES[c["net"]],
        widths=(ctypes.c_int * DENSE_MAX_LAYERS)(*widths),
        prior_loc=prior[0], prior_var=prior[1],
    )


def _call(args: build.RolloutLaunch, name: str) -> None:
    build.check(build.library().rollout_launch(ctypes.byref(args)), name)


def rollout_plan(prepared, body: str = "shape", rows: int = 0) -> RolloutPlan:
    """The plan of a launch of `prepared` (kernel 1 or 2) in `body`, with
    `rows` rows a block asked for (0: the library's choice), launching
    nothing (needs the library, so a CUDA build); a given score's is that
    of each of its one-step launches."""
    args = _launch_args(prepared, body, rows)
    if prepared[1]["kind"] == "given":
        args.T = 1
    args.dry = 1
    _call(args, "rollout_plan")
    return RolloutPlan(BODY_NAMES[args.used], args.plan_rows, args.plan_blocks, args.plan_smem,
                       args.plan_slice)


def _launch(prepared, body: str = "shape", rows: int = 0):
    """Launch the rollout kernel of `prepared` on the inputs' stream: kernel
    1 for an EM update, kernel 2 for the exponential integrator, in the body
    asked for ("shape": the kernel picks) with `rows` rows a block of the
    generic or wide body (0: the plan's); counts each launch under the body
    the kernel reports and returns (xs, x_T). A given score takes one launch
    a step, after its score: the launch structure is filled once, and each
    step sets the pointers of its state, noise, table rows, score and
    outputs."""
    tensors, c, form, update = prepared
    x0, dbs, tab, temb = tensors[:4]
    xs, x_T = torch.empty_like(dbs), torch.empty_like(x0)
    name = "rollout" if update == "em" else "rollout_exp"
    args = _launch_args(prepared, body, rows)
    per_coord = args.score_cols > 1
    if c["kind"] != "given":
        args.xs, args.x_T = xs.data_ptr(), x_T.data_ptr()
        _call(args, name)
        build.count_launch(name, form, c["kind"], body=BODY_NAMES[args.used], per_coord=per_coord)
        return xs, x_T
    T = dbs.shape[0]
    args.T = 1
    score_fn = c["score_fn"]
    # bytes from one step's row of each input to the next
    db_step, tab_step, temb_step = (t.stride(0) * t.element_size() for t in (dbs, tab, temb))
    states = xs.unbind(0)
    x = x0
    for k in range(T):
        score = score_fn(x)
        if score.dtype != torch.float32 or not score.is_contiguous():
            score = score.to(torch.float32).contiguous()
        if score.shape != x.shape or score.device != x.device:
            raise ValueError(f"the target score has shape {tuple(score.shape)} on "
                             f"{score.device}, the state {tuple(x.shape)} on {x.device}")
        out = x_T if k == T - 1 else states[k + 1]
        # xs[k] is x itself after the first step: the kernel leaves it
        args.x0, args.gmm = x.data_ptr(), score.data_ptr()
        args.dbs = dbs.data_ptr() + k * db_step
        args.tab = tab.data_ptr() + k * tab_step
        args.temb = temb.data_ptr() + k * temb_step
        args.xs, args.x_T = states[k].data_ptr(), out.data_ptr()
        _call(args, name)
        build.count_launch(name, form, "given", body=BODY_NAMES[args.used], per_coord=per_coord)
        x = out
    return xs, x_T


@torch.no_grad()
def fused_rollout(ctrl, x0, ts, dbs, clips=None, sde=None):
    """Run all T = len(ts) - 1 EM steps of `sde` under `ctrl`; returns
    (xs, x_T). `dbs` holds the Brownian increments (T, B, d).

    A LerpCtrl integrates its own SDE and reads its prior and target from
    its bound score methods, a LerpTargetCtrl and a CancelDriftCtrl
    likewise without a prior, a LerpPriorCtrl without a target; a
    ClippedCtrl or a PotentialCtrl integrates `sde`, by default its own; a
    ScoreCtrl needs the `sde` (the loss's). A CUDA tensor
    launches kernel 1 (once a step for a given score), a CPU tensor runs
    the plain twin.
    """
    _check_device(x0)
    prepared = _prepare(ctrl, x0, ts, dbs, clips, sde)
    if x0.device.type == "cpu":
        return _run_plain(prepared)
    return _launch(prepared)


@torch.no_grad()
def fused_rollout_exp(ctrl, x0, ts, noise, alpha, sigma, clips=None):
    """Run all T = len(ts) - 1 exponential-integrator steps of the ScoreCtrl
    `ctrl` with standard-normal `noise` (T, B, d); returns (xs, x_T).

    A CUDA tensor launches kernel 2, a CPU tensor runs the plain twin.
    """
    _check_device(x0)
    prepared = _prepare(ctrl, x0, ts, noise, clips, exp=(alpha, sigma))
    if x0.device.type == "cpu":
        return _run_plain(prepared)
    return _launch(prepared)
