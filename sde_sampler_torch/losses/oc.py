"""Trajectory losses: time reversal (DIS, Bridge), reference SDE (PIS,
EulerDDS) and the exponential integrator (DDS).

Port of `BaseOCLoss`, `TimeReversalLoss`, `ReferenceSDELoss`,
`ExponentialIntegratorSDELoss` and the divergence estimators `divx_exact`
and `divx_hutchinson` from `sde_sampler_tpu/losses/oc.py`. Methods kl /
kl_ito / lv / lv_traj; the lv default is the two-phase loss
(`_two_phase_loss`):

- phase 1: the value-only rollout recording every state; it runs the
  generative control alone, which drives the SDE. Its route is decided from
  the configuration before anything runs (`ops/rollout.py::phase1_route`):
  the fused rollouts (kernel 1 for the EM losses, kernel 2 for the
  exponential integrator on the card, their plain twins on the CPU), or
  the scan route (`scan_rollout`, a value-only torch loop, the JAX
  package's `lax.scan`) for a base net without a kernel body, for
  exploration, or with `sim_backend=xla` on the CPU (on the card an
  instance that exists is never set aside); the route is logged once per
  loss and the scan route counted;
- phase 2: one batched control evaluation over all (T, B) states, whose
  running cost and Ito terms autograd differentiates; with a Bridge's
  inference control v, also v and its divergence on all states in one
  batched forward-mode call.

`simulate` (evaluation, and kl training) is a plain torch loop that yields
both log Z estimators from one rollout. Noise enters as an explicit
(T, B, d) tensor `dbs` where a caller passes one (Brownian increments for
the EM losses, standard normals for the exponential integrator), and is
otherwise drawn from the given `torch.Generator`; the probes of a
Hutchinson estimator likewise (`probes`).

Exploration of the log-variance losses (`sde_ctrl_noise`,
`sde_ctrl_dropout`; `generative_and_sde_ctrl` of the JAX package): the
detached control that drives the SDE gets `sde_ctrl_noise` times standard
normals ξ, and is replaced by the neutral control −drift/diff wherever
uniforms υ exceed `sde_ctrl_dropout`, as the JAX package writes it. ξ and υ
(T, B, d) are drawn explicitly (`draw_explore`) or passed (`explore`), and
the same tensors enter phase 1, phase 2's cost and `simulate`.

Data parallelism (`group`, bound by the solver; `parallel/mesh.py`). A call
takes the whole batch, as on one device, and its given draws at the whole
batch's shape. With a group, each rank keeps its row block of the batch
(all traj_per_sample copies of a sample stay on one rank) and of every
draw, which it makes at the global shape: the noise, the exploration
draws, the Hutchinson probes and `simulate`'s per-step normals. So one seed
gives the same global draws whatever the number of ranks. Phase 1 runs the
fused rollout on the rank's rows. The training losses reduce over every
rank (`masked_mean`, `masked_var`): each rank's loss has the
global value and, as its gradient, the rank's share of the global
gradient, so the solver sums the ranks' gradients once. `eval` returns the
whole batch on every rank, gathered once.
"""
from __future__ import annotations

import copy
import logging
import math
from typing import Callable, NamedTuple

import torch

from sde_sampler_torch.parallel import mesh

# Production default of the JAX package: lv/lv_traj train on the two-phase
# path (A/B-validated there against the per-step path).
FAST_PATH_DEFAULT = True

# Ceiling of the (T, B, d) noise buffer of the two-phase loss. Sized for an
# 80 GB card: phase 2 keeps the recorded states, the noise and about ten
# (T, B, width) activations for autograd, so the noise buffer stays below a
# tenth of the card (the main path needs 16 MB).
PREGEN_MAX_BYTES = 8 * 1024**3


# ---------------------------------------------------------------------------
# Divergence estimators (forward-mode JVPs, as the JAX package)
# ---------------------------------------------------------------------------


def divx_exact(fn: Callable, t, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact divergence of fn(t, .) at x (..., d) by d forward-mode JVPs;
    returns (div (..., 1), fn(t, x)). Autograd differentiates both with
    respect to the parameters fn captures (reverse over forward)."""
    f = lambda xx: fn(t, xx)
    d = x.shape[-1]
    if d <= 64:
        # one batched sweep over the basis vectors: a (d, ..., d) buffer
        basis = torch.eye(d, dtype=x.dtype, device=x.device)
        tangents = basis.reshape(d, *([1] * (x.dim() - 1)), d).expand(d, *x.shape)
        value, jvs = torch.func.vmap(
            lambda v: torch.func.jvp(f, (x,), (v,)), out_dims=(None, 0)
        )(tangents)
        div = torch.diagonal(jvs, dim1=0, dim2=-1).sum(dim=-1, keepdim=True)
        return div, value

    # high d: the Jacobian diagonal one coordinate at a time, O(d) live
    # memory instead of O(d^2)
    value = f(x)
    div = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for i in range(d):
        e = torch.zeros(d, dtype=x.dtype, device=x.device)
        e[i] = 1.0
        _, jv = torch.func.jvp(f, (x,), (e.expand_as(x),))
        div = div + jv[..., i : i + 1]
    return div, value


def hutchinson_probes(shape, noise_type: str, generator, device, dtype) -> torch.Tensor:
    """Probes of a Hutchinson estimator: Rademacher signs or standard normals."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    if noise_type == "rademacher":
        return torch.randint(0, 2, shape, **kw) * 2 - 1.0
    if noise_type == "gauss":
        return torch.randn(shape, **kw)
    raise NotImplementedError(f"Undefined noise type {noise_type}.")


def divx_hutchinson(
    fn: Callable, t, x: torch.Tensor, noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None, noise_type: str = "rademacher",
    n_samples: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hutchinson estimator of the divergence of fn(t, .) at x; returns
    (div (..., 1), fn(t, x)). The probes are `noise` (n_samples, *x.shape)
    where given, else `n_samples` draws of `noise_type` from `generator`
    (JAX threefry and torch streams never agree: parity tests pass JAX's)."""
    f = lambda xx: fn(t, xx)
    value = f(x)
    if noise is None:
        noise = hutchinson_probes((n_samples,) + tuple(x.shape), noise_type, generator,
                                  x.device, x.dtype)
    div = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for probe in noise:
        _, jv = torch.func.jvp(f, (x,), (probe,))
        div = div + (jv * probe).sum(dim=-1, keepdim=True)
    return div / noise.shape[0], value


def _at(draws, k):
    return None if draws is None else draws[k]


class _ValueOf(torch.autograd.Function):
    """A tensor whose value is `value` and whose gradient flows into
    `surrogate`, unchanged."""

    @staticmethod
    def forward(ctx, surrogate, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _global_sum_and_count(x, mask, group):
    local = torch.stack([torch.where(mask, x, 0.0).sum().detach(), mask.sum().to(x.dtype)])
    return mesh.all_reduce(local, group)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the masked entries of every rank's rows: on each rank
    its value is the global mean, and its gradient the share of the global
    gradient that this rank's rows give (summed over the ranks, the global
    gradient). Without a group, the mean of x's masked entries."""
    total, n = _global_sum_and_count(x, mask, group).unbind()
    n = n.clamp(min=1)
    return _ValueOf.apply(torch.where(mask, x, 0.0).sum() / n, total / n)


def masked_var(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """The unbiased variance over the masked entries of every rank's rows
    (torch.Tensor.var's), value and gradient as `masked_mean`. The mean m̄
    is global; through it each entry's gradient gains −2S/n/(n − 1), with
    S = Σ (x_i − m̄) over every rank's masked entries (zero but for
    rounding), so S is summed over the ranks with the squares: each rank's
    share is then exact, and one device's gradient is autograd's."""
    total, n = _global_sum_and_count(x, mask, group).unbind()
    n = n.clamp(min=1)
    mu = total / n
    # the square inside the where, as in the JAX package's loss: a
    # non-finite filtered entry still poisons the gradient (0 · inf)
    ss_local = torch.where(mask, (x - mu) ** 2, 0.0).sum()
    s_local = torch.where(mask, x - mu, 0.0).sum().detach()
    ss, s = mesh.all_reduce(torch.stack([ss_local.detach(), s_local]), group).unbind()
    denom = (n - 1).clamp(min=1)
    surrogate = (ss_local - 2 * s / n * torch.where(mask, x, 0.0).sum()) / denom
    return _ValueOf.apply(surrogate, ss / denom)


class RolloutResult(NamedTuple):
    samples: torch.Tensor          # (B, d) terminal states
    rnd: torch.Tensor              # (B, 1) RND including the Ito integral
    rnd_no_ito: torch.Tensor       # (B, 1) RND without the Ito integral
    xs: torch.Tensor | None        # (T+1, B, d) trajectory (optional)


class BaseOCLoss:
    """Shared loss plumbing: filtering, reductions, eval statistics."""

    def __init__(
        self,
        generative_ctrl: Callable | None,
        sde=None,
        method: str = "kl",
        traj_per_sample: int = 1,
        filter_samples: Callable | None = None,
        max_rnd: float | None = None,
        sde_ctrl_dropout: float | None = None,
        sde_ctrl_noise: float | None = None,
        two_phase: bool | None = None,
        sim_backend: str = "auto",
        **kwargs,  # JAX scan knobs (remat, scan_unroll, noise_pregen)
    ):
        self.generative_ctrl = generative_ctrl
        self.sde = sde
        if method not in ["kl", "kl_ito", "lv", "lv_traj"]:
            raise ValueError("Unknown loss method.")
        self.method = method
        if traj_per_sample == 1 and self.method == "lv_traj":
            raise ValueError("Cannot compute variance over a single trajectory.")
        self.traj_per_sample = traj_per_sample
        self.filter_samples = filter_samples
        self.max_rnd = max_rnd
        if sde_ctrl_dropout is not None and sde is None:
            # the JAX package fails here on None.drift when it first traces
            raise ValueError(
                "sde_ctrl_dropout replaces the sde control by the neutral control "
                "-drift/diff of the loss's SDE, and this loss has none (DDS)"
            )
        self.sde_ctrl_noise = sde_ctrl_noise
        self.sde_ctrl_dropout = sde_ctrl_dropout
        if two_phase and method in ("kl", "kl_ito"):
            raise ValueError(
                "two_phase requires a detached-control method (lv/lv_traj); "
                f"got {method}."
            )
        if two_phase is None:
            two_phase = FAST_PATH_DEFAULT and method in ("lv", "lv_traj")
        self.two_phase = two_phase
        # phase 1's route (ops/rollout.py phase1_route): "auto" takes the
        # kernel wherever an instance exists, "xla" the scan route on the
        # CPU and "auto"'s on the card, "pallas" demands the kernel
        if sim_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"Unknown sim_backend {sim_backend}.")
        self.sim_backend = sim_backend
        # bound by the solver (solver/oc.py bound_loss): the control module
        # and its per-call clips, which the fused rollout reads directly
        self.ctrl_module = None
        self.ctrl_clips = None
        # the routes already logged, shared by the copies of `with_ctrls`
        self._routes_logged: set = set()
        # the data-parallel group (bound by the solver) and the rows of the
        # global batch that this rank holds in the current call (`_enter`)
        self.group = None
        self._rows: mesh.Rows | None = None

    # -- data parallelism -------------------------------------------------------
    def _enter(self, x, dbs=None, explore=None, probes=None, train=True):
        """The call's batch: x (in training with its traj_per_sample copies)
        and, with a group, this rank's rows of it and of the given draws
        (each of the global batch, on axis -2), whose rows the call's own
        draws keep too."""
        n = x.shape[0]
        repeat = self.traj_per_sample if train else 1
        if train:
            x = self._repeat_traj(x)
        self._rows = None
        if self.group is None:
            return x, dbs, explore, probes
        self._rows = mesh.Rows(n, self.group, repeat=repeat)

        def take(t):
            return None if t is None else self._rows.take(t, -2).contiguous()

        if explore is not None:
            explore = tuple(take(t) for t in explore)
        return take(x), take(dbs), explore, take(probes)

    def _draw(self, draw: Callable, shape) -> torch.Tensor:
        """draw(shape); in a sharded call, drawn at the global batch (axis -2
        of shape) and this rank's rows of it kept."""
        rows = self._rows
        if rows is None:
            return draw(tuple(shape))
        shape = tuple(shape[:-2]) + (rows.total, shape[-1])
        return rows.take(draw(shape), -2).contiguous()

    def _gather(self, result: "RolloutResult") -> "RolloutResult":
        """The whole batch's rollout on every rank from the ranks' rows."""
        if self._rows is None:
            return result
        sizes = mesh.block_sizes(self._rows.n, mesh.world(self.group))

        def gather(t, dim=0):
            return None if t is None else mesh.all_gather_rows(t, self.group, sizes, dim)

        return RolloutResult(gather(result.samples), gather(result.rnd),
                             gather(result.rnd_no_ito), gather(result.xs, 1))

    # -- exploration of the sde control -------------------------------------
    @property
    def explores(self) -> bool:
        """Whether the sde control of the log-variance losses explores."""
        return self.sde_ctrl_noise is not None or self.sde_ctrl_dropout is not None

    def draw_explore(self, ts, x, generator=None):
        """Exploration draws of every step, (ξ, υ): standard normals and
        uniforms on [0, 1) of shape (T, B, d), for the noise and the dropout
        of the sde control; each None where its knob is unset."""
        shape = (ts.shape[0] - 1,) + tuple(x.shape)
        kw = dict(generator=generator, device=x.device, dtype=x.dtype)
        xi = (self._draw(lambda shp: torch.randn(shp, **kw), shape)
              if self.sde_ctrl_noise is not None else None)
        ups = (self._draw(lambda shp: torch.rand(shp, **kw), shape)
               if self.sde_ctrl_dropout is not None else None)
        return xi, ups

    def explore_sde_ctrl(self, sde_ctrl, s, x, xi=None, ups=None):
        """The detached control with exploration (`generative_and_sde_ctrl`
        of the JAX package): plus sde_ctrl_noise·ξ, then the neutral control
        −drift(s, x)/diff(s, x) wherever υ > sde_ctrl_dropout."""
        if xi is not None:
            sde_ctrl = sde_ctrl + self.sde_ctrl_noise * xi
        if ups is not None:
            neutral = -(self.sde.drift(s, x) / self.sde.diff(s, x))
            sde_ctrl = torch.where(ups > self.sde_ctrl_dropout,
                                   neutral.expand_as(sde_ctrl), sde_ctrl)
        return sde_ctrl

    def _explore_inputs(self, ts, x, explore, generator):
        """The exploration draws of a log-variance call: `explore` where
        given, else drawn when the loss explores; (None, None) otherwise."""
        if explore is not None:
            return explore
        if self.explores:
            return self.draw_explore(ts, x, generator)
        return None, None

    # -- phase 1 ----------------------------------------------------------------
    # phase 1's update: "em" integrates the loss's SDE (kernel 1), as the
    # scan route's step and the JAX package's kernel step do, whatever the
    # control; "exp" the exponential integrator (kernel 2), which takes no SDE
    update = "em"

    def phase1_route(self, on_card: bool = False) -> tuple[str, str | None]:
        """The route of phase 1 for the bound control (`ops/rollout.py::
        phase1_route`); raises where no route runs it."""
        from sde_sampler_torch.ops import rollout

        sde = self.sde if self.update == "em" else None
        return rollout.phase1_route(self.ctrl_module, sde, self.update, self.sim_backend,
                                    self.explores, on_card=on_card)

    def _phase1(self, ts, x, noise, explore):
        """Value-only rollout recording every pre-step state: (xs, x_T),
        through the route that `phase1_route` picks (logged once per loss)."""
        from sde_sampler_torch.ops import rollout

        route, reason = self.phase1_route(on_card=x.device.type == "cuda")
        if (route, reason) not in self._routes_logged:
            self._routes_logged.add((route, reason))
            logging.info("Phase 1 of %s takes the %s route%s.", type(self).__name__,
                         route, "" if reason is None else f" ({reason})")
        if route == "kernel":
            return self._kernel_rollout(ts, x, noise)
        return rollout.scan_rollout(self._scan_step(ts, noise, explore), x, ts, noise)

    def _kernel_rollout(self, ts, x, dbs):
        from sde_sampler_torch.ops.rollout import fused_rollout

        return fused_rollout(self.ctrl_module, x, ts, dbs, self.ctrl_clips, sde=self.sde)

    def _scan_step(self, ts, dbs, explore):
        """The scan route's EM step k: x + (f(s, x) + σ(s)·u)·dt + σ(s)·db_k
        with the (exploring) detached control u, as the JAX scan's body."""
        xi, ups = explore

        def step(k, x):
            s, dt = ts[k], ts[k + 1] - ts[k]
            u = self.explore_sde_ctrl(self.generative_ctrl(s, x), s, x,
                                      _at(xi, k), _at(ups, k))
            diff = self.sde.diff(s, x)
            return x + (self.sde.drift(s, x) + diff * u) * dt + diff * dbs[k]

        return step

    # -- noise ----------------------------------------------------------------
    @staticmethod
    def draw_noise(ts, x, generator=None, scale_sqrt_dt: bool = True,
                   rows: mesh.Rows | None = None) -> torch.Tensor:
        """Noise of every step, (T, B, d): Brownian increments dW ~ N(0, dt),
        or standard normals with `scale_sqrt_dt=False` (the exponential
        integrator scales them itself). With `rows`, drawn at the global
        batch and this rank's rows kept."""
        n = ts.shape[0] - 1
        shape = (n,) + tuple(x.shape)
        if rows is not None:
            shape = (n, rows.total) + tuple(x.shape[1:])
        nbytes = math.prod(shape) * x.element_size()
        if nbytes > PREGEN_MAX_BYTES:
            raise ValueError(
                f"noise buffer of shape {shape} needs {nbytes} "
                f"bytes, above PREGEN_MAX_BYTES={PREGEN_MAX_BYTES}"
            )
        dbs = torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)
        if rows is not None:
            dbs = rows.take(dbs, 1).contiguous()
        if not scale_sqrt_dt:
            return dbs
        return dbs * torch.sqrt(ts[1:] - ts[:-1])[:, None, None]

    # -- filtering & loss reduction -----------------------------------------
    def filter(self, rnd, samples=None):
        mask = torch.ones_like(rnd, dtype=torch.bool)
        if samples is not None and self.filter_samples is not None:
            filt = self.filter_samples(samples)
            if filt.shape != rnd.shape:
                raise ValueError(
                    f"filter_samples must return shape {tuple(rnd.shape)}, "
                    f"got {tuple(filt.shape)}"
                )
            mask = mask & filt
        if self.max_rnd is None:
            return mask & torch.isfinite(rnd)
        return mask & (rnd < self.max_rnd)

    def compute_loss(self, rnd, samples=None):
        """The loss of the rows' RNDs and the count of filtered ones, over
        every rank's rows with a group."""
        mask = self.filter(rnd, samples=samples)
        if self.method == "lv_traj":
            r = self.traj_per_sample
            rnd = rnd.reshape(r, -1, 1)
            mask = mask.reshape(r, -1, 1).all(dim=0)
            n_filtered = r * (mask.numel() - mask.sum())
            mu = rnd.mean(dim=0, keepdim=True)
            var = ((rnd - mu) ** 2).sum(dim=0) / (r - 1)
            loss = masked_mean(var, mask, self.group)
        else:
            n_filtered = mask.numel() - mask.sum()
            if self.method == "lv":
                loss = masked_var(rnd, mask, self.group)
            else:
                loss = masked_mean(rnd, mask, self.group)
        return loss, {"train/n_filtered": mesh.all_reduce(n_filtered, self.group)}

    @staticmethod
    @torch.no_grad()
    def compute_results_arrays(rnd, rnd_no_ito, max_rnd: float | None = None) -> dict:
        """Eval statistics: both log Z estimators (and their finite and
        max_rnd-filtered diagnostics), the importance weights and the LV."""
        neg_rnd = -rnd
        log_weights_max = neg_rnd.max()
        weights = torch.exp(neg_rnd - log_weights_max)

        def masked(v, mask):
            return torch.where(mask, v, 0.0).sum() / mask.sum().clamp(min=1)

        fin = torch.isfinite(rnd)
        filt = fin if max_rnd is None else fin & (rnd < max_rnd)
        fin_no_ito = torch.isfinite(rnd_no_ito)
        filt_no_ito = (
            fin_no_ito if max_rnd is None
            else fin_no_ito & (rnd_no_ito < max_rnd)
        )
        return {
            "weights": weights,
            "log_norm_const_lb_ito": neg_rnd.mean(),
            "log_norm_const_is": torch.log(weights.mean()) + log_weights_max,
            "log_norm_const_lb": (-rnd_no_ito).mean(),
            "log_norm_const_lb_ito_finite": masked(neg_rnd, fin),
            "log_norm_const_lb_finite": masked(-rnd_no_ito, fin_no_ito),
            "log_norm_const_lb_ito_filtered": masked(neg_rnd, filt),
            "log_norm_const_lb_filtered": masked(-rnd_no_ito, filt_no_ito),
            "n_nonfinite_rnd": (~fin).sum(),
            "n_filtered_rnd": (~filt).sum(),
            "lv_loss": rnd.var(),
        }

    def _repeat_traj(self, x):
        if self.traj_per_sample != 1:
            x = x[None].repeat(self.traj_per_sample, 1, 1)
            x = x.reshape(-1, x.shape[-1])
        return x

    def with_ctrls(self, **kwargs) -> "BaseOCLoss":
        """Shallow copy with the control callables bound."""
        new = copy.copy(self)
        for name, value in kwargs.items():
            setattr(new, name, value)
        return new


class TimeReversalLoss(BaseOCLoss):
    """Time-reversal RND loss (DIS; Bridge when inference_ctrl is given):
    running cost ½|u+v|²dt (KL) or (u+v)·(ū−½(u−v))dt (LV) for the
    generative control u and the inference control v (0 for DIS),
    inference-divergence term σ·div(v)dt, Ito integral (u+v)·dW, eval-only
    −∫div(drift) and initial log-prob, terminal −log ρ(X_T). The divergence
    is exact (`div_estimator` None, and always at evaluation) or
    Hutchinson's estimator with "rademacher" or "gauss" probes."""

    def __init__(
        self,
        *args,
        inference_ctrl: Callable | None = None,
        div_estimator: str | None = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if div_estimator not in (None, "rademacher", "gauss"):
            raise ValueError(f"Unknown div_estimator {div_estimator}.")
        self.inference_ctrl = inference_ctrl
        self.div_estimator = div_estimator

    def _inference_terms(self, gen, s, x, estimator, probes=None, generator=None):
        """(u + v, u − v, div v) for the generative control's output `gen`
        and the inference control v at (s, x); (u, u, None) without one.
        `probes` (..., d) are the Hutchinson probes of these states."""
        if self.inference_ctrl is None:
            return gen, gen, None
        if estimator is None:
            div, inference = divx_exact(self.inference_ctrl, s, x)
        else:
            if probes is None and self._rows is not None:
                probes = self._draw(lambda shp: hutchinson_probes(
                    shp, estimator, generator, x.device, x.dtype), x.shape)
            div, inference = divx_hutchinson(
                self.inference_ctrl, s, x, noise=None if probes is None else probes[None],
                generator=generator, noise_type=estimator,
            )
        return gen + inference, gen - inference, div

    def simulate(
        self,
        ts: torch.Tensor,
        x: torch.Tensor,
        terminal_unnorm_log_prob: Callable,
        initial_log_prob: Callable | None = None,
        train: bool = True,
        change_sde_ctrl: bool = False,
        return_traj: bool = False,
        dbs: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        probes: torch.Tensor | None = None,
        explore: tuple | None = None,
    ) -> RolloutResult:
        """One EM rollout accumulating the RND with and without Ito term;
        `probes` (T, B, d) feed a Hutchinson estimator in training, and
        `explore` (ξ, υ) the exploration of the detached control."""
        xi, ups = explore or (None, None)
        estimator = self.div_estimator if train else None
        if train and self.method in ["kl", "kl_ito"]:
            rnd = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        else:
            rnd = initial_log_prob(x)
        ito = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        traj = [x] if return_traj else None
        for k in range(ts.shape[0] - 1):
            s, t = ts[k], ts[k + 1]
            dt = t - s
            if dbs is not None:
                db = dbs[k]
            else:
                db = self._draw(lambda shp: torch.randn(
                    shp, generator=generator, device=x.device, dtype=x.dtype
                ), x.shape) * torch.sqrt(dt)
            gen = self.generative_ctrl(s, x)
            sde_ctrl = gen
            if change_sde_ctrl:
                sde_ctrl = self.explore_sde_ctrl(gen.detach(), s, x, _at(xi, k), _at(ups, k))
            sde_diff = self.sde.diff(s, x)
            gen_plus, gen_minus, div = self._inference_terms(
                gen, s, x, estimator, None if probes is None else probes[k], generator
            )
            if div is not None:
                # assumes the diffusion coefficient is independent of x
                rnd = rnd + sde_diff * div * dt
            if change_sde_ctrl:
                cost = gen_plus * (sde_ctrl - 0.5 * gen_minus)
                rnd = rnd + cost.sum(dim=-1, keepdim=True) * dt
            else:
                rnd = rnd + 0.5 * (gen_plus**2).sum(dim=-1, keepdim=True) * dt
            if not train:
                rnd = rnd - self.sde.drift_div_int(s, t, x)
            x = x + (self.sde.drift(s, x) + sde_diff * sde_ctrl) * dt + sde_diff * db
            ito = ito + (gen_plus * db).sum(dim=-1, keepdim=True)
            if return_traj:
                traj.append(x)
        rnd = rnd - terminal_unnorm_log_prob(x)
        xs = torch.stack(traj) if return_traj else None
        return RolloutResult(x, rnd + ito, rnd, xs)

    def _two_phase_loss(
        self, ts, x, terminal_unnorm_log_prob, initial_log_prob,
        dbs=None, generator=None, probes=None, explore=None,
    ):
        """lv/lv_traj loss with the trajectory rollout outside autograd.
        Phase 1 needs no inference control: the generative one drives the
        SDE. Phase 2's cost takes the sde control that drove phase 1: the
        detached control with the same exploration draws."""
        rnd0 = initial_log_prob(x)
        if dbs is None:
            dbs = self.draw_noise(ts, x, generator, rows=self._rows)
        explore = self._explore_inputs(ts, x, explore, generator)
        xs, x_T = self._phase1(ts, x, dbs, explore)

        n = ts.shape[0] - 1
        s = ts[:-1].reshape(n, 1, 1)
        dt = (ts[1:] - ts[:-1]).reshape(n, 1, 1)
        gen = self.generative_ctrl(s, xs)  # (T, B, d), one batched call
        sde_ctrl = self.explore_sde_ctrl(gen.detach(), s, xs, *explore)
        gen_plus, gen_minus, div = self._inference_terms(
            gen, s, xs, self.div_estimator, probes, generator
        )
        cost = (gen_plus * (sde_ctrl - 0.5 * gen_minus)).sum(dim=-1, keepdim=True) * dt
        if div is not None:
            cost = cost + self.sde.diff(s, xs) * div * dt
        ito = (gen_plus * dbs).sum(dim=-1, keepdim=True)
        rnd_no_ito = rnd0 + cost.sum(0) - terminal_unnorm_log_prob(x_T)
        rnd = rnd_no_ito + ito.sum(0)
        return self.compute_loss(rnd, samples=x_T)

    def __call__(
        self, ts, x, terminal_unnorm_log_prob, initial_log_prob=None,
        dbs=None, generator=None, probes=None, explore=None,
    ):
        """The training loss; `explore` (ξ, υ) overrides the exploration
        draws of an lv method (as `dbs` the noise)."""
        x, dbs, explore, probes = self._enter(x, dbs, explore, probes)
        if self.two_phase:
            return self._two_phase_loss(
                ts, x, terminal_unnorm_log_prob, initial_log_prob,
                dbs=dbs, generator=generator, probes=probes, explore=explore,
            )
        change_sde_ctrl = self.method in ["lv", "lv_traj"]
        if change_sde_ctrl:
            explore = self._explore_inputs(ts, x, explore, generator)
        result = self.simulate(
            ts, x,
            terminal_unnorm_log_prob=terminal_unnorm_log_prob,
            initial_log_prob=initial_log_prob,
            train=True,
            change_sde_ctrl=change_sde_ctrl,
            dbs=dbs,
            generator=generator,
            probes=probes,
            explore=explore,
        )
        rnd = result.rnd if self.method != "kl" else result.rnd_no_ito
        return self.compute_loss(rnd, samples=result.samples)

    def eval(
        self, ts, x, terminal_unnorm_log_prob, initial_log_prob=None,
        return_traj: bool = False, dbs=None, generator=None,
    ) -> RolloutResult:
        """The evaluation rollout of the whole batch (gathered from the
        ranks' rows with a group)."""
        x, dbs, _, _ = self._enter(x, dbs, train=False)
        return self._gather(self.simulate(
            ts, x,
            terminal_unnorm_log_prob=terminal_unnorm_log_prob,
            initial_log_prob=initial_log_prob,
            train=False,
            change_sde_ctrl=False,
            return_traj=return_traj,
            dbs=dbs,
            generator=generator,
        ))


class ReferenceSDELoss(BaseOCLoss):
    """RND against a reference SDE with a known marginal (PIS, EulerDDS).

    With a reference control r (zero without one) the running cost is
    ½|u − r|²dt (KL) or (u − r)·(ū − ½(u + r))dt (LV), the Ito integral
    (u − r)·dW, and the terminal term log q(X_T) − log ρ(X_T) for the
    reference marginal q. On the card, phase 1 runs through kernel 1's
    ScoreCtrl form; `reference_ctrl` enters only phase 2 and `simulate`.
    """

    def __init__(self, *args, reference_ctrl: Callable | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.reference_ctrl = reference_ctrl

    def _minus_plus_reference(self, gen, s, x):
        if self.reference_ctrl is None:
            return gen, gen
        reference = self.reference_ctrl(s, x)
        return gen - reference, gen + reference

    def simulate(
        self,
        ts: torch.Tensor,
        x: torch.Tensor,
        terminal_unnorm_log_prob: Callable,
        reference_log_prob: Callable,
        train: bool = True,
        change_sde_ctrl: bool = False,
        return_traj: bool = False,
        dbs: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        explore: tuple | None = None,
    ) -> RolloutResult:
        """One EM rollout accumulating the RND with and without Ito term;
        `explore` (ξ, υ) explores with the detached control."""
        xi, ups = explore or (None, None)
        rnd = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        ito = torch.zeros_like(rnd)
        traj = [x] if return_traj else None
        for k in range(ts.shape[0] - 1):
            s, t = ts[k], ts[k + 1]
            dt = t - s
            if dbs is not None:
                db = dbs[k]
            else:
                db = self._draw(lambda shp: torch.randn(
                    shp, generator=generator, device=x.device, dtype=x.dtype
                ), x.shape) * torch.sqrt(dt)
            gen = self.generative_ctrl(s, x)
            sde_ctrl = gen
            if change_sde_ctrl:
                sde_ctrl = self.explore_sde_ctrl(gen.detach(), s, x, _at(xi, k), _at(ups, k))
            sde_diff = self.sde.diff(s, x)
            minus, plus = self._minus_plus_reference(gen, s, x)
            if change_sde_ctrl:
                cost = minus * (sde_ctrl - 0.5 * plus)
                rnd = rnd + cost.sum(dim=-1, keepdim=True) * dt
            else:
                rnd = rnd + 0.5 * (minus**2).sum(dim=-1, keepdim=True) * dt
            x = x + (self.sde.drift(s, x) + sde_diff * sde_ctrl) * dt + sde_diff * db
            ito = ito + (minus * db).sum(dim=-1, keepdim=True)
            if return_traj:
                traj.append(x)
        rnd = rnd + reference_log_prob(x) - terminal_unnorm_log_prob(x)
        xs = torch.stack(traj) if return_traj else None
        return RolloutResult(x, rnd + ito, rnd, xs)

    def _two_phase_loss(
        self, ts, x, terminal_unnorm_log_prob, reference_log_prob,
        dbs=None, generator=None, explore=None,
    ):
        """lv/lv_traj loss with the trajectory rollout outside autograd."""
        if dbs is None:
            dbs = self.draw_noise(ts, x, generator, rows=self._rows)
        explore = self._explore_inputs(ts, x, explore, generator)
        xs, x_T = self._phase1(ts, x, dbs, explore)

        n = ts.shape[0] - 1
        s = ts[:-1].reshape(n, 1, 1)
        dt = (ts[1:] - ts[:-1]).reshape(n, 1, 1)
        gen = self.generative_ctrl(s, xs)  # (T, B, d), one batched call
        sde_ctrl = self.explore_sde_ctrl(gen.detach(), s, xs, *explore)
        minus, plus = self._minus_plus_reference(gen, s, xs)
        cost = (minus * (sde_ctrl - 0.5 * plus)).sum(dim=-1, keepdim=True) * dt
        ito = (minus * dbs).sum(dim=-1, keepdim=True)
        rnd_no_ito = (
            cost.sum(0) + reference_log_prob(x_T) - terminal_unnorm_log_prob(x_T)
        )
        rnd = rnd_no_ito + ito.sum(0)
        return self.compute_loss(rnd, samples=x_T)

    def __call__(
        self, ts, x, terminal_unnorm_log_prob, reference_log_prob,
        dbs=None, generator=None, explore=None,
    ):
        """The training loss; `explore` (ξ, υ) overrides the exploration
        draws of an lv method (as `dbs` the noise)."""
        x, dbs, explore, _ = self._enter(x, dbs, explore)
        if self.two_phase:
            return self._two_phase_loss(
                ts, x, terminal_unnorm_log_prob, reference_log_prob,
                dbs=dbs, generator=generator, explore=explore,
            )
        change_sde_ctrl = self.method in ["lv", "lv_traj"]
        if change_sde_ctrl:
            explore = self._explore_inputs(ts, x, explore, generator)
        result = self.simulate(
            ts, x,
            terminal_unnorm_log_prob=terminal_unnorm_log_prob,
            reference_log_prob=reference_log_prob,
            train=True,
            change_sde_ctrl=change_sde_ctrl,
            dbs=dbs,
            generator=generator,
            explore=explore,
        )
        rnd = result.rnd if self.method != "kl" else result.rnd_no_ito
        return self.compute_loss(rnd, samples=result.samples)

    def eval(
        self, ts, x, terminal_unnorm_log_prob, reference_log_prob=None,
        return_traj: bool = False, dbs=None, generator=None,
    ) -> RolloutResult:
        """The evaluation rollout of the whole batch (gathered from the
        ranks' rows with a group)."""
        x, dbs, _, _ = self._enter(x, dbs, train=False)
        return self._gather(self.simulate(
            ts, x,
            terminal_unnorm_log_prob=terminal_unnorm_log_prob,
            reference_log_prob=reference_log_prob,
            train=False,
            change_sde_ctrl=False,
            return_traj=return_traj,
            dbs=dbs,
            generator=generator,
        ))


class ExponentialIntegratorSDELoss(BaseOCLoss):
    """DDS exponential integrator (Vargas et al.).

    Update: β_k = clip(α√dt, 0, 1), a_k = √(1 − β_k²),
    x ← a_k·x + β_k²σ²·u + σβ_k·ε with standard normals ε; running cost
    β_k²σ²·½|u|² (KL) or β_k²σ²·u·(ū − ½u) (LV), Ito increment σβ_k·u·ε,
    terminal log q(X_T) − log ρ(X_T). On the card, phase 1 runs through
    kernel 2 (`ops/rollout.py::fused_rollout_exp`). `__call__` and `eval`
    are those of ReferenceSDELoss.
    """

    update = "exp"

    def __init__(self, *args, alpha: float, sigma: float, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = float(alpha)
        self.sigma = float(sigma)

    def _beta(self, s, t):
        return (self.alpha * torch.sqrt(t - s)).clamp(0.0, 1.0)

    def simulate(
        self,
        ts: torch.Tensor,
        x: torch.Tensor,
        terminal_unnorm_log_prob: Callable,
        reference_log_prob: Callable,
        train: bool = True,
        change_sde_ctrl: bool = False,
        return_traj: bool = False,
        dbs: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        explore: tuple | None = None,
    ) -> RolloutResult:
        """One exponential-integrator rollout accumulating the RND with and
        without Ito term; `dbs` holds standard normals here, `explore`
        (ξ, υ) the exploration of the detached control."""
        sigma = self.sigma
        xi, ups = explore or (None, None)
        rnd = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        ito = torch.zeros_like(rnd)
        traj = [x] if return_traj else None
        for k in range(ts.shape[0] - 1):
            if dbs is not None:
                noise = dbs[k]
            else:
                noise = self._draw(lambda shp: torch.randn(
                    shp, generator=generator, device=x.device, dtype=x.dtype
                ), x.shape)
            gen = self.generative_ctrl(ts[k], x)
            if change_sde_ctrl:
                sde_ctrl = self.explore_sde_ctrl(gen.detach(), ts[k], x, _at(xi, k), _at(ups, k))
                running = (gen * (sde_ctrl - 0.5 * gen)).sum(dim=-1, keepdim=True)
            else:
                sde_ctrl = gen
                running = 0.5 * (gen**2).sum(dim=-1, keepdim=True)
            beta = self._beta(ts[k], ts[k + 1])
            a = torch.sqrt(1.0 - beta**2)
            rnd = rnd + beta**2 * sigma**2 * running
            x = x * a + beta**2 * sigma**2 * sde_ctrl + sigma * beta * noise
            ito = ito + (sigma * gen * noise * beta).sum(dim=-1, keepdim=True)
            if return_traj:
                traj.append(x)
        rnd = rnd + reference_log_prob(x) - terminal_unnorm_log_prob(x)
        xs = torch.stack(traj) if return_traj else None
        return RolloutResult(x, rnd + ito, rnd, xs)

    def _kernel_rollout(self, ts, x, noise):
        from sde_sampler_torch.ops.rollout import fused_rollout_exp

        return fused_rollout_exp(
            self.ctrl_module, x, ts, noise, self.alpha, self.sigma, self.ctrl_clips
        )

    def _scan_step(self, ts, noise, explore):
        """The scan route's exponential-integrator step k:
        a_k·x + β_k²σ²·u + σβ_k·ε_k with the (exploring) detached control u."""
        xi, ups = explore
        sigma = self.sigma

        def step(k, x):
            s = ts[k]
            u = self.explore_sde_ctrl(self.generative_ctrl(s, x), s, x,
                                      _at(xi, k), _at(ups, k))
            beta = self._beta(s, ts[k + 1])
            a = torch.sqrt(1.0 - beta**2)
            return x * a + beta**2 * sigma**2 * u + sigma * beta * noise[k]

        return step

    def _two_phase_loss(
        self, ts, x, terminal_unnorm_log_prob, reference_log_prob,
        dbs=None, generator=None, explore=None,
    ):
        """Two-phase lv for the exponential-integrator update rule."""
        sigma = self.sigma
        if dbs is None:
            dbs = self.draw_noise(ts, x, generator, scale_sqrt_dt=False, rows=self._rows)
        explore = self._explore_inputs(ts, x, explore, generator)
        xs, x_T = self._phase1(ts, x, dbs, explore)

        n = ts.shape[0] - 1
        s = ts[:-1].reshape(n, 1, 1)
        beta = self._beta(ts[:-1], ts[1:]).reshape(n, 1, 1)
        gen = self.generative_ctrl(s, xs)  # (T, B, d), one batched call
        sde_ctrl = self.explore_sde_ctrl(gen.detach(), s, xs, *explore)
        running = (gen * (sde_ctrl - 0.5 * gen)).sum(dim=-1, keepdim=True)
        cost = beta**2 * sigma**2 * running
        ito = (sigma * gen * dbs * beta).sum(dim=-1, keepdim=True)
        rnd_no_ito = (
            cost.sum(0) + reference_log_prob(x_T) - terminal_unnorm_log_prob(x_T)
        )
        rnd = rnd_no_ito + ito.sum(0)
        return self.compute_loss(rnd, samples=x_T)

    __call__ = ReferenceSDELoss.__call__
    eval = ReferenceSDELoss.eval
