"""SDE integrators: Euler-Maruyama (optionally with continuous-adjoint
gradients), Stratonovich Heun, adaptive Heun, and a virtual Brownian tree.

Port of `sde_sampler_tpu/eq/integrator.py`. The JAX package rolls out a
`lax.scan`, stores the dense trajectory on the internal grid and then
interpolates it onto the output grid `ts`. Here each integrator is a host
loop over the internal grid that interpolates on the fly: the outputs
whose interval is [timesteps[k], timesteps[k+1]] are formed as soon as the
step k is done, with the JAX package's arithmetic
x_k·(1 − w) + x_{k+1}·w, w = (t − t_k) / (t_{k+1} − t_k) in float32. So
only the (len(ts), B, d) output is stored; at the Langevin config (10000
Euler steps of 6000 chains) the dense trajectory would take 0.48 GB at
d = 2 and 12 GB at d = 50.

Noise comes from an explicit `torch.Generator` (normals scaled by √dt, one
draw per step), or from a caller's Brownian path `bm(t)` (for example a
`VirtualBrownianTree`), whose increments bm(t) − bm(s) then drive the
steps. Times enter the SDE as 0-d float32 tensors, as the JAX scan's
traced times.

`VirtualBrownianTree` draws its node noise from a counter-based hash
(splitmix64 of the seed, the node and the element index, in torch int64
ops, then Box-Muller) rather than from a `torch.Generator` seeded per
node: W(t) is then a pure function of (seed, t) that is the same on the
CPU and on the card up to float rounding, the path's depth + 1 node draws
come from one batched op instead of one generator and one launch per node,
and no generator object is built in the loop. Its values cannot match the
JAX tree's (threefry `fold_in`), only its statistics.

`AdaptiveHeunIntegrator` keeps the JAX package's PI step controller on
err = max over the whole batch; each trial step reads err on the host (one
synchronisation a trial), and the step sizes and times are float32 numbers
on the host with the JAX package's float32 arithmetic. Where err is NaN
the JAX `while_loop` never ends; here it raises.

With `adjoint=True` the Euler integrator is a `torch.autograd.Function`
whose forward pass stores no per-step state, and whose backward pass
re-derives the trajectory by reverse Euler on the same tree path,
accumulating the adjoint and the parameters' gradients by per-step
`torch.autograd.grad` VJPs (`_make_adjoint_euler` in the JAX package).

Data parallelism (`group` of `integrate`; `parallel/mesh.py`): the caller
passes the whole batch of chains, each rank integrates its row block and
the whole output is gathered on every rank. The per-step normals are drawn
at the global shape and the rank's rows kept; a Brownian tree hashes the
global element index of each of its rows (`VirtualBrownianTree.rows`);
adaptive Heun's err, the max over the whole batch, is the MAX over the
ranks, so every rank takes the same steps. The paths are then those of one
device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sde_sampler_torch.eq.sdes import SDE
from sde_sampler_torch.parallel import mesh
from sde_sampler_torch.utils.common import get_timesteps

_MASK64 = (1 << 64) - 1


def _signed(v: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    v &= _MASK64
    return v - (1 << 64) if v >= 1 << 63 else v


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser on int64 tensors (wrapping arithmetic)."""
    z = z + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def seed_key(seed: int) -> int:
    """The hashed seed that `hashed_normals` mixes into every counter."""
    return int(splitmix64(torch.tensor([_signed(seed)], dtype=torch.int64))[0])


def hashed_normals(key: int, nodes: torch.Tensor, numel: int, offset: int = 0) -> torch.Tensor:
    """Standard normals (len(nodes), numel), float32, a pure function of
    (key, node, element) for the elements offset, ..., offset + numel − 1:
    splitmix64 of (node · 2^32 + element) xor the key, whose top and next
    24 bits give the two uniforms of one Box-Muller draw."""
    elements = torch.arange(offset, offset + numel, dtype=torch.int64, device=nodes.device)
    z = splitmix64(((nodes[:, None] << 32) | elements[None, :]) ^ key)
    scale = 2.0**-24
    u1 = (_shr(z, 40).to(torch.float32) + 0.5) * scale
    u2 = ((_shr(z, 16) & 0xFFFFFF).to(torch.float32) + 0.5) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


class VirtualBrownianTree:
    """Brownian motion W(t) on [t0, t1], W(t0) = 0, as a pure function of
    (seed, t): recursive Brownian-bridge subdivision down to 2^-depth of
    the span, with the noise of every node hashed from (seed, node) (heap
    indices from 1; node 0 draws W(t1)), then linear interpolation inside
    the last cell. The bridge is linear in the node noises, so the
    coefficients of the depth + 1 nodes on t's path are computed on the
    host (float64) and W(t) is their sum against one batched draw. The last
    two values are kept, so that an integrator's bm(t) − bm(s) costs one
    new path a step. With `rows` (a `mesh.Rows` of shape[0]), W(t) holds
    those rows of the tree of the whole `shape`, the same bits."""

    def __init__(self, t0: float, t1: float, seed: int, shape, depth: int = 22,
                 device=None, rows: mesh.Rows | None = None):
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.key = seed_key(seed)
        self.shape = tuple(shape)
        self.offset = 0
        if rows is not None:
            inner = math.prod(self.shape[1:])
            self.offset = rows.start * inner
            self.shape = (rows.stop - rows.start,) + self.shape[1:]
        self.depth = int(depth)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.numel = math.prod(self.shape)
        self._cache: dict[float, torch.Tensor] = {}

    def path(self, t: float) -> tuple[list[int], np.ndarray]:
        """The nodes on t's path and W(t)'s coefficient on each."""
        t = min(max(float(t), self.t0), self.t1)
        n = self.depth + 1
        ta, tb = self.t0, self.t1
        wa, wb = np.zeros(n), np.zeros(n)
        wb[0] = math.sqrt(self.t1 - self.t0)
        nodes, node = [0], 1
        for level in range(1, n):
            tm = 0.5 * (ta + tb)
            wm = 0.5 * (wa + wb)
            wm[level] = 0.5 * math.sqrt(tb - ta)
            nodes.append(node)
            if t < tm:
                tb, wb, node = tm, wm, 2 * node
            else:
                ta, wa, node = tm, wm, 2 * node + 1
        w = (t - ta) / max(tb - ta, 1e-12)
        return nodes, (1.0 - w) * wa + w * wb

    def __call__(self, t) -> torch.Tensor:
        key = float(t)
        if key in self._cache:
            return self._cache[key]
        nodes, coeffs = self.path(key)
        z = hashed_normals(
            self.key, torch.tensor(nodes, dtype=torch.int64, device=self.device), self.numel,
            self.offset)
        c = torch.as_tensor(coeffs, dtype=torch.float32, device=self.device)
        value = (c @ z).reshape(self.shape)
        if len(self._cache) >= 2:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = value
        return value


def draw_seed(generator: torch.Generator | None) -> int:
    """A tree seed drawn from `generator` (the default generator if None)."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(0, 2**62, (1,), generator=generator, device=device))


class _Interpolation:
    """The JAX package's `_interpolate_to_grid` of a dense trajectory on
    `timesteps` onto `ts`, formed on the fly: output j lies in the interval
    idx_j = clip(searchsorted(timesteps, ts_j, right) − 1, 0, T − 1) with
    the float32 weight w_j = (ts_j − t_idx) / (t_idx+1 − t_idx)."""

    def __init__(self, timesteps: torch.Tensor, ts: torch.Tensor):
        timesteps = timesteps.to(torch.float32)
        ts = torch.as_tensor(ts, dtype=torch.float32, device=timesteps.device)
        n_steps = timesteps.shape[0] - 1
        idx = torch.clamp(
            torch.searchsorted(timesteps, ts, right=True) - 1, 0, n_steps - 1)
        t0, t1 = timesteps[idx], timesteps[idx + 1]
        self.w = ((ts - t0) / (t1 - t0)).reshape(-1, 1, 1)
        self.by_step: dict[int, torch.Tensor] = {}
        for j, k in enumerate(idx.tolist()):
            self.by_step.setdefault(k, []).append(j)
        self.by_step = {
            k: torch.tensor(js, device=timesteps.device) for k, js in self.by_step.items()}

    def emit(self, k: int, x_k: torch.Tensor, x_next: torch.Tensor):
        """The outputs of step k's interval: (indices, values) or None."""
        js = self.by_step.get(k)
        if js is None:
            return None
        w = self.w[js]
        return js, x_k[None] * (1 - w) + x_next[None] * w

    def assemble(self, pieces) -> torch.Tensor:
        order = torch.cat([js for js, _ in pieces])
        values = torch.cat([v for _, v in pieces])
        return values[torch.argsort(order)]


def _internal_grid(integrator, ts, timesteps, device):
    if timesteps is not None:
        return torch.as_tensor(timesteps, dtype=torch.float32, device=device)
    ts_host = torch.as_tensor(ts).detach().cpu().double()
    return get_timesteps(
        float(ts_host[0]), float(ts_host[-1]),
        dt=integrator.dt if integrator.steps is None else None,
        steps=integrator.steps, rescale_t=integrator.rescale_t, device=device,
    )


class Integrator:
    def integrate(self, sde, ts, x_init, generator=None, timesteps=None, bm=None,
                  group=None):
        """Roll out `sde` from x_init and return the states on the output
        grid ts, (len(ts), B, d). `bm` (optional) is a Brownian path W(t)
        whose increments replace the generator's normals: the same path can
        then drive integrations at different resolutions. With a `group`,
        each rank integrates its rows of x_init (and of a given bm's whole
        batch) and the whole output is gathered on every rank; without one,
        the rows are the whole batch and the collectives the identity."""
        rows = mesh.Rows(x_init.shape[0], group)
        if bm is not None:
            whole = bm
            bm = lambda t: rows.take(whole(t))  # noqa: E731
        xs = self._integrate(sde, ts, rows.take(x_init), generator, timesteps, bm, rows)
        return mesh.all_gather_rows(
            xs, group, mesh.block_sizes(x_init.shape[0], mesh.world(group)), dim=1)

    def _integrate(self, sde, ts, x_init, generator, timesteps, bm, rows):
        """`integrate` of this rank's rows `rows` (a `mesh.Rows`)."""
        raise NotImplementedError


def _normals(shape, generator, device, dtype, rows) -> torch.Tensor:
    """Standard normals of `shape`, this rank's `rows` of a draw at the
    global batch (axis 0)."""
    whole = torch.randn((rows.total,) + tuple(shape[1:]), generator=generator,
                        device=device, dtype=dtype)
    return rows.take(whole).contiguous()


def _fixed_step_loop(step, ts, x_init, generator, timesteps, bm, rows):
    """The loop shared by Euler and Heun: step(s, t, dt, x, noise) -> x'."""
    interp = _Interpolation(timesteps, ts)
    dts = timesteps[1:] - timesteps[:-1]
    sqrt_dts = torch.sqrt(dts)
    pieces, x = [], x_init
    for k in range(timesteps.shape[0] - 1):
        s, t = timesteps[k], timesteps[k + 1]
        if bm is None:
            noise = _normals(x.shape, generator, x.device, x.dtype, rows) * sqrt_dts[k]
        else:
            noise = bm(t) - bm(s)
        x_next = step(s, t, dts[k], x, noise)
        piece = interp.emit(k, x, x_next)
        if piece is not None:
            pieces.append(piece)
        x = x_next
    return interp.assemble(pieces)


class EulerIntegrator(Integrator):
    """Euler-Maruyama on an internal grid (dt or steps). `adjoint=True`
    switches backprop to the continuous adjoint (`adjoint_euler`): O(1)
    stored states, the noise from a `VirtualBrownianTree` seeded from the
    generator."""

    def __init__(
        self,
        dt: float | None = 0.01,
        steps: int | None = None,
        rescale_t: str | None = None,
        eps: float = 1e-8,
        adjoint: bool = False,
        depth: int = 22,
    ):
        self.dt = dt
        self.steps = steps
        self.rescale_t = rescale_t
        self.eps = eps
        self.adjoint = adjoint
        self.depth = depth

    def _integrate(self, sde: SDE, ts, x_init, generator, timesteps, bm, rows):
        timesteps = _internal_grid(self, ts, timesteps, x_init.device)
        if self.adjoint:
            if bm is not None:
                raise NotImplementedError(
                    "adjoint=True builds its own VirtualBrownianTree from the "
                    "generator and cannot consume a caller-supplied `bm`; "
                    "silently ignoring it would give different noise than "
                    "the non-adjoint path. Pass a generator instead, or "
                    "adjoint=False."
                )
            tree = VirtualBrownianTree(
                float(timesteps[0]), float(timesteps[-1]), draw_seed(generator),
                _whole_shape(x_init, rows), depth=self.depth, device=x_init.device, rows=rows)
            return adjoint_euler(sde, timesteps, ts, x_init, tree, sde_parameters(sde))

        def step(s, t, dt, x, noise):
            return x + sde.drift(s, x) * dt + sde.diff(s, x) * noise

        return _fixed_step_loop(step, ts, x_init, generator, timesteps, bm, rows)


class HeunIntegrator(Integrator):
    """Stratonovich Heun (predictor-corrector) on an internal grid."""

    def __init__(
        self,
        dt: float | None = 0.01,
        steps: int | None = None,
        rescale_t: str | None = None,
    ):
        self.dt = dt
        self.steps = steps
        self.rescale_t = rescale_t

    def _integrate(self, sde, ts, x_init, generator, timesteps, bm, rows):
        timesteps = _internal_grid(self, ts, timesteps, x_init.device)

        def step(s, t, dt, x, noise):
            drift_s = sde.drift(s, x)
            diff_s = sde.diff(s, x)
            x_pred = x + drift_s * dt + diff_s * noise
            drift_t = sde.drift(t, x_pred)
            diff_t = sde.diff(t, x_pred)
            return x + 0.5 * (drift_s + drift_t) * dt + 0.5 * (diff_s + diff_t) * noise

        return _fixed_step_loop(step, ts, x_init, generator, timesteps, bm, rows)


def _whole_shape(x, rows) -> tuple:
    """The shape of the whole batch of which x holds `rows`."""
    return (rows.total,) + tuple(x.shape[1:])


class AdaptiveHeunIntegrator(Integrator):
    """Adaptive Stratonovich Heun on a Brownian path: between consecutive
    grid times, predictor-corrector trial steps whose Euler-vs-Heun
    discrepancy drives a PI step controller, bounded below by dt_min. The
    grid is `timesteps` if given (then interpolated onto ts), else ts.
    After a call, `n_accepted` and `n_rejected` count its trial steps."""

    def __init__(
        self,
        dt: float = 0.01,
        dt_min: float = 0.0005,
        rtol: float = 1e-3,
        atol: float = 1e-3,
        safety: float = 0.9,
        max_factor: float = 5.0,
        min_factor: float = 0.2,
        depth: int = 22,
    ):
        self.dt = dt
        self.dt_min = dt_min
        self.rtol = rtol
        self.atol = atol
        self.safety = safety
        self.max_factor = max_factor
        self.min_factor = min_factor
        self.depth = depth
        self.n_accepted = 0
        self.n_rejected = 0

    def _integrate(self, sde, ts, x_init, generator, timesteps, bm, rows):
        device = x_init.device
        grid = torch.as_tensor(ts if timesteps is None else timesteps,
                               dtype=torch.float32, device=device)
        grid_host = grid.cpu().numpy()
        if bm is None:
            bm = VirtualBrownianTree(
                float(grid_host[0]), float(grid_host[-1]), draw_seed(generator),
                _whole_shape(x_init, rows), depth=self.depth, device=device, rows=rows)
        f32 = np.float32
        dt_min, safety = f32(self.dt_min), f32(self.safety)
        min_factor, max_factor = f32(self.min_factor), f32(self.max_factor)

        def heun_step(t, x, dt):
            # 0-d float32 times on the host: the SDE's time arithmetic in
            # float32, as the JAX loop's, without a copy to the card
            t_next = f32(t + dt)
            d_w = bm(t_next) - bm(t)
            t_now, t_next = torch.tensor(t), torch.tensor(t_next)
            drift_s = sde.drift(t_now, x)
            diff_s = sde.diff(t_now, x)
            x_euler = x + drift_s * float(dt) + diff_s * d_w
            drift_t = sde.drift(t_next, x_euler)
            diff_t = sde.diff(t_next, x_euler)
            x_heun = x + 0.5 * (drift_s + drift_t) * float(dt) + 0.5 * (diff_s + diff_t) * d_w
            scale = self.atol + self.rtol * torch.maximum(x.abs(), x_heun.abs())
            err = (x_heun - x_euler).abs() / scale
            return x_heun, err.max()

        self.n_accepted = self.n_rejected = 0
        xs, x, dt = [x_init], x_init, f32(self.dt)
        for t_start, t_end in zip(grid_host[:-1], grid_host[1:]):
            t, stop = f32(t_start), f32(t_end) - f32(1e-9)
            while t < stop:
                dt_eff = min(dt, f32(t_end - t))
                x_new, err = heun_step(t, x, dt_eff)
                err = f32(float(mesh.all_reduce(err, rows.group, "max")))  # over the whole batch
                if np.isnan(err):  # the JAX loop would never end
                    raise FloatingPointError(f"adaptive Heun: NaN error estimate at t = {t}")
                if err <= 1.0 or dt_eff <= dt_min:
                    t, x = f32(t + dt_eff), x_new
                    self.n_accepted += 1
                else:
                    self.n_rejected += 1
                with np.errstate(divide="ignore", over="ignore"):
                    factor = min(max(safety * err ** f32(-0.5), min_factor), max_factor)
                dt = max(f32(dt * factor), dt_min)
            xs.append(x)
        xs = torch.stack(xs)
        if timesteps is None:
            return xs
        interp = _Interpolation(grid, ts)
        pieces = [p for k in range(len(grid_host) - 1)
                  if (p := interp.emit(k, xs[k], xs[k + 1])) is not None]
        return interp.assemble(pieces)


def sde_parameters(sde) -> list[torch.Tensor]:
    """The tensors an SDE's coefficients depend on that need gradients: an
    `nn.Module`'s parameters, else its tensor attributes that require
    grad."""
    if isinstance(sde, torch.nn.Module):
        return [p for p in sde.parameters() if p.requires_grad]
    return [v for v in vars(sde).values()
            if isinstance(v, torch.Tensor) and v.requires_grad]


def _drift_diff(sde, t, x):
    return sde.drift(t, x), sde.diff(t, x) * torch.ones_like(x)


class _AdjointEuler(torch.autograd.Function):
    """Euler-Maruyama on `timesteps` under the tree's path, interpolated
    onto the output grid; the backward pass is the continuous adjoint."""

    @staticmethod
    def forward(ctx, sde, timesteps, interp, tree, x_init, *params):
        times = timesteps.tolist()  # the tree's keys, read on the host once
        with torch.no_grad():
            pieces, x = [], x_init
            for k in range(timesteps.shape[0] - 1):
                s, t = timesteps[k], timesteps[k + 1]
                f, g = _drift_diff(sde, s, x)
                x_next = x + f * (t - s) + g * (tree(times[k + 1]) - tree(times[k]))
                piece = interp.emit(k, x, x_next)
                if piece is not None:
                    pieces.append(piece)
                x = x_next
            out = interp.assemble(pieces)
        # O(1) residuals: the terminal state only
        ctx.sde, ctx.timesteps, ctx.interp, ctx.tree = sde, timesteps, interp, tree
        ctx.save_for_backward(x, *params)
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, *params = ctx.saved_tensors
        sde, timesteps, interp, tree = ctx.sde, ctx.timesteps, ctx.interp, ctx.tree
        n_steps = timesteps.shape[0] - 1
        # the cotangent of each dense state from the outputs' lerp weights
        into = {}
        for k, js in interp.by_step.items():
            w = interp.w[js]
            into.setdefault(k, []).append(((1 - w) * g_out[js]).sum(0))
            into.setdefault(k + 1, []).append((w * g_out[js]).sum(0))
        g_state = {k: sum(v) for k, v in into.items()}
        lam = torch.zeros_like(x)
        grads = [torch.zeros_like(p) for p in params]
        times = timesteps.tolist()
        for k in reversed(range(n_steps)):
            s, t = timesteps[k], timesteps[k + 1]
            if k + 1 in g_state:
                lam = lam + g_state[k + 1]
            d_w = tree(times[k + 1]) - tree(times[k])
            with torch.no_grad():
                # reverse Euler: the O(dt)-accurate inverse of the forward step
                f_t, g_t = _drift_diff(sde, t, x)
                x_prev = x - f_t * (t - s) - g_t * d_w
            with torch.enable_grad():
                xp = x_prev.detach().requires_grad_(True)
                f, g = _drift_diff(sde, s, xp)
                x_step = xp + f * (t - s) + g * d_w
                vjps = torch.autograd.grad(
                    x_step, [xp, *params], lam, allow_unused=True)
            lam = vjps[0]
            grads = [a if b is None else a + b for a, b in zip(grads, vjps[1:])]
            x = x_prev
        if 0 in g_state:
            lam = lam + g_state[0]
        return (None, None, None, None, lam, *grads)


def adjoint_euler(sde, timesteps, ts, x_init, tree, params):
    """Euler-Maruyama with continuous-adjoint gradients for x_init and
    `params` (the tensors the SDE's coefficients depend on)."""
    interp = _Interpolation(timesteps, ts)
    return _AdjointEuler.apply(sde, timesteps, interp, tree, x_init, *params)
