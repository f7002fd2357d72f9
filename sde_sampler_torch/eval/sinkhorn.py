"""Entropy-regularized p-Wasserstein (Sinkhorn) distance, streamed.

Port of the single-device `Sinkhorn` of `sde_sampler_tpu/eval/sinkhorn.py`:
log-domain iterations with the `stop_thresh` early exit, in which entries
with a -inf dual (zero weight) are masked out of the convergence check.
The cost matrix is never stored: each iteration calls `ops.sinkhorn.softmin`
twice and the end `ops.sinkhorn.transport_cost` once, which launch the CUDA
kernels on a card tensor and run their plain versions on a CPU tensor. The
kernels take p = 2; any other p runs the JAX package's XLA cost
(`_cost_tile`) in plain torch on either device, over dense row chunks:
|x - y|_1 for p = 1, (sum_k (x_k - y_k)^p)^(1/p) otherwise, as written
there (without an absolute value, so an odd p > 1 gives NaN distances and a
NaN result on both sides).

Data parallelism (`group`, attached by the solver of a data-parallel run;
JAX `_compute_sharded`, `eval/sinkhorn.py:205-291, 451-488`). Every rank
holds both whole clouds (the evaluation gathers its samples once, and the
target's are drawn at the global shape), so no cloud is gathered again:
each rank takes its row blocks of x and y and of their weights and duals.
On each half-iteration the rank gathers the other side's duals (each block
padded to the largest and trimmed, so no padded row enters a kernel) and
calls softmin on its (n/W) x m rectangle; the error that stops the loop is
the MAX over the ranks, so every rank stops on the same iteration. The
transport kernel runs on the rank's rows against all columns, and the
ranks' float32 partials are summed in float64, then cast to float32.
Without a group the one rank's block is the whole cloud and every
collective is the identity, so the same loop is the one-device Sinkhorn.
"""
from __future__ import annotations

import torch

from sde_sampler_torch.ops import sinkhorn as ops
from sde_sampler_torch.parallel import mesh


ROW_CHUNK = 256  # rows per (ROW_CHUNK, m, d) difference tile of p != 2


def _cost(x: torch.Tensor, y: torch.Tensor, p: int) -> torch.Tensor:
    """Pairwise p-distances (n, m) of p != 2, the JAX package's `_cost_tile`."""
    diff = x[:, None, :] - y[None, :, :]
    if p == 1:
        return diff.abs().sum(-1)
    return (diff**p).sum(-1) ** (1.0 / p)


def softmin_p(x, y, dual, eps: float, p: int) -> torch.Tensor:
    """eps * logsumexp_j((-M_ij + dual_j)/eps) with the p-cost, row chunks."""
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], ROW_CHUNK):
        z = (-_cost(x[r0 : r0 + ROW_CHUNK], y, p) + dual[None, :]) / eps
        out[r0 : r0 + ROW_CHUNK] = eps * torch.logsumexp(z, dim=1)
    return out


def transport_cost_p(x, y, u, v, eps: float, p: int) -> torch.Tensor:
    """sum_ij exp((-M_ij + u_i + v_j)/eps) * M_ij with the p-cost."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, x.shape[0], ROW_CHUNK):
        m = _cost(x[r0 : r0 + ROW_CHUNK], y, p)
        plan = torch.exp((-m + u[r0 : r0 + ROW_CHUNK, None] + v[None, :]) / eps)
        total = total + (plan * m).sum(dtype=torch.float64)
    return total.to(x.dtype)


class Sinkhorn:
    """Entropy-regularized p-Wasserstein distance between point clouds."""

    def __init__(
        self,
        p: int = 2,
        eps: float = 1e-3,
        max_iters: int = 100,
        stop_thresh: float = 1e-5,
        verbose: bool = False,
        n_max: int | None = None,
        group=None,
        **kwargs,  # JAX tiling, backend and mesh knobs
    ):
        if not isinstance(p, int) or p <= 0:
            raise TypeError(f"p must be an integer greater than 0, got {p}")
        self.p = p
        if eps <= 0:
            raise ValueError("Entropy regularization term eps must be > 0")
        self.eps = eps
        if not isinstance(max_iters, int) or max_iters <= 0:
            raise TypeError(f"max_iters must be an integer > 0, got {max_iters}")
        self.max_iters = max_iters
        if not isinstance(stop_thresh, float):
            raise TypeError(f"stop_thresh must be a float, got {stop_thresh}")
        self.stop_thresh = stop_thresh
        self.n_max = n_max
        self.verbose = verbose
        # the data-parallel group whose ranks share the rows (set by the
        # solver; None: one device)
        self.group = group
        self.n_iters = 0  # iterations the last call ran

    def compute(self, x, y, w_x=None, w_y=None) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).contiguous()
        y = torch.as_tensor(y, dtype=torch.float32, device=x.device).contiguous()
        if x.ndim != 2 or y.ndim != 2:
            raise ValueError("x and y must be [n, d] / [m, d] arrays")
        if x.shape[1] != y.shape[1]:
            raise ValueError("x and y must match in the last dimension")
        if (w_x is None) != (w_y is None):
            raise ValueError("Provide both or neither of w_x and w_y")

        if w_x is None:
            w_x = torch.ones(x.shape[0], device=x.device) / x.shape[0]
            w_y = torch.ones(y.shape[0], device=x.device) / y.shape[0]
            w_y = w_y * (w_x.shape[0] / w_y.shape[0])
        else:
            w_x = torch.as_tensor(w_x, dtype=torch.float32, device=x.device).reshape(-1)
            w_y = torch.as_tensor(w_y, dtype=torch.float32, device=x.device).reshape(-1)
        if abs(float(w_x.sum()) - float(w_y.sum())) > 1e-5:
            raise ValueError("Weights w_x and w_y do not sum to the same value")

        eps = self.eps
        if self.p == 2:  # the kernels (their plain versions on the CPU)
            softmin, transport = ops.softmin, ops.transport_cost
        else:
            softmin = lambda a, b, dual, e: softmin_p(a, b, dual, e, self.p)
            transport = lambda a, b, uu, vv, e: transport_cost_p(a, b, uu, vv, e, self.p)
        log_a, log_b = torch.log(w_x), torch.log(w_y)
        # this rank's row blocks (the whole clouds without a group)
        group = self.group
        x_l, la, y_l, lb = (mesh.shard_batch(t, group) for t in (x, log_a, y, log_b))
        sizes_x = mesh.block_sizes(x.shape[0], mesh.world(group))
        sizes_y = mesh.block_sizes(y.shape[0], mesh.world(group))
        u_l, v_l = torch.zeros_like(la), eps * lb
        # zero-weight entries keep -inf duals; their nan deltas must not
        # end the loop early
        fin_a, fin_b = torch.isfinite(la), torch.isfinite(lb)
        self.n_iters = 0
        for it in range(self.max_iters):
            v_all = mesh.all_gather_rows(v_l, group, sizes_y)
            u_new = la * eps - softmin(x_l, y, v_all, eps)
            u_all = mesh.all_gather_rows(u_new, group, sizes_x)
            v_new = lb * eps - softmin(y_l, x, u_all, eps)
            err = torch.maximum(
                torch.where(fin_a, (u_l - u_new).abs(), 0.0).max(),
                torch.where(fin_b, (v_l - v_new).abs(), 0.0).max(),
            )
            u_l, v_l = u_new, v_new
            self.n_iters = it + 1
            max_err = float(mesh.all_reduce(err, group, "max"))
            if self.verbose and mesh.rank(group) == 0:
                print(f"sinkhorn iter {it}: max_err={max_err:.3g}")
            if not max_err >= self.stop_thresh:
                break
        v_all = mesh.all_gather_rows(v_l, group, sizes_y)
        part = transport(x_l, y, u_l, v_all, eps).to(torch.float64)
        return mesh.all_reduce(part, group).to(torch.float32)

    def __call__(self, x, y, w_x=None, w_y=None):
        if self.n_max is not None:
            x, y = x[: self.n_max], y[: self.n_max]
            if w_x is not None:
                w_x = w_x[: self.n_max]
            if w_y is not None:
                w_y = w_y[: self.n_max]
        return self.compute(x, y, w_x=w_x, w_y=w_y)
