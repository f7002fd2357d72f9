"""Rank functions of tests/test_torch_port_parallel.py.

`sde_sampler_torch.parallel.mesh.spawn` pickles its function by module
path and each child imports that module: these live here, in a module that
imports neither JAX nor the JAX package, so that the ranks import neither.
Inputs arrive as numpy arrays and results go back as plain Python objects.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.distributed as dist

from sde_sampler_torch import main as entry
from sde_sampler_torch.eval.sinkhorn import Sinkhorn
from sde_sampler_torch.parallel import mesh
from sde_sampler_torch.utils.params import load_flax_params


def _group():
    return mesh.get_group(dist.get_world_size())


def sinkhorn_and_mesh(rank: int, cases: list, kw: dict) -> dict:
    """The sharded Sinkhorn on each (x, y) case, and the mesh helpers on an
    uneven batch and a repeated one."""
    group = _group()
    out = {"sinkhorn": [], "n_iters": []}
    for x, y in cases:
        s = Sinkhorn(group=group, **kw)
        out["sinkhorn"].append(float(s(torch.from_numpy(x), torch.from_numpy(y))))
        out["n_iters"].append(s.n_iters)
    w, n = mesh.world(group), 10
    sizes = mesh.block_sizes(n, w)
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    local = mesh.shard_batch(x, group)
    rows = mesh.Rows(n, group, repeat=2)
    repeated = x[None].repeat(2, 1, 1).reshape(-1, 3)
    taken = rows.take(repeated)
    state = [torch.full((4,), float(rank)), torch.full((2, 2), float(rank) + 1)]
    mesh.replicate(state, group)
    out["mesh"] = {
        "block": [local[0, 0].item() // 3, local.shape[0]],
        "sizes": sizes,
        "gathered": bool(torch.equal(mesh.all_gather_rows(local, group, sizes), x)),
        "gathered_dim1": bool(torch.equal(
            mesh.all_gather_rows(local.T.contiguous(), group, sizes, dim=1), x.T)),
        "sum": mesh.all_reduce(local.sum(), group).item(),
        "max": mesh.all_reduce(local.max(), group, "max").item(),
        "repeat_rows": (taken[:, 0] // 3).tolist(),
        "replicated": [t.tolist() for t in state],
    }
    return out


def optimizer_steps(rank: int, overrides: list[str], j_params: dict, draws: list) -> dict:
    """Steps of the port's solver on the given global draws from the given
    initial parameters: the losses, the largest gradients, the parameters."""
    solver = entry.make_solver(overrides)
    load_flax_params(solver.generative_ctrl, j_params)
    if solver.ema_params is not None:
        with torch.no_grad():
            for shadow, p in zip(solver.ema_params, solver.params):
                shadow.copy_(p)
    losses, max_grads = [], []
    for x0, dbs in draws:
        metrics = solver.step(x0=torch.from_numpy(x0), dbs=torch.from_numpy(dbs))
        losses.append(float(metrics["train/loss"]))
        max_grads.append(float(metrics["train/max_grad"]))
    return {
        "losses": losses, "max_grads": max_grads, "digest": solver.param_digest(),
        "n_updates": solver.n_updates, "n_filtered": int(solver.n_filtered),
        "state": {k: v.numpy() for k, v in solver.generative_ctrl.state_dict().items()},
    }


def entry_runs(rank: int, jobs: list[list[str]]) -> list[dict]:
    """Each job through the entry point with the group up: its final
    metrics, its training losses and largest gradients (metrics.jsonl) and
    the parameter digest."""
    out = []
    for job in jobs:
        result = entry.main(job)
        out_dir = Path(result.cfg["out_dir"])
        lines = ([json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
                 if rank == 0 else [])
        out.append({"final": dict(result.last_metrics),
                    "losses": [l["train/loss"] for l in lines if "train/loss" in l],
                    "max_grads": [l["train/max_grad"] for l in lines if "train/max_grad" in l],
                    "digest": result.param_digest()})
    return out

