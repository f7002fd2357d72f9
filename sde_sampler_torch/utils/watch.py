"""Model watcher: per-module gradient and parameter norms.

Port of `sde_sampler_tpu/utils/watch.py`, the analogue of the reference's
`wandb.watch(models, log=..., log_freq=...)` (conf/utils/model_watcher.yaml):
the L2 norm of each top-level module's gradients (`watch/grad_norm/<name>`)
and parameters (`watch/param_norm/<name>`) join the train step's metrics.
The norms stay tensors on the device, so a step adds no host sync; as in
the JAX package, every step computes them and the training loop drops them
from the steps that do not `should_log`.
"""
from __future__ import annotations

import torch

__all__ = ["ModelWatcher"]


def l2_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, summed tensor by tensor
    in float32 as the JAX package sums its leaves."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t))
        total = sq if total is None else total + sq
    return torch.sqrt(total if total is not None else torch.zeros(()))


class ModelWatcher:
    """Collects watch metrics for the train step's metrics.

    Args:
        log: "gradients" (default), "parameters" or "all", as wandb.watch's
            ``log``.
        log_freq: attach the metrics only on steps divisible by this (None:
            every step; the cadence is then the solver's log_interval).
    """

    def __init__(self, log: str = "gradients", log_freq: int | None = None):
        if log not in ("gradients", "parameters", "all"):
            raise ValueError(f"unknown watch log mode: {log!r}")
        self.log = log
        self.log_freq = int(log_freq) if log_freq else None

    def should_log(self, step: int) -> bool:
        return self.log_freq is None or step % self.log_freq == 0

    def metrics(self, modules) -> dict[str, torch.Tensor]:
        """The norms of each module of `modules` (name -> nn.Module): of its
        parameters' gradients and of the parameters themselves."""
        out: dict[str, torch.Tensor] = {}
        if self.log in ("gradients", "all"):
            for name, module in modules.items():
                out[f"watch/grad_norm/{name}"] = l2_norm(
                    torch.zeros_like(p) if p.grad is None else p.grad
                    for p in module.parameters())
        if self.log in ("parameters", "all"):
            for name, module in modules.items():
                out[f"watch/param_norm/{name}"] = l2_norm(p.detach() for p in module.parameters())
        return out
