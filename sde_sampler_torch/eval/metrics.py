"""Evaluation metrics: expectation/logZ/stddev errors, ESS, domain fraction,
and the objective of global-optimisation targets.

Port of `sde_sampler_tpu/eval/metrics.py` (`get_metrics`). Reductions run
on the samples' device; each metric is returned as a Python float.
"""
from __future__ import annotations

import logging
from numbers import Number
from typing import Callable

import torch

from sde_sampler_torch.distr.base import EXPECTATION_FNS, Distribution


def abs_and_rel_error(
    prediction: Number, target: Number, suffix: str = "", eps: float = 1e-8
) -> dict[str, float]:
    magnitude = abs(target) + eps
    error = abs(prediction - target)
    return {
        f"error{suffix}": error,
        f"rel_error{suffix}": error / magnitude,
    }


def compute_errors(
    prediction, target=None, name: str = "error", weights=None, eps: float = 1e-8
) -> dict[str, float]:
    output = {}
    if isinstance(prediction, Number):
        output[f"eval/{name}"] = prediction
    elif prediction.ndim == 0:
        output[f"eval/{name}"] = float(prediction)
    else:
        if prediction.ndim != 2 or prediction.shape[-1] != 1:
            raise ValueError(f"expected a (n, 1) prediction, got {tuple(prediction.shape)}")
        output[f"eval/{name}"] = float(prediction.mean())
        if weights is not None:
            if weights.shape != prediction.shape:
                raise ValueError("weights and prediction shapes differ")
            weighted = (prediction * weights).sum() / weights.sum()
            output[f"eval/{name}_is"] = float(weighted)

    if target is not None:
        target = float(target)
        for key_name, pred in output.copy().items():
            suffix = key_name.replace("eval", "")
            output.update(
                abs_and_rel_error(prediction=pred, target=target, suffix=suffix, eps=eps)
            )
    return output


def frac_inside_domain(samples: torch.Tensor, domain: torch.Tensor) -> float:
    inside = (domain[:, 0] <= samples) & (samples <= domain[:, 1])
    return float(inside.all(dim=-1).float().mean())


@torch.no_grad()
def get_metrics(
    distr: Distribution,
    samples: torch.Tensor,
    weights: torch.Tensor | None = None,
    log_norm_const_preds: dict | None = None,
    expectation_preds: dict | None = None,
    marginal_dims: list[int] | None = None,
    sample_losses: dict[str, Callable] | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, float]:
    """Metrics of `samples` against the target `distr`; sample losses
    (e.g. Sinkhorn) compare with exact target samples drawn from
    `generator` on the samples' device."""
    marginal_dims = marginal_dims or []
    if not all(d < distr.dim for d in marginal_dims):
        logging.warning("Removing non-existent marginal dims for metrics.")
        marginal_dims = [d for d in marginal_dims if d < distr.dim]

    metrics: dict[str, float] = {}
    expectation_preds = expectation_preds or {}
    log_norm_const_preds = log_norm_const_preds or {}

    # Expectations (and those a solver computed itself, as `<name>_direct`)
    for name, fn in EXPECTATION_FNS.items():
        target = distr.expectations.get(name)
        metrics.update(
            compute_errors(
                prediction=fn(samples), target=target, name=name, weights=weights
            )
        )
        if name in expectation_preds:
            metrics.update(
                compute_errors(
                    prediction=expectation_preds[name], target=target,
                    name=name + "_direct", weights=weights,
                )
            )

    # Log normalization constant
    for name, pred in log_norm_const_preds.items():
        metrics.update(
            compute_errors(
                prediction=float(pred), target=distr.log_norm_const, name=name
            )
        )

    # ESS
    if weights is not None:
        if weights.shape != (samples.shape[0], 1):
            raise ValueError("weights must have shape (n, 1)")
        ess = float(weights.sum() ** 2 / (weights**2).sum())
        metrics["eval/effective_sample_size"] = ess
        metrics["eval/norm_effective_sample_size"] = ess / weights.shape[0]

    # Stddevs (unbiased, as torch's .std)
    stddevs = samples.std(dim=0)
    avg_stddev = float(stddevs.mean())
    means = samples.mean(dim=0)
    metrics["eval/avg_stddev"] = avg_stddev
    for dim in marginal_dims:
        metrics[f"eval/stddev_{dim}"] = float(stddevs[dim])
        metrics[f"eval/avg_{dim}"] = float(means[dim])

    if distr.stddevs is not None:
        ref = distr.stddevs.to(stddevs.device)
        metrics["error/avg_marginal_stddev"] = float((stddevs - ref).abs().mean())
        metrics.update(
            compute_errors(
                prediction=avg_stddev, target=float(ref.mean()), name="avg_stddev"
            )
        )

    # Samples inside domain
    if distr.domain is not None:
        metrics["eval/frac_pred_in_domain"] = frac_inside_domain(
            samples, distr.domain.to(samples.device)
        )

    # Sample-based losses (e.g. Sinkhorn against ground-truth samples)
    if sample_losses is not None:
        if hasattr(distr, "sample"):
            gt_samples = distr.sample((samples.shape[0],), generator=generator)
            if distr.domain is not None:
                metrics["eval/frac_groundtruth_in_domain"] = frac_inside_domain(
                    gt_samples, distr.domain.to(samples.device)
                )
            for name, loss in sample_losses.items():
                metrics["error/" + name] = float(loss(samples, gt_samples))
        else:
            logging.warning(
                "Sampling not implemented for distribution %s.",
                distr.__class__.__name__,
            )

    # Objective (global-optimisation targets)
    if hasattr(distr, "objective"):
        metrics["eval/obj_avg"] = float(distr.objective(samples.mean(dim=0, keepdim=True)))
        obj = distr.objective(samples)
        metrics["eval/avg_obj"] = float(obj.mean())
        metrics["eval/min_obj"] = float(obj.min())
    return metrics
