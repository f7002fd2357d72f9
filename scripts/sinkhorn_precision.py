#!/usr/bin/env python3
"""The 100k Sinkhorn between exact samples of the grid mixture, two ways.

The port's Sinkhorn evaluation of the mixture sits about 3x above the JAX
package's TPU rows. Both JAX paths on the TPU formed the distance as
sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0)) with the dot at the matrix unit's
default precision: one pass on bfloat16-rounded operands, float32 sums.
This script computes the Sinkhorn distance between two independent sets of
exact mixture samples (conf/target/gmm.yaml) twice, on the card:

- `direct`: the port's `eval.sinkhorn.Sinkhorn`, whose kernels form the
  distance by direct differences;
- `quadratic_bf16`: the same iterations (the same class, its softmin and
  transport swapped for plain torch in this process only) with the
  distance as the TPU formed it: the dot of bfloat16-rounded operands,
  summed in float32 (TF32 off), the squared norms in float32.

    python scripts/sinkhorn_precision.py [--n 100000] [--seed 0]

It prints the card, then one JSON line with both values, their iteration
counts and seconds. It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROW_CHUNK = 1024  # rows of a dense (ROW_CHUNK, m) distance tile


def quadratic_bf16_distance(x: "torch.Tensor", y: "torch.Tensor") -> "torch.Tensor":
    """sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0)) with x.y on bf16-rounded operands."""
    import torch

    dot = x.bfloat16().float() @ y.bfloat16().float().T
    sq = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :] - 2.0 * dot
    return torch.sqrt(torch.clamp(sq, min=0.0))


def softmin_quadratic(x, y, v, eps):
    """eps * logsumexp_j((-M_ij + v_j) / eps) for every row, M as the TPU's."""
    import torch

    out = [eps * torch.logsumexp((v[None, :] - quadratic_bf16_distance(xc, y)) / eps, dim=1)
           for xc in x.split(ROW_CHUNK)]
    return torch.cat(out)


def transport_quadratic(x, y, u, v, eps):
    """sum_ij exp((-M_ij + u_i + v_j) / eps) M_ij, M as the TPU's; each
    tile's sum in float64."""
    import torch

    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for xc, uc in zip(x.split(ROW_CHUNK), u.split(ROW_CHUNK)):
        m = quadratic_bf16_distance(xc, y)
        total += (torch.exp((-m + uc[:, None] + v[None, :]) / eps) * m).double().sum()
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    import yaml

    if not torch.cuda.is_available():
        sys.exit("sinkhorn_precision: no CUDA device: this measurement needs the card")
    sys.path.insert(0, str(ROOT))
    from sde_sampler_torch.eval.sinkhorn import Sinkhorn
    from sde_sampler_torch.ops import sinkhorn as ops
    from sde_sampler_torch.utils.config import instantiate
    from sde_sampler_torch.utils.device import resolve_device

    device = resolve_device(None)  # full float32 products: TF32 off
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    cfg = yaml.safe_load((ROOT / "conf" / "target" / "gmm.yaml").read_text())
    target = instantiate(cfg).to(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    x = target.sample((args.n,), generator=generator)
    y = target.sample((args.n,), generator=generator)

    result = {"card": card, "n": args.n, "seed": args.seed, "dim": int(x.shape[1])}
    sinkhorn = Sinkhorn()
    for name in ("direct", "quadratic_bf16"):
        kernels = ops.softmin, ops.transport_cost
        if name == "quadratic_bf16":
            ops.softmin, ops.transport_cost = softmin_quadratic, transport_quadratic
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            value = float(sinkhorn(x, y))
            seconds = time.perf_counter() - start
        finally:
            ops.softmin, ops.transport_cost = kernels
        result[name] = {"value": value, "iterations": sinkhorn.n_iters, "seconds": seconds}
        print(f"{name}: {value:.6g} in {sinkhorn.n_iters} iterations, {seconds:.1f} s", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
