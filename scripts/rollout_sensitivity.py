"""How far a rollout's own plain twin moves when x0 moves by one ulp.

A rollout kernel and its plain twin sum in other orders, so they part by
rounding at every step; how far that carries over T steps is a property of
the rollout itself (the control and the target's score), not of the
kernel. This script takes an instance of `chip_smoke.py`'s INSTANCES (its
control, weights, grid and inputs from the same numpy seed) and runs the
plain twin twice on the CPU, from x0 and from x0 moved one ulp up, printing
the largest |diff| of the states at a few steps and the largest |x|:

    python3 scripts/rollout_sensitivity.py rollout.lerp.given.dense --batch 64

(the seed is chip_smoke.py's for the instance unless --seed is given).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("label", help="an INSTANCES label of chip_smoke.py")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--target", default=None,
                        help="a conf/target name in place of the instance's")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs

    labels = list(cs.INSTANCES)
    spec = cs.INSTANCES[args.label]
    if args.target is not None:
        spec["target"], spec["target_kwargs"] = args.target, {}
    seed = args.seed if args.seed is not None else spec.get(
        "seed", cs.SEED + 10 + labels.index(args.label))
    _, plain, _, x0, ts, noise, _ = cs.seeded_instance(torch.device("cpu"), args.label, seed,
                                                       batch=args.batch)
    xs = plain(x0, ts, noise)[0]
    moved = plain(torch.nextafter(x0, torch.full_like(x0, float("inf"))), ts, noise)[0]
    diff = (xs - moved).abs().amax(dim=(1, 2))
    T = xs.shape[0]
    steps = sorted({1, 10, T // 4, T // 2, 3 * T // 4, T - 1})
    print(f"{args.label} (target {spec['target']}, d {x0.shape[1]}, B {args.batch}, T {T}, "
          f"seed {seed}): max |diff| after one ulp of x0, by step "
          + ", ".join(f"{k}: {float(diff[k]):.1e}" for k in steps)
          + f"; max |x| {float(xs.abs().max()):.3g}")


if __name__ == "__main__":
    main()
