#!/usr/bin/env python3
"""Save, or compare, the bits of kernel 1's and 2's rollout instances.

    python3 scripts/rollout_bits.py --root <tree> --out <file.npz> [label ...]
    python3 scripts/rollout_bits.py --compare <a.npz> <b.npz>

The first form builds the kernels of the checkout at <tree> (card only),
runs each rollout instance of that tree's `chip_smoke.py` INSTANCES (the
labels given, or all) through its wrapper on the inputs its kernels phase
draws (the same seed for the same label), and saves the states xs and x_T.
The second prints, for every label in both files, whether the two trees
gave the same bits, and exits non-zero if any differs. Run both trees in
one call, each from its own checkout, to show that a change to the kernels
leaves an instance's results as they were. The states are large at the
paths' shapes (Cox's alone 2.6 GB): write the files where nothing copies
them back from the card, or name the labels.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def save(root: Path, out: Path, labels: list[str]) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    arrays = {}
    for i, label in enumerate(smoke.ROLLOUT_INSTANCES):
        if labels and label not in labels:
            continue
        seed = smoke.INSTANCES[label].get("seed", smoke.SEED + 10 + i)
        run, _, _, x0, ts, noise, _ = smoke.seeded_instance("cuda", label, seed)
        xs, x_T = run(x0, ts, noise)
        torch.cuda.synchronize()
        arrays[f"{label}/xs"], arrays[f"{label}/x_T"] = xs.cpu().numpy(), x_T.cpu().numpy()
    np.savez(out, **arrays)
    print(f"{root}: {len(arrays) // 2} instances saved to {out}", flush=True)


def compare(a: Path, b: Path) -> bool:
    import numpy as np

    left, right = np.load(a), np.load(b)
    same = True
    for name in sorted(set(left.files) & set(right.files)):
        equal = left[name].tobytes() == right[name].tobytes()
        same &= equal
        print(f"{name}: {'the same bits' if equal else 'DIFFERENT bits'}", flush=True)
    return same


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("labels", nargs="*")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--out", type=Path)
    parser.add_argument("--compare", type=Path, nargs=2)
    args = parser.parse_args()
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    if args.out is None:
        parser.error("give --out, or --compare")
    save(args.root.resolve(), args.out, args.labels)


if __name__ == "__main__":
    main()
