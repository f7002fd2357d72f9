#!/usr/bin/env python3
"""Where a step of the rollout kernels' DenseNet body spends its cycles (card only).

    python3 scripts/dense_phase_split.py [--root TREE] [--instances a,b] [--modes m,n]

Copies TREE's `sde_sampler_torch/`, `chip_smoke.py` and `conf/` (default:
this checkout's) into `sde_sampler_torch/_build/phase_split/` of this
checkout (listed in .gitignore), turns on the DenseNet body's phase marks in the copy's
`csrc/rollout.cuh` (SDE_DENSE_PHASES: block 0's thread 0 reads clock64()
at each phase's end), builds it, and launches each chip_smoke.py INSTANCES
label once in each mode asked for ("shape": the mode its shape takes; a
mode the shape or the tree lacks is skipped), at its path's shapes. Each
launch prints its cycles a step, by phase; the marks cost a few cycles
each. A tree whose body has no marks is refused.
"""
import argparse
import importlib
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARKED = "#define SDE_DENSE_PHASES 1\n#include <cstdio>\n"


def instrument(header: Path) -> None:
    text = header.read_text()
    if "DENSE_PHASE(" not in text:
        raise SystemExit(f"{header}: the DenseNet body has no phase marks")
    header.write_text(MARKED + text)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=ROOT)
    parser.add_argument("--instances", default="rollout.lerp.gmm.dense,rollout.lerp.wells.dense,"
                                                "rollout_exp.score.funnel.dense")
    parser.add_argument("--modes", default="shape,dense,dense_streamed")
    args = parser.parse_args()

    work = ROOT / "sde_sampler_torch" / "_build" / "phase_split"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(args.root / "sde_sampler_torch", work / "sde_sampler_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(args.root / "chip_smoke.py", work / "chip_smoke.py")
    shutil.copytree(args.root / "conf", work / "conf")
    instrument(work / "sde_sampler_torch" / "csrc" / "rollout.cuh")
    sys.path.insert(0, str(work))
    try:
        import torch

        smoke = importlib.import_module("chip_smoke")
        from sde_sampler_torch.ops import build
        from sde_sampler_torch.ops import rollout as ro

        print(f"{args.root}: {smoke.card_line()}", flush=True)
        build.library()
        device = torch.device("cuda")
        for label in args.instances.split(","):
            _, _, prepare, x0, ts, noise, _ = smoke.seeded_instance(device, label, smoke.SEED + 1)
            prepared = prepare(x0, ts, noise)
            for mode in args.modes.split(","):
                try:
                    plan = ro.rollout_plan(prepared, mode)
                except (KeyError, RuntimeError) as err:  # a mode this shape or tree lacks
                    print(f"{label} {mode}: refused ({err!r})", flush=True)
                    continue
                print(f"{label} {mode}: plan {plan}", flush=True)
                ro._launch(prepared, mode)
                torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
