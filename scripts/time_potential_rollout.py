"""Time the PotentialCtrl's rollout kernel (csrc/rollout_potential.cu) on the
card at one net shape, for the port's package in a given source tree.

The PotentialCtrl (conf/model/potential.yaml, clip 10) over a FourierMLP of
`--channels` and `--hidden` hidden layers on the VP SDE, weights and inputs
from a numpy seed, B x T EM steps at d. Prints the card's name and power
limit, then one JSON line: the kernel alone and through its wrapper (mean
ms over `--reps` launches by CUDA events), the body's plan where the tree
reports one, the generic body's launch count, and the largest |diff| from
the plain twin. `--root` picks the tree whose `sde_sampler_torch` is timed,
so that two trees can be compared in one run on one card:

    python3 scripts/time_potential_rollout.py --root _proof/parent \
        --channels 32 --hidden 3 --dim 17
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--channels", type=int, default=64)
    parser.add_argument("--hidden", type=int, default=2)
    parser.add_argument("--dim", type=int, default=2)
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from sde_sampler_torch.eq.sdes import VP
    from sde_sampler_torch.models.mlp import FourierMLP
    from sde_sampler_torch.models.reparam import PotentialCtrl
    from sde_sampler_torch.ops import build
    from sde_sampler_torch.ops import rollout as ro

    if not torch.cuda.is_available():
        sys.exit("time_potential_rollout.py: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)

    d, device = args.dim, torch.device("cuda")
    base = FourierMLP(dim=d, num_layers=args.hidden + 2, channels=args.channels, dim_out=1)
    sde = VP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=10.0, terminal_t=1.0)
    ctrl = PotentialCtrl(base_model=base, clip_model=10.0, sde=sde)
    rng = np.random.default_rng(args.seed)
    with torch.no_grad():
        for p in ctrl.parameters():
            b = 1.0 / math.sqrt(p.shape[-1]) if p.ndim == 2 else 0.1
            p.copy_(torch.from_numpy(rng.uniform(-b, b, p.shape).astype(np.float32)))
    ctrl = ctrl.to(device)
    clips = {"clip_model": 10.0, "clip_score": 10.0}
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    ts = torch.linspace(0.0, 1.0, args.steps + 1, device=device)
    x0 = f(rng.standard_normal((args.batch, d)))
    noise = f(rng.standard_normal((args.steps, args.batch, d)))
    noise *= torch.sqrt(ts[1:] - ts[:-1])[:, None, None]

    prepared = ro._prepare(ctrl, x0, ts, noise, clips)
    before = build.FORM_LAUNCHES["rollout.potential.generic"]
    xs, x_T = ro.fused_rollout(ctrl, x0, ts, noise, clips)
    generic = build.FORM_LAUNCHES["rollout.potential.generic"] > before
    xs_p, xT_p = ro.rollout_plain(ctrl, x0, ts, noise, clips)
    err = max(float((xs - xs_p).abs().max()), float((x_T - xT_p).abs().max()))
    try:
        plan = ro.rollout_plan(prepared)._asdict()
    except RuntimeError as exc:  # a tree whose potential form reports no plan
        plan = str(exc).splitlines()[0]
    kernel_ms = cuda_ms(lambda: ro._launch(prepared), args.reps)
    wrapper_ms = cuda_ms(lambda: ro.fused_rollout(ctrl, x0, ts, noise, clips), args.reps)
    print(json.dumps({
        "root": args.root, "channels": args.channels, "hidden": args.hidden, "dim": d,
        "batch": args.batch, "steps": args.steps, "generic_body": generic,
        "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms, "max_abs_err": err, "plan": plan,
    }), flush=True)


if __name__ == "__main__":
    main()
