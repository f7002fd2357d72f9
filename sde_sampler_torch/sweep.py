"""Run a wandb-style grid sweep config without a wandb server.

Port of `scripts/sweep.py`: a `method: grid` sweep (conf/sweeps/*.yaml) is
expanded into multirun overrides and run through `sde_sampler_torch.main`'s
launchers (in process by default; `launcher=joblib` or `launcher=slurm`):

    python -m sde_sampler_torch.sweep conf/sweeps/exp_repr.yaml [overrides...]

The extra overrides are appended to every job (e.g. `train_steps=100
launcher=joblib device=cpu`).
"""
from __future__ import annotations

import sys

import yaml

from sde_sampler_torch import main as entry


def sweep_overrides(sweep_cfg: dict) -> list[str]:
    """The multirun overrides of a wandb grid sweep's `parameters` block."""
    method = sweep_cfg.get("method", "grid")
    if method != "grid":
        raise ValueError(f"only method: grid sweeps are supported offline, got {method!r}")
    overrides = []
    for key, spec in (sweep_cfg.get("parameters") or {}).items():
        if "values" in spec:
            values = spec["values"]
        elif "value" in spec:
            values = [spec["value"]]
        else:
            raise ValueError(f"parameter {key!r} needs `values` or `value`")
        for v in values:
            # the values are joined with commas, which the multirun grammar
            # splits at top level: a value that main's own splitter would cut
            # into several jobs is refused here
            if len(entry._split_choices(str(v))) > 1:
                raise ValueError(
                    f"value {v!r} for {key!r} contains a top-level comma; "
                    "wrap it in [...] or quote it differently"
                )
        overrides.append(f"{key}=" + ",".join(str(v) for v in values))
    return overrides


def main(argv: list[str] | None = None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: python -m sde_sampler_torch.sweep <sweep.yaml> [overrides...]")
    sweep_file, extra = argv[0], argv[1:]
    with open(sweep_file) as f:
        sweep_cfg = yaml.safe_load(f)
    return entry.main(["-m", *sweep_overrides(sweep_cfg), *extra])


if __name__ == "__main__":
    main()
