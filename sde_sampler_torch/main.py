"""Entry point of the PyTorch port.

    python -m sde_sampler_torch.main target=funnel solver=dis loss.method=lv \
        plot_results=False [device=cpu] [out_dir=...] [key=value ...]
    python -m sde_sampler_torch.main -m target=funnel solver=dis,pis seed=1,2 \
        [launcher=joblib launcher.n_jobs=2 | launcher=slurm] [...]

It reads the shared `conf/` tree with the override grammar of
`scripts/main.py` (group=option, key.sub=value, +key=value, ~key) and runs
one job on the CUDA card (`device=cpu` asks for the CPU). Outputs
(metrics.jsonl, the resolved config.yaml, checkpoints) go to `out_dir`, by
default logs/<date>/<time>.

Multirun (`-m` / `--multirun`) expands every override with top-level
commas into the Cartesian product of jobs. Each job gets
`out_dir=<root>/job<i>` (the root is the user's `out_dir=` or
logs/multirun/<date>/<time>, fixed once here) and `+job_id=<i>`, and runs
through the launcher of job 0's `launcher` config (`conf/launcher/`:
`utils/launcher.py`), in process by default.

Unless `wandb.mode=disabled`, a run opens a wandb run (`utils/wandb.py`, a
no-op without the wandb package) whose id hashes `out_dir`, so a requeued
job resumes the same run and, with `restore_ckpt_from_wandb`, its latest
checkpoint artifact.

Data parallelism: `n_devices=W` > 1 runs the job as W processes, the ranks
of one `torch.distributed` group (`parallel/mesh.py::spawn`), which meet
through a file store in out_dir. Rank r runs on cuda:(r % cards), or on the
CPU with `device=cpu`. Rank 0 alone writes config.yaml, main.log and
metrics.jsonl and opens the wandb run; the other ranks log to stderr,
tagged with their rank. Each job of a multirun with `n_devices` > 1 spawns
its own group. Such a run returns a `SpawnedRun` (rank 0's final
metrics) in place of the solver.
"""
from __future__ import annotations

import datetime
import gc
import itertools
import logging
import sys
from pathlib import Path
from typing import NamedTuple

import torch.distributed as dist
import yaml

from sde_sampler_torch.parallel import mesh
from sde_sampler_torch.utils import wandb as wandb_shim
from sde_sampler_torch.utils.config import compose, instantiate, locate

REPO_ROOT = Path(__file__).resolve().parents[1]
CONF_DIR = REPO_ROOT / "conf"


def _split_choices(values: str) -> list[str]:
    """Split on top-level commas only (commas inside [...], {...} and (...)
    belong to one value, as in hydra's sweep grammar)."""
    parts, depth, cur = [], 0, []
    for ch in values:
        if ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _expand_multirun(overrides: list[str]) -> list[list[str]]:
    """The Cartesian product over comma-separated override values (hydra -m)."""
    choices = []
    for ov in overrides:
        parts = _split_choices(ov.split("=", 1)[1]) if "=" in ov else []
        if len(parts) > 1:
            key = ov.partition("=")[0]
            choices.append([f"{key}={v}" for v in parts])
        else:
            choices.append([ov])
    return [list(combo) for combo in itertools.product(*choices)]


def _job_overrides(jobs: list[list[str]]) -> list[list[str]]:
    """Give every job a stable out_dir (<root>/job<i>) and +job_id=<i>.

    The root is the user's out_dir= or a timestamped multirun root fixed
    here, once, so requeued or parallel jobs never race to a fresh
    timestamp (the wandb run id hashes the out_dir)."""
    now = datetime.datetime.now()
    default_root = (
        REPO_ROOT / "logs" / "multirun" / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")
    )
    out = []
    for i, job in enumerate(jobs):
        job = [f"out_dir={ov.split('=', 1)[1]}/job{i}" if ov.startswith("out_dir=") else ov
               for ov in job]
        if not any(ov.startswith("out_dir=") for ov in job):
            job.append(f"out_dir={default_root}/job{i}")
        out.append(job + [f"+job_id={i}"])
    return out


def run_job(overrides: list[str]) -> dict:
    """One job of an in-process multirun: its final metrics (host floats).
    The solver, with its card tensors, is freed before the next job (the
    solver and its scheduler reference each other, so only the cycle
    collector frees them)."""
    solver = main(overrides)
    metrics = dict(solver.last_metrics)
    del solver
    gc.collect()
    return metrics


def multirun(overrides: list[str]) -> list:
    """Expand the overrides into jobs and run them through the launcher of
    job 0's config; a subprocess launcher's failed job fails the sweep."""
    from sde_sampler_torch.utils.launcher import SequentialLauncher

    jobs = _job_overrides(_expand_multirun(overrides))
    launcher_cfg = compose(CONF_DIR, "base", jobs[0]).get("launcher")
    launcher = instantiate(launcher_cfg) if launcher_cfg else SequentialLauncher()
    results = launcher.run(jobs, run_job)
    # subprocess launchers return exit codes; the sequential one raises
    failed = [i for i, rc in enumerate(results) if isinstance(rc, int) and rc != 0]
    if failed:
        raise SystemExit(
            f"multirun: {len(failed)}/{len(results)} jobs failed (indices {failed})"
        )
    return results


def _out_dir(cfg: dict) -> Path:
    """The config's out_dir, by default logs/<date>/<time>."""
    if cfg.get("out_dir"):
        return Path(cfg["out_dir"])
    now = datetime.datetime.now()
    return REPO_ROOT / "logs" / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")


def compose_run(overrides: list[str], rank: int | None = None, cfg: dict | None = None) -> dict:
    """Compose the config (unless `cfg` is the one composed from these
    overrides), create out_dir, log to out_dir/main.log and write the
    resolved config.yaml. `rank`: this process's rank in a data-parallel
    run, whose log lines carry it; a rank other than 0 writes nothing and
    logs to stderr only."""
    if cfg is None:
        cfg = compose(CONF_DIR, "base", overrides)
    out_dir = _out_dir(cfg)
    cfg["out_dir"] = str(out_dir)
    handlers = [logging.StreamHandler()]
    if not rank:
        out_dir.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(out_dir / "main.log"))
    tag = "" if rank is None else f"[rank {rank}]"
    logging.basicConfig(
        level=logging.INFO,
        format=f"[%(asctime)s]{tag}[%(levelname)s] %(message)s",
        handlers=handlers,
        force=True,
    )
    logging.info("Output directory: %s", out_dir)
    if not rank:
        with open(out_dir / "config.yaml", "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
    return cfg


def init_wandb(cfg: dict, overrides: list[str]) -> dict:
    """Open the run's wandb run unless wandb.mode is disabled; on a resumed
    run with merge_wandb_resume_cfg, merge its stored config under cfg."""
    wandb_cfg = cfg.get("wandb") or {}
    if wandb_cfg.get("mode") == "disabled":
        return cfg
    wandb_shim.init(
        project=wandb_cfg.get("project"),
        name=wandb_cfg.get("name"),
        tags=wandb_cfg.get("tags") or [t for t in overrides if len(t) < 32],
        id=wandb_cfg.get("id") or wandb_shim.run_id_for_dir(cfg["out_dir"]),
        resume="allow",
        mode=wandb_cfg.get("mode", "run"),
        dir=cfg["out_dir"],
        config=dict(cfg),
    )
    if getattr(wandb_shim.run, "resumed", False) and cfg.get("merge_wandb_resume_cfg"):
        cfg = wandb_shim.merge_wandb_cfg(cfg) or cfg
    return cfg


def make_solver(overrides: list[str]):
    """Compose the config and build (not set up) the solver it names."""
    cfg = compose_run(overrides)
    return locate(cfg["solver"]["_target_"])(cfg)


class SpawnedRun(NamedTuple):
    """What a run of n_devices ranks returns in place of its solver."""

    last_metrics: dict  # rank 0's final metrics


def _rank_run(rank: int, overrides: list[str]) -> dict:
    """A spawned rank's job: `main` with its group up; its final metrics."""
    return dict(main(overrides).last_metrics)


def spawn_run(overrides: list[str], cfg: dict) -> SpawnedRun:
    """The job as n_devices ranks, on out_dir fixed here once (the ranks
    would otherwise each stamp their own default)."""
    out_dir = _out_dir(cfg)
    out_dir.mkdir(parents=True, exist_ok=True)
    overrides = [ov for ov in overrides if not ov.startswith("out_dir=")]
    overrides.append(f"out_dir={out_dir}")
    metrics = mesh.spawn(_rank_run, cfg["n_devices"], device=cfg.get("device") or "cuda",
                         args=(overrides,), store_dir=out_dir)
    return SpawnedRun(metrics[0])


def main(argv: list[str] | None = None):
    """Run one job and return the solver after its final evaluation (a
    `SpawnedRun` for n_devices > 1); with -m, run the multirun and return
    each job's final metrics (in process) or exit code (subprocess
    launchers)."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    if "-m" in overrides or "--multirun" in overrides:
        return multirun([ov for ov in overrides if ov not in ("-m", "--multirun")])
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else None
    cfg = None
    if rank is None:
        cfg = compose(CONF_DIR, "base", overrides)
        if (cfg.get("n_devices") or 1) > 1:
            return spawn_run(overrides, cfg)
    cfg = compose_run(overrides, rank, cfg)
    if not rank:
        cfg = init_wandb(cfg, overrides)
    if rank is not None:  # a resumed wandb run may have merged its config
        cfg = mesh.broadcast_object(cfg, dist.group.WORLD)
    try:
        solver = locate(cfg["solver"]["_target_"])(cfg)
        solver.setup()
        solver()
        wandb_shim.summary_update({"error": None})
        wandb_shim.finish()
        return solver
    except Exception as e:
        logging.exception("Run failed")
        wandb_shim.summary_update({"error": str(e)})
        wandb_shim.finish(exit_code=1)
        raise


if __name__ == "__main__":
    main()
