"""Multirun launchers: in process, as a local process pool, or on Slurm.

Port of `sde_sampler_tpu/utils/launcher.py` with the same class names, which
`conf/launcher/joblib.yaml` and `slurm.yaml` name (the config engine maps
them here). A subprocess job runs `python -m sde_sampler_torch.main <job>`
from the repository root, so a child finds the package without PYTHONPATH
(which `clean_pythonpath` drops); relative paths in its overrides resolve
against the root. A child runs on the card unless its overrides say
`device=cpu`; without a card it fails, and so does the sweep.

A job whose overrides say `n_devices=W` (W > 1) is one process that spawns
its W ranks itself (`sde_sampler_torch/main.py`), under every launcher: a
pool slot then holds the W ranks, and a Slurm job asks for one task with W
cards (`--gpus-per-task=W`, unless `gres` says otherwise or the job runs
on the CPU).
"""
from __future__ import annotations

import logging
import os
import shlex
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def job_command(job: list[str]) -> list[str]:
    """The command that runs one job in its own process."""
    return [sys.executable, "-m", "sde_sampler_torch.main", *job]


def job_cards(job: list[str]) -> int:
    """The cards a job's ranks take: its n_devices (1 without), 0 on the CPU."""
    values = dict(ov.split("=", 1) for ov in job if "=" in ov)
    if values.get("device") == "cpu":
        return 0
    return max(int(values.get("n_devices") or 1), 1)


class SequentialLauncher:
    """In-process sequential execution (the default multirun behaviour)."""

    def run(self, jobs: list[list[str]], main_fn) -> list:
        results = []
        for i, job in enumerate(jobs):
            logging.info("[multirun %d/%d] %s", i + 1, len(jobs), " ".join(job))
            results.append(main_fn(job))
        return results


class ProcessPoolLauncher:
    """Run multirun jobs as parallel `sde_sampler_torch.main` subprocesses.

    Args:
        n_jobs: maximum concurrent jobs.
        env: environment overlay applied to every job.
        slot_env: per-slot overlays cycled by job index (e.g. one
            CUDA_VISIBLE_DEVICES per slot).
        clean_pythonpath: drop PYTHONPATH in the children.
    """

    def __init__(
        self,
        n_jobs: int = 4,
        env: dict | None = None,
        slot_env: list[dict] | None = None,
        clean_pythonpath: bool = False,
        **kwargs,
    ):
        self.n_jobs = int(n_jobs)
        self.env = {k: str(v) for k, v in (env or {}).items()}
        self.slot_env = [
            {k: str(v) for k, v in overlay.items()} for overlay in (slot_env or [])
        ]
        self.clean_pythonpath = clean_pythonpath

    def _job_env(self, idx: int) -> dict:
        env = os.environ.copy()
        if self.clean_pythonpath:
            env.pop("PYTHONPATH", None)
        env.update(self.env)
        if self.slot_env:
            env.update(self.slot_env[idx % len(self.slot_env)])
        return env

    def _run_one(self, idx: int, job: list[str]) -> int:
        logging.info("[multirun job %d] %s", idx, " ".join(job))
        start = time.time()
        proc = subprocess.run(job_command(job), env=self._job_env(idx), cwd=REPO_ROOT)
        logging.info(
            "[multirun job %d] rc=%d (%.1fs)", idx, proc.returncode, time.time() - start
        )
        return proc.returncode

    def run(self, jobs: list[list[str]], main_fn=None) -> list[int]:
        # threads only wait on the subprocesses; the parallelism is processes
        with ThreadPoolExecutor(max_workers=self.n_jobs) as pool:
            futures = [pool.submit(self._run_one, i, job) for i, job in enumerate(jobs)]
            codes = [f.result() for f in futures]
        failed = [i for i, c in enumerate(codes) if c != 0]
        if failed:
            logging.error("multirun jobs failed: %s", failed)
        return codes


class SlurmLauncher:
    """Submitit-style Slurm launcher (conf/launcher/slurm.yaml).

    Writes one sbatch script per multirun job and submits it with `sbatch`.
    `--requeue` and the wandb run id hashed from out_dir (utils/wandb.py)
    give the preemption-resume flow: a requeued job gets the same run id and
    restores its latest checkpoint. Without `sbatch` on PATH (or with
    submit=False) the scripts are only written under `sbatch_dir`.
    """

    def __init__(
        self,
        nodes: int = 1,
        cpus_per_task: int = 2,
        timeout_min: int = 4320,
        partition: str | None = None,
        qos: str | None = None,
        constraint: str | None = None,
        gres: str | None = None,
        max_num_timeout: int = 3,
        submit: bool | None = None,
        sbatch_dir: str | None = None,
        env: dict | None = None,
        **kwargs,
    ):
        self.nodes = int(nodes)
        self.cpus_per_task = int(cpus_per_task)
        self.timeout_min = int(timeout_min)
        self.partition = partition
        self.qos = qos
        self.constraint = constraint
        self.gres = gres
        self.max_num_timeout = int(max_num_timeout)
        self.submit = submit
        self.sbatch_dir = sbatch_dir
        self.env = {k: str(v) for k, v in (env or {}).items()}

    def _script(self, idx: int, job: list[str], out_dir: Path) -> str:
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name=sde_sampler_{idx}",
            f"#SBATCH --nodes={self.nodes}",
            # one training process whatever the nodes (nodes > 1 only
            # reserves them, as submitit does)
            "#SBATCH --ntasks=1",
            f"#SBATCH --cpus-per-task={self.cpus_per_task}",
            f"#SBATCH --time={self.timeout_min}",
            f"#SBATCH --output={out_dir}/slurm_%j.out",
            "#SBATCH --open-mode=append",
            "#SBATCH --requeue",
        ]
        for flag, value in (
            ("partition", self.partition),
            ("qos", self.qos),
            ("constraint", self.constraint),
            ("gres", self.gres),
        ):
            if value:
                lines.append(f"#SBATCH --{flag}={value}")
        if not self.gres and job_cards(job) > 1:
            # the one task spawns the job's ranks, a card each
            lines.append(f"#SBATCH --gpus-per-task={job_cards(job)}")
        lines.append("")
        # submitit enforces max_num_timeout on the client; here the script
        # stops once SLURM_RESTART_COUNT exceeds it
        lines.append(
            f"if [ \"${{SLURM_RESTART_COUNT:-0}}\" -gt "
            f"{self.max_num_timeout} ]; then\n"
            f"  echo 'max_num_timeout ({self.max_num_timeout}) exceeded'; "
            f"exit 1\nfi"
        )
        for key, value in self.env.items():
            lines.append(f"export {key}={shlex.quote(str(value))}")
        command = " ".join(shlex.quote(part) for part in job_command(job))
        lines.append(f"srun --chdir={shlex.quote(str(REPO_ROOT))} {command}")
        return "\n".join(lines) + "\n"

    def run(self, jobs: list[list[str]], main_fn=None) -> list[int]:
        sbatch_dir = Path(self.sbatch_dir or Path.cwd() / "sbatch")
        sbatch_dir.mkdir(parents=True, exist_ok=True)
        submit = self.submit
        if submit is None:
            submit = shutil.which("sbatch") is not None
        codes = []
        for i, job in enumerate(jobs):
            out_dir = sbatch_dir / f"job_{i}"
            out_dir.mkdir(parents=True, exist_ok=True)
            script = sbatch_dir / f"job_{i}.sh"
            script.write_text(self._script(i, job, out_dir))
            if submit:
                proc = subprocess.run(["sbatch", str(script)], capture_output=True, text=True)
                logging.info(
                    "[multirun job %d] sbatch rc=%d %s", i, proc.returncode, proc.stdout.strip()
                )
                codes.append(proc.returncode)
            else:
                logging.info("[multirun job %d] wrote %s (sbatch unavailable)", i, script)
                codes.append(0)
        return codes
