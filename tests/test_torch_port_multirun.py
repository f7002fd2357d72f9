"""The port's multirun, launchers and offline sweep against the JAX package's.

`sde_sampler_torch/main.py`'s `_split_choices`, `_expand_multirun` and the
per-job out_dir / +job_id rewriting give the job lists of `scripts/main.py`;
`sde_sampler_torch/sweep.py` gives `scripts/sweep.py`'s overrides and
refusals; the port's SlurmLauncher writes the JAX launcher's sbatch scripts
line for line but the command it runs. Then, on the CPU: two process-pool
jobs overlap, a failed child (a bad override, or a child asked to run on a
card that is not there) fails the sweep, `python -m sde_sampler_torch.sweep`
runs a two-job grid that `scripts/collect_results.py` tabulates, and
concurrent cold processes build the kernel library once.
"""
from __future__ import annotations

import datetime as real_datetime
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import yaml

from sde_sampler_torch import main as port_main
from sde_sampler_torch import sweep as port_sweep
from sde_sampler_torch.utils import launcher as port_launcher

REPO_ROOT = Path(__file__).resolve().parents[1]
TINY = ["train_steps=2", "train_batch_size=8", "train_timesteps.steps=4", "eval_batch_size=16",
        "eval_init=False", "plot_results=False", "device=cpu"]
# the children of the process-pool tests: few threads each
POOL = ["launcher=joblib", "launcher.n_jobs=2", "launcher.clean_pythonpath=True",
        "launcher.env.OMP_NUM_THREADS=2"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_main():
    return _load("jax_scripts_main", REPO_ROOT / "scripts" / "main.py")


@pytest.fixture(scope="module")
def jax_sweep():
    return _load("jax_scripts_sweep", REPO_ROOT / "scripts" / "sweep.py")


OVERRIDE_LISTS = {
    "two_sweeps": ["solver=dis,pis", "loss.method=kl,lv", "seed=1"],
    "exp_repr_grid": ["solver=dis,pis,dds", "loss.method=kl,lv", "target=dw_shift,gmm,funnel"],
    "bracketed": ["target=gmm", "+target.extra=[[0,1],[1,0]]", "seed=1,2,3"],
    "parenthesised_and_braced": ["+a=(1,2)", "+b={x:1,y:2},{x:3}", "seed=1,2"],
    "single_value": ["seed=1"],
    "out_dir_and_deletion": ["out_dir=/tmp/sweep", "seed=1,2", "~eval_sample_losses", "+flag"],
}


@pytest.mark.parametrize("name", sorted(OVERRIDE_LISTS))
def test_expansion_matches_jax(jax_main, name):
    overrides = OVERRIDE_LISTS[name]
    for ov in overrides:
        if "=" in ov:
            value = ov.split("=", 1)[1]
            assert port_main._split_choices(value) == jax_main._split_choices(value)
    jobs = port_main._expand_multirun(overrides)
    assert jobs == jax_main._expand_multirun(overrides)
    assert len(jobs) == {"two_sweeps": 4, "exp_repr_grid": 18, "bracketed": 3,
                         "parenthesised_and_braced": 4, "single_value": 1,
                         "out_dir_and_deletion": 2}[name]


@pytest.mark.parametrize("out_dir", [True, False], ids=["user_out_dir", "default_root"])
def test_job_overrides_match_jax(jax_main, monkeypatch, tmp_path, out_dir):
    """-m through both mains with the in-process launcher recording its jobs:
    the same out_dir=<root>/job<i> and +job_id=<i> per job."""
    from sde_sampler_tpu.utils import launcher as jax_launcher

    fixed = real_datetime.datetime(2026, 1, 2, 3, 4, 5)
    clock = types.SimpleNamespace(datetime=types.SimpleNamespace(now=lambda: fixed))
    for mod in (jax_main, port_main):
        monkeypatch.setattr(mod, "datetime", clock)
    for launcher in (jax_launcher, port_launcher):
        monkeypatch.setattr(launcher.SequentialLauncher, "run", lambda self, jobs, fn: jobs)
    overrides = ["-m", "target=dw_shift", "solver=basic_dis", "seed=1,2"]
    overrides += [f"out_dir={tmp_path}"] if out_dir else []
    jobs = port_main.main(list(overrides))
    assert jobs == jax_main.main(list(overrides))
    root = tmp_path if out_dir else REPO_ROOT / "logs" / "multirun" / "2026-01-02" / "03-04-05"
    assert [job[-2:] for job in jobs] == [[f"out_dir={root}/job{i}", f"+job_id={i}"]
                                          for i in range(2)]


def test_sweep_overrides_match_jax(jax_sweep):
    exp_repr = yaml.safe_load((REPO_ROOT / "conf" / "sweeps" / "exp_repr.yaml").read_text())
    mixed = {"method": "grid", "parameters": {
        "seed": {"values": [1, 2, 3]}, "target": {"value": "gmm"},
        "+target.extra": {"values": ["[1,2]", "[3,4]"]}}}
    for cfg in (exp_repr, mixed):
        assert port_sweep.sweep_overrides(cfg) == jax_sweep.sweep_overrides(cfg)
    assert port_sweep.sweep_overrides(exp_repr) == [
        "solver=dis,pis,dds", "loss.method=kl,lv", "target=dw_shift,gmm,funnel"]


@pytest.mark.parametrize("cfg", [
    {"method": "random", "parameters": {"seed": {"values": [1, 2]}}},
    {"method": "grid", "parameters": {"target": {"values": ["gmm", "a,b"]}}},
    {"method": "grid", "parameters": {"seed": {"min": 1, "max": 2}}},
], ids=["not_grid", "top_level_comma", "no_values"])
def test_sweep_refusals_match_jax(jax_sweep, cfg):
    with pytest.raises(ValueError) as port_err:
        port_sweep.sweep_overrides(cfg)
    with pytest.raises(ValueError) as jax_err:
        jax_sweep.sweep_overrides(cfg)
    assert str(port_err.value) == str(jax_err.value)


def test_slurm_scripts_match_jax_but_the_command(tmp_path):
    """The sbatch scripts of both launchers, line for line, but the srun
    line; and `-m launcher=slurm` writes one per job off-cluster."""
    from sde_sampler_tpu.utils import launcher as jax_launcher

    kwargs = dict(nodes=2, cpus_per_task=4, timeout_min=60, partition="gpu", qos="high",
                  gres="gpu:1", max_num_timeout=5, env={"OMP_NUM_THREADS": 4, "X": "a b"})
    job = ["target=funnel", "solver=dis", "seed=1", "out_dir=/tmp/x y/job0", "+job_id=0"]
    port = port_launcher.SlurmLauncher(**kwargs)._script(0, job, tmp_path).splitlines()
    jax = jax_launcher.SlurmLauncher(**kwargs)._script(0, job, tmp_path).splitlines()
    assert port[:-1] == jax[:-1] and len(port) == len(jax)
    assert port[-1] == (f"srun --chdir={REPO_ROOT} {sys.executable} -m sde_sampler_torch.main "
                        "target=funnel solver=dis seed=1 'out_dir=/tmp/x y/job0' +job_id=0")

    codes = port_main.main(["-m", "target=dw_shift", "solver=basic_dis", "seed=1,2",
                            "launcher=slurm", "launcher.partition=gpu", "launcher.submit=False",
                            f"launcher.sbatch_dir={tmp_path}/sbatch", f"out_dir={tmp_path}"])
    assert codes == [0, 0]
    for i in range(2):
        script = (tmp_path / "sbatch" / f"job_{i}.sh").read_text()
        for line in ("#SBATCH --requeue", "#SBATCH --open-mode=append", "#SBATCH --partition=gpu",
                     "#SBATCH --time=4320", "SLURM_RESTART_COUNT"):
            assert line in script
        assert f" seed={1 + i} " in script
        assert script.endswith(f" out_dir={tmp_path}/job{i} +job_id={i}\n")
        assert "-m sde_sampler_torch.main" in script


_TS = re.compile(r"^\[(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2},\d{3})\]")


def _log_span(path: Path):
    stamps = [real_datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
              for line in path.read_text().splitlines() if (m := _TS.match(line))]
    return min(stamps), max(stamps)


def test_process_pool_jobs_overlap(tmp_path):
    codes = port_main.main(["-m", "target=dw_shift", "solver=basic_dis", "seed=1,2", *TINY,
                            *POOL, f"out_dir={tmp_path}"])
    assert codes == [0, 0]
    spans = []
    for i in range(2):
        job_dir = tmp_path / f"job{i}"
        last = json.loads((job_dir / "metrics.jsonl").read_text().splitlines()[-1])
        assert "eval/log_norm_const_is" in last
        log = (job_dir / "main.log").read_text()
        assert "Kernel launches of this run: {}" in log  # the CPU: plain versions only
        assert yaml.safe_load((job_dir / "config.yaml").read_text())["job_id"] == i
        spans.append(_log_span(job_dir / "main.log"))
    assert spans[1][0] < spans[0][1] and spans[0][0] < spans[1][1], f"no overlap: {spans}"


@pytest.mark.parametrize("bad", [["loss.method=bogus_method", "device=cpu"], []],
                         ids=["bad_override", "child_without_a_card"])
def test_failed_child_fails_the_sweep(tmp_path, bad):
    """A child that fails fails the sweep; without device=cpu a child asks
    for the card, which fails where there is none: it must not run on the CPU."""
    with pytest.raises(SystemExit, match="multirun: 2/2 jobs failed"):
        port_main.main(["-m", "target=dw_shift", "solver=basic_dis", "seed=1,2",
                        "train_steps=2", *bad, *POOL, f"out_dir={tmp_path}"])
    for i in range(2):
        assert not (tmp_path / f"job{i}" / "metrics.jsonl").exists()
    if not bad:
        assert "No CUDA device is available" in (tmp_path / "job0" / "main.log").read_text()


@pytest.fixture(scope="module")
def sweep_run(tmp_path_factory):
    """`python -m sde_sampler_torch.sweep` on a two-job grid, in process."""
    tmp = tmp_path_factory.mktemp("sweep")
    sweep_yaml = tmp / "sweep.yaml"
    sweep_yaml.write_text("method: grid\nparameters:\n  seed:\n    values: [1, 2]\n"
                          "  target:\n    value: gmm\n")
    proc = subprocess.run(
        [sys.executable, "-m", "sde_sampler_torch.sweep", str(sweep_yaml), "solver=dis",
         "loss.method=lv", *TINY, "target.n_reference_samples=500", f"out_dir={tmp}/out"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return tmp / "out"


def test_sweep_module_runs_a_grid(sweep_run):
    for i, seed in enumerate((1, 2)):
        cfg = yaml.safe_load((sweep_run / f"job{i}" / "config.yaml").read_text())
        assert (cfg["seed"], cfg["job_id"], cfg["target"]["_target_"]) == (
            seed, i, "sde_sampler_tpu.distr.gauss.GMM")
        last = json.loads((sweep_run / f"job{i}" / "metrics.jsonl").read_text().splitlines()[-1])
        assert "error/sinkhorn" in last


def test_collect_results_tabulates_the_port_jobs(sweep_run):
    """scripts/collect_results.py, used as is, gives one row per job of a
    port multirun, from the port's metric names."""
    collect = _load("collect_results_for_port", REPO_ROOT / "scripts" / "collect_results.py")
    rows = [line for line in collect.table(str(sweep_run)).splitlines()
            if line.startswith("| job")]
    assert [row.split(" | ")[0] for row in rows] == ["| job0", "| job1"]
    for i, row in enumerate(rows):
        last = json.loads((sweep_run / f"job{i}" / "metrics.jsonl").read_text().splitlines()[-1])
        cells = row.strip("| ").split(" | ")
        assert cells[1] == collect.fmt(last["error/log_norm_const_is"])
        assert cells[3] == collect.fmt(last["error/sinkhorn"])
        assert cells[4] == collect.fmt(last["eval/norm_effective_sample_size"])
        assert "—" not in cells[1:5]


LOCK_CHILD = """
import ctypes, sys, time, types
from pathlib import Path
from sde_sampler_torch.ops import build

build.BUILD_DIR = Path(sys.argv[1])
build.library_path = lambda: build.BUILD_DIR / "libstand_in.so"

def stand_in_build(lib_path, sources):
    with open(build.BUILD_DIR / "builds.txt", "a") as f:
        f.write("build\\n")
    time.sleep(1.0)
    lib_path.write_bytes(b"stand-in")

build._build = stand_in_build
ctypes.CDLL = lambda path: types.SimpleNamespace(
    path=path, **{name: types.SimpleNamespace() for name in build.SIGNATURES})
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
print(build.library().path)
"""


def test_concurrent_cold_processes_build_the_library_once(tmp_path):
    """Two processes that find no library at the same moment: one builds
    under the lock, the other waits and loads what it wrote."""
    import time

    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", LOCK_CHILD, str(tmp_path), str(start)],
                              cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [out.strip() for out, _ in outs] == [str(tmp_path / "libstand_in.so")] * 2
    assert (tmp_path / "builds.txt").read_text() == "build\n"
    assert (tmp_path / "libstand_in.so").read_bytes() == b"stand-in"
