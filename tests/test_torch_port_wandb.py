"""The port's wandb shim and preemption-resume flow, against tests/fake_wandb.py.

The cases of tests/test_wandb_flow.py on `sde_sampler_torch/utils/wandb.py`
(run id = SHA-256 of out_dir, equal to the JAX shim's; the resume-config
merge; checkpoint artifact upload, restore and clean-up; the guard), the
wandb run that `sde_sampler_torch.main` opens, and the preemption flow: a
job uploads its checkpoints, loses its out_dir, and the requeued job
restores the latest artifact and trains on. Beyond the JAX side's cases: a
job preempted after its step-4 checkpoint and requeued ends with the
parameters, bit for bit, of the same job run without interruption.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from sde_sampler_torch import main as port_main
from sde_sampler_torch.solver.base import Trainable, latest_checkpoint
from sde_sampler_torch.utils import wandb as wandb_shim

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "tests"))

import fake_wandb  # noqa: E402

TINY = ["train_batch_size=8", "train_timesteps.steps=4", "eval_batch_size=16",
        "eval_init=False", "plot_results=False", "device=cpu"]
# the main path (EMA, StepLR, grad clip, scheduled clips) at a tiny size
FUNNEL = ["target=funnel", "solver=dis", "loss.method=lv", "target.n_reference_samples=200",
          *TINY]


@pytest.fixture()
def fake_backend():
    fake_wandb.reset()
    wandb_shim.use_backend(fake_wandb)
    yield fake_wandb
    wandb_shim.use_backend(None)
    fake_wandb.reset()


@pytest.mark.parametrize("path", ["/tmp/some/dir", "relative/dir", "/tmp/other/dir/"])
def test_run_id_for_dir_matches_jax(path):
    from sde_sampler_tpu.utils import wandb as jax_shim

    run_id = wandb_shim.run_id_for_dir(path)
    assert run_id == jax_shim.run_id_for_dir(path) and len(run_id) == 64
    assert run_id != wandb_shim.run_id_for_dir("/tmp/some/dir2")


def test_merge_wandb_cfg_current_overrides_win(fake_backend):
    fake_backend.init(id="x", config={"a": 1, "nest": {"p": 1, "q": 2}, "hydra": {"h": 1}})
    merged = wandb_shim.merge_wandb_cfg({"a": 5, "nest": {"p": 7}, "new": 3})
    assert merged == {"a": 5, "nest": {"p": 7, "q": 2}, "new": 3}


def test_upload_restore_gc(fake_backend, tmp_path):
    fake_backend.init(id="run1", config={})
    for name, payload in (("ckpt000002.pt", b"payload-a"), ("ckpt_final.pt", b"payload-b")):
        (tmp_path / name).write_bytes(payload)
        wandb_shim.upload_ckpt(tmp_path / name, name=name)
    # restore pulls only the latest version, into out_dir/ckpt/, where the
    # solver looks for checkpoints
    out = tmp_path / "restore"
    wandb_shim.restore_ckpt(out)
    assert [p.name for p in out.rglob("*")] == ["ckpt", "ckpt_final.pt"]
    assert latest_checkpoint(out / "ckpt").read_bytes() == b"payload-b"
    # the clean-up deletes the versions without an alias (all but latest)
    wandb_shim.delete_old_wandb_ckpts()
    alive = fake_backend.Api().run(fake_backend.run.path).logged_artifacts()
    assert len(alive) == 1 and "latest" in alive[0].aliases


def test_check_wandb_noop_without_run(fake_backend, tmp_path):
    fake_backend.finish()
    assert wandb_shim.merge_wandb_cfg({"a": 1}) is None
    wandb_shim.upload_ckpt(tmp_path / "missing.pt")  # guarded: no read, no raise
    wandb_shim.use_backend(None)
    assert wandb_shim.init(id="x") is None and wandb_shim.format_fig("fig") == "fig"


def test_main_opens_the_run_and_uploads_the_last_checkpoint(fake_backend, tmp_path):
    """A run with the config's defaults (upload_ckpt_to_wandb: last): the
    run id hashes out_dir, resume is allowed, every metrics line is logged,
    each checkpoint is uploaded and all but the latest deleted at the end."""
    calls = []
    init = fake_backend.init
    fake_backend.init = lambda **kw: calls.append(kw) or init(**kw)
    try:
        out_dir = tmp_path / "job"
        port_main.main(["target=dw_shift", "solver=basic_dis", "train_steps=4", "ckpt_interval=2",
                        *TINY, f"out_dir={out_dir}"])
    finally:
        fake_backend.init = init
    (kw,) = calls
    run_id = wandb_shim.run_id_for_dir(out_dir)
    assert (kw["id"], kw["resume"], kw["mode"], kw["dir"]) == (run_id, "allow", "run", str(out_dir))
    assert kw["tags"] == ["target=dw_shift", "solver=basic_dis", "train_steps=4",
                          "ckpt_interval=2", *TINY]
    assert kw["config"]["out_dir"] == str(out_dir)
    artifacts = fake_backend._server.artifacts[run_id]
    assert [a.files[0].name for a in artifacts] == ["ckpt/ckpt000002.pt", "ckpt/ckpt_final.pt"]
    assert [a.deleted for a in artifacts] == [True, False]
    logged = [m for m in (json.loads(line) for line in
                          (out_dir / "metrics.jsonl").read_text().splitlines())]
    assert len(logged) == 3  # the train line at step 4, the evaluation, the final log
    assert fake_backend.run is None  # finished


def test_disabled_mode_opens_no_run(fake_backend, tmp_path):
    port_main.main(["target=dw_shift", "solver=basic_dis", "train_steps=2", *TINY,
                    "wandb.mode=disabled", f"out_dir={tmp_path}"])
    assert fake_backend._server.runs == {} and fake_backend._server.artifacts == {}


def test_upload_ckpt_to_wandb_is_validated(tmp_path):
    with pytest.raises(ValueError, match="upload_ckpt_to_wandb must be"):
        port_main.make_solver(["target=dw_shift", "solver=basic_dis", *TINY,
                               "upload_ckpt_to_wandb=sometimes", f"out_dir={tmp_path}"])


def _run_job(out_dir, train_steps):
    return port_main.main(["target=dw_shift", "solver=basic_dis", "loss.method=lv",
                           f"train_steps={train_steps}", *TINY, "ckpt_interval=2",
                           "upload_ckpt_to_wandb=True", f"out_dir={out_dir}"])


def test_preemption_resume_via_artifacts(fake_backend, tmp_path):
    """The job trains 4 steps (uploading checkpoints), the node dies (the
    local out_dir is lost), the requeued job re-opens the same run, restores
    the latest checkpoint artifact and trains on to 8 steps."""
    out_dir = tmp_path / "job"
    _run_job(out_dir, train_steps=4)
    run_id = wandb_shim.run_id_for_dir(out_dir)
    assert fake_backend._server.artifacts.get(run_id), "no checkpoint uploaded"
    shutil.rmtree(out_dir)
    solver = _run_job(out_dir, train_steps=8)
    assert fake_backend._server.runs[run_id]["config"]["train_steps"] == 4  # the stored config
    assert solver.cfg["train_steps"] == 8  # merged under the current one
    lines = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [m["train/step"] for m in lines if "train/step" in m]
    assert steps and min(steps) > 4 and max(steps) == 8
    assert "Checkpoint ckpt/ckpt_final.pt restored from wandb." in (out_dir / "main.log").read_text()


class Preempted(Exception):
    pass


def test_resumed_run_ends_with_the_uninterrupted_parameters(fake_backend, tmp_path, monkeypatch):
    """Funnel DIS for 8 steps, checkpoints every 2 uploaded, preempted after
    its step-4 checkpoint (the run fails: error in the summary, exit code
    1), out_dir lost, requeued: it resumes at step 4 and ends with the
    parameters, EMA shadow and optimizer state of an uninterrupted run."""
    overrides = [*FUNNEL, "train_steps=8", "ckpt_interval=2", "upload_ckpt_to_wandb=True"]
    whole = port_main.main([*overrides, f"out_dir={tmp_path / 'whole'}"])

    train_step = Trainable._train_step

    def preempt_after_step_4(self):
        if self.n_steps == 4:
            raise Preempted("node lost")
        train_step(self)

    finished = []
    finish = fake_backend.finish
    monkeypatch.setattr(fake_backend, "finish",
                        lambda exit_code=None: finished.append(exit_code) or finish(exit_code))
    out_dir = tmp_path / "job"
    run_id = wandb_shim.run_id_for_dir(out_dir)
    monkeypatch.setattr(Trainable, "_train_step", preempt_after_step_4)
    with pytest.raises(Preempted):
        port_main.main([*overrides, f"out_dir={out_dir}"])
    monkeypatch.setattr(Trainable, "_train_step", train_step)
    assert finished == [1]
    assert fake_backend._server.artifacts[run_id][-1].files[0].name == "ckpt/ckpt000004.pt"
    shutil.rmtree(out_dir)

    resumed = port_main.main([*overrides, f"out_dir={out_dir}"])
    assert finished == [1, None]
    steps = [json.loads(line).get("train/step")
             for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert steps[0] == 8  # the only train line written after the resume
    assert resumed.n_steps == whole.n_steps == 8
    for name, value in whole.modules.state_dict().items():
        assert torch.equal(resumed.modules.state_dict()[name], value), name
    for got, want in zip(resumed.ema_params, whole.ema_params):
        assert torch.equal(got, want)
    for got, want in zip(resumed.optimizer.state.values(), whole.optimizer.state.values()):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert resumed.scheduled_params == whole.scheduled_params
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
