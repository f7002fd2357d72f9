"""Weights & Biases integration: logging, checkpoint artifacts, preemption resume.

Port of `sde_sampler_tpu/utils/wandb.py`: `format_fig`, the `check_wandb`
guard, the resume-config merge, checkpoint artifact upload, restore and
clean-up, and the run id hashed from the output directory, which
`sde_sampler_torch/main.py` uses so that a requeued job resumes its run.

The backend resolves lazily: the `wandb` package where it is installed, a
stand-in injected with `use_backend()` (the tests use tests/fake_wandb.py),
otherwise every call is a no-op and the run logs to metrics.jsonl only.
"""
from __future__ import annotations

import copy
import hashlib
import logging
from pathlib import Path

from sde_sampler_torch.utils.common import CKPT_DIR
from sde_sampler_torch.utils.config import deep_merge

try:
    import wandb as _backend

    HAS_WANDB = True
except ImportError:  # pragma: no cover - depends on the environment
    _backend = None
    HAS_WANDB = False

run = None


def use_backend(module):
    """Inject a wandb-compatible backend (tests); None restores the no-op."""
    global _backend, HAS_WANDB, run
    _backend = module
    HAS_WANDB = module is not None
    run = getattr(module, "run", None) if module is not None else None
    return module


def _active_run():
    return getattr(_backend, "run", None) if HAS_WANDB else None


def run_id_for_dir(out_dir) -> str:
    """The run id: SHA-256 of the absolute output directory, so a requeued
    (preempted) job resumes the same wandb run."""
    return hashlib.sha256(str(Path(out_dir).absolute()).encode()).hexdigest()


def init(**kwargs):
    global run
    if HAS_WANDB:
        run = _backend.init(**kwargs)
    else:
        logging.debug("wandb unavailable; logging to disk only.")
    return run


def log(metrics: dict, step: int | None = None, commit: bool = True):
    if _active_run() is not None:
        _backend.log(metrics, step=step, commit=commit)


def summary_update(data: dict):
    active = _active_run()
    if active is not None:
        for k, v in data.items():
            active.summary[k] = v


def finish(exit_code: int | None = None):
    global run
    if _active_run() is not None:
        _backend.finish(exit_code=exit_code)
    run = None


def format_fig(fig):
    """PIL images and matplotlib figures are wrapped for wandb.log."""
    if not HAS_WANDB:
        return fig
    kinds = ()
    try:
        from PIL.Image import Image as PILImage

        kinds += (PILImage,)
    except ImportError:  # pragma: no cover
        pass
    try:
        from matplotlib.figure import Figure as MplFigure

        kinds += (MplFigure,)
    except ImportError:  # pragma: no cover
        pass
    return _backend.Image(fig) if isinstance(fig, kinds) else fig


def check_wandb(fun):
    """Run `fun` only inside an active run in mode 'run'."""

    def inner(*args, **kwargs):
        active = _active_run()
        mode = None
        if active is not None:
            mode = getattr(getattr(active, "settings", None), "mode", None)
            if mode == "run":
                return fun(*args, **kwargs)
        # debug, not warning, without the wandb package: every run of a
        # wandb-less environment would warn otherwise
        log_fn = logging.warning if HAS_WANDB else logging.debug
        log_fn("Wandb not available (mode=%s): unable to call %s.", mode or "none", fun.__name__)

    inner.__name__ = getattr(fun, "__name__", "wrapped")
    return inner


@check_wandb
def merge_wandb_cfg(cfg: dict) -> dict:
    """Deep-merge the resumed run's stored config under cfg (cfg wins)."""
    wandb_config = copy.deepcopy(dict(_backend.run.config))
    wandb_config.pop("hydra", None)
    merged = deep_merge(wandb_config, dict(cfg))
    logging.info("Merged config with wandb config.")
    return merged


@check_wandb
def upload_ckpt(path, name: str = "ckpt"):
    """Upload a checkpoint file as a model artifact named after the run id,
    stored as `ckpt/<name>`."""
    name = f"{CKPT_DIR}/{name}"
    artifact = _backend.Artifact(
        _backend.run.id, type="model", metadata={"path": str(path), "name": name}
    )
    artifact.add_file(str(path), name=name)
    _backend.log_artifact(artifact)
    logging.info("Uploaded checkpoint %s to wandb.", name)


@check_wandb
def restore_ckpt(out_dir):
    """Download the run's latest checkpoint artifact into out_dir, that is
    to out_dir/ckpt/, where the solver looks for checkpoints."""
    try:
        artifact = _backend.run.use_artifact(f"{_backend.run.id}:latest")
        ckpt = artifact.download(str(out_dir))
        logging.info("Checkpoint %s restored from wandb.", artifact.metadata.get("name", ckpt))
    except _backend.CommError as exception:
        logging.debug("Wandb raised exception %s", exception)
        logging.info("No previous checkpoints found for wandb id %s.", _backend.run.id)


@check_wandb
def delete_old_wandb_ckpts():
    """Delete the artifact versions without aliases (all but 'latest')."""
    try:
        api_run = _backend.Api().run(_backend.run.path)
        for artifact in api_run.logged_artifacts():
            if len(artifact.aliases) == 0:
                artifact.delete()
                logging.info(
                    "Marked checkpoint %s for deletion on wandb.", artifact.metadata.get("name")
                )
    except _backend.CommError as exception:
        logging.debug("Wandb raised exception %s", exception)
        logging.warning("Unable to delete checkpoints on wandb.")
