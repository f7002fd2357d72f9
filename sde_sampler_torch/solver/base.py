"""Solver and Trainable bases: training loop, EMA, schedulers, checkpoints.

Port of `sde_sampler_tpu/solver/base.py`. The JAX package carries a
TrainState pytree through one jitted step; here the state is the control
`nn.Module`s, a `torch.optim.Adam` and a few counters, updated eagerly:

- optimizer: clip by global norm (optax semantics) -> Adam with L2 weight
  decay (`torch.optim.Adam(weight_decay=)` is optax's
  `add_decayed_weights -> scale_by_adam`) -> lr times the schedule of the
  count of applied updates;
- guards: a step whose loss or gradient is not finite (or above
  max_loss / max_grad) changes neither the parameters nor the optimizer
  state, the `select` of the JAX step;
- EMA with warmup, scheduled clip values (passed to the controls per call),
  checkpoints written with `torch.save`, and `metrics.jsonl`;
- the setup hooks of the config's `setup` list (`utils/debug.py`),
  `params_file` warm starts (`utils/params.py`), the model watcher
  (`utils/watch.py`) and the loss and gradient variances of
  `eval_stddev_steps` at every evaluation;
- the evaluation plots (`eval/plots.py` and the targets' `plots`), saved as
  `{key}.png`, or `{key}_step_{n}.png` during training, under `out_dir`.
  `plot_results=True` (the config's default) needs matplotlib: without it
  the solver raises at set-up and names `plot_results=False`;
- a `torch.profiler` window over the training steps `profile_start` to
  `profile_start + profile_steps` (default 10), its trace written under
  `out_dir/profile`;
- wandb (`utils/wandb.py`, a no-op without an active run): every
  `metrics.jsonl` line is logged there too, each stored checkpoint is
  uploaded as an artifact when `upload_ckpt_to_wandb` is True or "last"
  (then older versions are deleted after the final log), and without a
  `ckpt_file` the run's latest artifact is restored into `out_dir` before
  the local checkpoints are searched when `restore_ckpt_from_wandb`;
- at the end of a run, one log line with the kernel launches and scan-route
  phase 1s of the run (`ops/build.py`'s counts since the solver was built);
- data parallelism, `n_devices` > 1 (`parallel/mesh.py`): the solver runs
  in each rank of a process group that the entry point started. Rank 0's
  parameters are broadcast at set-up; after each backward pass the ranks'
  gradients are summed in one all-reduce of one flat buffer, so the
  guards, the clip, Adam, the EMA and the schedules read global values and
  take the same steps on every rank (the parameters stay equal bit for
  bit). The losses take the whole batch and keep their rows
  (`losses/oc.py`); the evaluation's Sinkhorn shards its rows over the
  group. Rank 0 alone writes metrics.jsonl, the plots and the checkpoints,
  which every rank loads; after code that runs on rank 0 alone and may
  draw (the plots), every rank takes rank 0's generator state.

Randomness comes from explicit generators: `self.generator` on the device
(prior samples, noise, reference samples) and a CPU generator for the
parameter init, both seeded from `seed`.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from bisect import bisect_right
from collections import Counter
from pathlib import Path

import torch
import yaml

from sde_sampler_torch.distr.base import Distribution
from sde_sampler_torch.eval import plots as plots_lib
from sde_sampler_torch.eval.metrics import get_metrics
from sde_sampler_torch.ops import build
from sde_sampler_torch.parallel import mesh
from sde_sampler_torch.utils import wandb as wandb_shim
from sde_sampler_torch.utils.common import CKPT_DIR, Results
from sde_sampler_torch.utils.config import instantiate
from sde_sampler_torch.utils.device import resolve_device, sync
from sde_sampler_torch.utils.params import load_params_file, load_solver_params

# ---------------------------------------------------------------------------
# Optimizer / scheduler / EMA config objects
# ---------------------------------------------------------------------------


class Adam:
    """torch.optim.Adam config (weight_decay = L2 on the gradients)."""

    def __init__(
        self,
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        betas: tuple = (0.9, 0.999),
        eps: float = 1e-8,
    ):
        self.lr = lr
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.eps = eps

    def build(self, param_groups: list[dict]) -> torch.optim.Adam:
        return torch.optim.Adam(
            param_groups,
            lr=self.lr,
            betas=self.betas,
            eps=self.eps,
            weight_decay=self.weight_decay,
        )


class StepLR:
    """Multiplier gamma**(step // step_size) (torch StepLR semantics)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        return self.gamma ** (step // self.step_size)


class MultiStepLR:
    def __init__(self, milestones: list[int], gamma: float):
        self.milestones = [int(m) for m in milestones]
        self.gamma = gamma

    def __call__(self, step: int) -> float:
        return self.gamma ** sum(step >= m for m in self.milestones)


class ConstantLR:
    def __call__(self, step: int) -> float:
        return 1.0


class GradClip:
    """Global-norm gradient clipping config."""

    def __init__(self, max_norm: float = 1.0, norm_type: float = 2.0, **kwargs):
        if norm_type != 2.0:
            raise NotImplementedError("only the 2-norm is supported")
        self.max_norm = max_norm
        self.norm_type = norm_type

    @torch.no_grad()
    def __call__(self, grads: list[torch.Tensor]) -> None:
        """Scale grads in place by max_norm / norm when norm >= max_norm."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        for g in grads:
            g.mul_(scale)


class EMAConfig:
    """EMA with warmup: decay 1-(1+n/inv_gamma)^-power capped at `decay`.

    num_updates counts applied optimizer steps; the shadow copies the
    parameters until update_after_step and updates every `update_every`
    steps thereafter.
    """

    def __init__(
        self,
        decay: float = 0.9999,
        update_after_step: int = 100,
        update_every: int = 10,
        inv_gamma: float = 1.0,
        power: float = 2 / 3,
        min_value: float = 0.0,
        **kwargs,
    ):
        self.decay = decay
        self.update_after_step = int(update_after_step)
        self.update_every = int(update_every)
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value

    def current_decay(self, num_updates: int) -> float:
        epoch = max(num_updates - self.update_after_step - 1, 0)
        if epoch <= 0:
            return 0.0
        value = 1.0 - (1.0 + epoch / self.inv_gamma) ** (-self.power)
        return min(max(value, self.min_value), self.decay)

    @torch.no_grad()
    def update(self, shadow, num_updates: int, params, apply: bool) -> int:
        """One (conditional) update of `shadow` in place; returns the count."""
        if not apply:
            return num_updates
        num_updates += 1
        if num_updates % self.update_every == 0:
            if num_updates <= self.update_after_step:
                for s, p in zip(shadow, params):
                    s.copy_(p)
            else:
                decay = self.current_decay(num_updates)
                for s, p in zip(shadow, params):
                    s.sub_((1.0 - decay) * (s - p))
        return num_updates


class CombinedScheduler:
    """Bundles the lr schedule and the MultiStepParams schedulers."""

    def __init__(self, solver, lr_schedule, base_lrs: dict[str, float]):
        self.solver = solver
        self.lr_schedule = lr_schedule
        self.base_lrs = base_lrs
        self.param_schedulers: list[MultiStepParams] = []

    def add(self, scheduler: "MultiStepParams"):
        self.param_schedulers.append(scheduler)

    def get(self, step: int) -> dict[str, float]:
        factor = float(self.lr_schedule(step))
        output = {
            f"lr_{i}": lr * factor for i, lr in enumerate(self.base_lrs.values())
        }
        for sched in self.param_schedulers:
            output.update(sched.get())
        return output

    def step(self):
        for sched in self.param_schedulers:
            sched.step()

    def state_dict(self):
        return {i: s.state_dict() for i, s in enumerate(self.param_schedulers)}

    def load_state_dict(self, state_dict):
        for i, s in enumerate(self.param_schedulers):
            if i in state_dict or str(i) in state_dict:
                s.load_state_dict(state_dict.get(i, state_dict.get(str(i))))


class MultiStepParams:
    """Schedules dotted keys of the solver's `scheduled_params` (e.g.
    'generative_ctrl.clip_model'); the controls read them per call."""

    def __init__(
        self,
        obj,
        milestones: list[int],
        gammas: dict[str, float],
        last_step: int = 0,
    ):
        self.obj = obj
        self.milestones = Counter(int(m) for m in milestones)
        self.gammas = dict(gammas)
        store = getattr(obj, "scheduled_params", {})
        self.base_values = {
            k: store[k] for k in self.gammas if store.get(k) is not None
        }
        missing = set(self.gammas) - set(self.base_values)
        if missing:
            logging.warning(
                "The keys %s are missing and cannot be scheduled.", missing
            )
            self.gammas = {k: self.gammas[k] for k in self.base_values}
        self.last_step = last_step
        self.update()

    def get(self) -> dict[str, float]:
        store = self.obj.scheduled_params
        return {k: store.get(k) for k in self.gammas}

    def set(self, values: dict[str, float]):
        self.obj.scheduled_params.update(values)

    def step(self):
        self.last_step += 1
        if self.last_step in self.milestones:
            mult = self.milestones[self.last_step]
            self.set({k: v * self.gammas[k] ** mult for k, v in self.get().items()})

    def update(self):
        milestones = sorted(self.milestones.elements())
        n = bisect_right(milestones, self.last_step)
        self.set({k: v * self.gammas[k] ** n for k, v in self.base_values.items()})

    def state_dict(self):
        return {
            "last_step": self.last_step,
            "base_values": self.base_values,
            "gammas": self.gammas,
        }

    def load_state_dict(self, state_dict):
        self.last_step = state_dict["last_step"]
        self.base_values = state_dict.get("base_values", self.base_values)
        self.update()


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


def latest_checkpoint(ckpt_dir: Path) -> Path | None:
    ckpts = list(Path(ckpt_dir).glob("ckpt*.pt")) if Path(ckpt_dir).is_dir() else []
    return max(ckpts, key=os.path.getmtime) if ckpts else None


class Solver:
    save_attrs: list[str] = []

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.out_dir = Path(cfg.get("out_dir") or Path.cwd())
        # setup hooks (conf/utils/debug.yaml: autograd anomaly detection)
        for fn_cfg in cfg.get("setup") or []:
            instantiate(fn_cfg)
        if cfg.get("matmul_precision"):
            raise NotImplementedError(
                "the port runs float32 matmuls in full precision only"
            )
        # the data-parallel group: None on one device; raises unless the
        # entry point started a group of n_devices ranks
        self.group = mesh.get_group(cfg.get("n_devices"))
        self.rank = mesh.rank(self.group)
        self.device = resolve_device(cfg.get("device"))
        if self.group is not None:
            described = mesh.describe(self.group)
            if self.rank == 0:
                logging.info("Data parallelism: %s", described)
        seed = int(cfg.get("seed", 0))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.init_generator = torch.Generator().manual_seed(seed)

        self.target: Distribution = instantiate(cfg["target"]).to(self.device)
        self.eval_sample_losses = None
        if cfg.get("eval_sample_losses") is not None:
            self.eval_sample_losses = {
                name: instantiate(loss_cfg)
                for name, loss_cfg in cfg["eval_sample_losses"].items()
            }
            for loss in self.eval_sample_losses.values():
                if hasattr(loss, "group"):  # the Sinkhorn shards its rows
                    loss.group = self.group

        self.plot_results: bool = cfg.get("plot_results", True)
        if self.plot_results:
            plots_lib.require_backend()  # raises without matplotlib
        self.store_last_ckpt: bool = cfg.get("store_last_ckpt", False)
        self.restore_ckpt_from_wandb = cfg.get("restore_ckpt_from_wandb")
        self.upload_ckpt_to_wandb = cfg.get("upload_ckpt_to_wandb")
        if isinstance(self.upload_ckpt_to_wandb, str) and self.upload_ckpt_to_wandb != "last":
            raise ValueError(
                "upload_ckpt_to_wandb must be True/False/'last', got "
                f"{self.upload_ckpt_to_wandb!r}"
            )
        self.eval_marginal_dims: list = cfg.get("eval_marginal_dims") or []
        self.ckpt_file = cfg.get("ckpt_file")
        self.ckpt_dir = self.out_dir / CKPT_DIR
        self.metrics_file = self.out_dir / "metrics.jsonl"
        logging.info("Device: %s; checkpoint directory: %s", self.device, self.ckpt_dir)
        self.initialized = False
        self.initial_time = time.time()
        self._launches_at_start = self._launch_counts()

    @staticmethod
    def _launch_counts() -> dict[str, int]:
        return {**build.LAUNCHES, **build.FORM_LAUNCHES, **build.ROUTES}

    def setup(self):
        logging.info("Setting up solver.")
        self.target.compute_stats(self.generator)
        self.load_checkpoint(self.ckpt_file)
        self.initialized = True

    def get_metrics(self, results: Results) -> dict:
        metrics = dict(results.metrics)
        metrics["eval/overall_time"] = time.time() - self.initial_time
        if results.samples is not None:
            samples = results.samples
            nonfinite = int((~torch.isfinite(samples).all(dim=-1)).sum())
            if nonfinite > 0:
                logging.warning("Found %d non-finite samples.", nonfinite)
            start = time.perf_counter()
            metrics.update(
                get_metrics(
                    distr=self.target,
                    samples=samples,
                    weights=results.weights,
                    log_norm_const_preds=results.log_norm_const_preds,
                    expectation_preds=results.expectation_preds,
                    marginal_dims=self.eval_marginal_dims,
                    sample_losses=self.eval_sample_losses,
                    generator=self.generator,
                )
            )
            metrics["eval/metrics_time"] = time.perf_counter() - start
        return metrics

    def on_rank0(self, fn, default=None):
        """fn() on rank 0 alone (default elsewhere); every rank then takes
        rank 0's generator state, which fn may have drawn from."""
        out = fn() if self.rank == 0 else default
        mesh.sync_generator(self.generator, self.group)
        return out

    def get_plots(self, results: Results) -> dict:
        """The evaluation's plots: the results' own, and with samples the
        marginals, densities and trajectories (`eval/plots.py`) and the
        target's (`target.plots`). Rank 0 alone plots."""
        if self.group is not None:
            return self.on_rank0(lambda: self._get_plots(results), {})
        return self._get_plots(results)

    def _get_plots(self, results: Results) -> dict:
        plots = dict(results.plots)
        if results.samples is not None and self.plot_results:
            plots.update(
                plots_lib.get_plots(
                    distr=self.target,
                    samples=results.samples,
                    weights=results.weights,
                    ts=results.ts,
                    xs=results.xs,
                    marginal_dims=self.eval_marginal_dims,
                    generator=self.generator,
                )
            )
            if hasattr(self.target, "plots"):
                plots.update(self.target.plots(results.samples))
        return plots

    def log(self, results: Results, step=None) -> dict:
        plots = self.get_plots(results)  # before the metrics, as the JAX package
        metrics = self.get_metrics(results)
        for key, fig in plots.items():
            name = f"{key}.png" if step is None else f"{key}_step_{step}.png"
            plots_lib.save_fig(fig, self.out_dir / name)
        if step is not None:
            metrics["train/step"] = step
        self.write_metrics(metrics)
        wandb_plots = {k: wandb_shim.format_fig(fig) for k, fig in plots.items()}
        wandb_shim.log({**metrics, **wandb_plots}, step=step)
        logging.info("Metrics:\n%s", yaml.dump(metrics))
        return metrics

    def write_metrics(self, metrics: dict) -> None:
        """Append a metrics.jsonl line (rank 0 alone)."""
        if self.rank != 0:
            return
        self.metrics_file.parent.mkdir(parents=True, exist_ok=True)
        with self.metrics_file.open(mode="a") as f:
            f.write(json.dumps(metrics) + "\n")

    def run(self) -> Results:
        raise NotImplementedError

    def __call__(self) -> Results:
        if not self.initialized:
            self.setup()
        logging.info("Running solver.")
        results = self.run()
        if self.store_last_ckpt:
            self.store_checkpoint(suffix="_final")
        logging.info("Logging final results.")
        self.last_metrics = self.log(results)
        if self.upload_ckpt_to_wandb == "last":
            wandb_shim.delete_old_wandb_ckpts()
        launches = {k: v - self._launches_at_start[k]
                    for k, v in self._launch_counts().items() if v != self._launches_at_start[k]}
        logging.info("Kernel launches of this run: %s", json.dumps(launches))
        digest = self.param_digest()
        if self.group is not None and digest:
            logging.info("Parameter digest of rank %d: %s", self.rank, digest)
        return results

    def param_digest(self) -> str:
        """sha256 of the trained parameters' bytes ("" for a solver without
        any), which the ranks of a group hold equal."""
        return ""

    # -- checkpoint protocol ------------------------------------------------
    def state_dict(self) -> dict:
        state = {}
        for key in self.save_attrs:
            attr = getattr(self, key)
            state[key] = attr.state_dict() if hasattr(attr, "state_dict") else attr
        return state

    def load_state_dict(self, state: dict):
        for key in self.save_attrs:
            if key in state:
                attr = getattr(self, key)
                if hasattr(attr, "load_state_dict"):
                    attr.load_state_dict(state[key])
                else:
                    setattr(self, key, state[key])

    def store_checkpoint(self, suffix="") -> Path:
        """Write the checkpoint (rank 0 alone: the ranks' states are equal)."""
        path = self.ckpt_dir / f"ckpt{suffix}.pt"
        if self.rank != 0:
            return path
        logging.info("Save checkpoint at %s", path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".pt.tmp")
        torch.save(self.state_dict(), tmp)
        os.replace(tmp, path)  # a cut-off write never becomes the latest
        if self.upload_ckpt_to_wandb:
            wandb_shim.upload_ckpt(path, name=path.name)
        return path

    def load_checkpoint(self, ckpt_file=None):
        if ckpt_file is None:
            if self.restore_ckpt_from_wandb and self.rank == 0:
                # preemption resume: this run's latest checkpoint artifact
                # (run id = hash of out_dir) before the local files
                wandb_shim.restore_ckpt(self.out_dir)
            mesh.barrier(self.group)  # the other ranks read what rank 0 wrote
            ckpt_file = latest_checkpoint(self.ckpt_dir)
        if ckpt_file is not None:
            logging.info("Loading checkpoint %s", ckpt_file)
            self.load_state_dict(torch.load(ckpt_file, map_location="cpu"))


class Trainable(Solver):
    save_attrs = ["time", "scheduler"]

    def __init__(self, cfg: dict):
        super().__init__(cfg=cfg)
        # Scheduled values (clip thresholds), read by the controls per call
        self.scheduled_params: dict[str, float] = {}
        self.modules = torch.nn.ModuleDict()
        self.setup_models()  # fills self.modules

        self.train_steps = int(cfg["train_steps"])
        self.grad_clip: GradClip | None = instantiate(cfg.get("grad_clip"))
        self.max_grad = cfg.get("max_grad")
        self.max_loss = cfg.get("max_loss")
        self.scale_loss = cfg.get("scale_loss")

        self.optim_cfg: Adam = instantiate(cfg["optim"])
        self.lr_schedule = instantiate(cfg.get("lr_scheduler")) or ConstantLR()
        group_lrs = {
            name: float(options.get("lr", self.optim_cfg.lr))
            for name, options in (cfg.get("param_groups") or {}).items()
        }
        self.init_params()
        if cfg.get("params_file"):
            # warm start from imported parameters (a reference torch
            # checkpoint converted by scripts/import_torch_ckpt.py)
            load_solver_params(self.modules, load_params_file(cfg["params_file"]))
        self.params = [p for p in self.modules.parameters()]
        mesh.replicate(self.params, self.group)  # rank 0's parameters on every rank
        self.optimizer = self.optim_cfg.build(
            [
                {
                    "params": list(module.parameters()),
                    "base_lr": group_lrs.get(name, self.optim_cfg.lr),
                }
                for name, module in self.modules.items()
            ]
        )

        self.ema: EMAConfig | None = instantiate(cfg.get("ema"))
        self.ema_params = (
            [p.detach().clone() for p in self.params] if self.ema else None
        )
        self.ema_num_updates = 0
        self.n_updates = 0  # applied optimizer steps: the lr schedule's count
        self.n_steps_skip = 0
        self.n_filtered = torch.zeros((), dtype=torch.long, device=self.device)

        base_lrs = group_lrs or {"all": self.optim_cfg.lr}
        self.scheduler = CombinedScheduler(self, self.lr_schedule, base_lrs)
        for sched_cfg in cfg.get("scheduler") or []:
            self.scheduler.add(instantiate(sched_cfg, obj=self))

        self._host_step = 0
        self.time = 0.0
        self.eval_stddev_steps = cfg.get("eval_stddev_steps")
        # gradient and parameter norms per module (reference: wandb.watch)
        self.model_watcher = instantiate(cfg.get("model_watcher"))
        self.eval_init = cfg.get("eval_init", True)
        self.eval_interval = cfg.get("eval_interval") or self.train_steps
        self.log_interval = cfg.get("log_interval") or self.train_steps
        self.ckpt_interval = cfg.get("ckpt_interval") or self.train_steps
        # cfg["steps_per_call"] chunks jitted steps in JAX; eager torch
        # dispatches every step, so the key is accepted and has no effect.

        n_params = sum(p.numel() for p in self.params)
        logging.info("Trainable parameters: %d", n_params)
        wandb_shim.summary_update({"params/trainable": n_params})

    # -- subclass interface --------------------------------------------------
    def setup_models(self):
        raise NotImplementedError

    def init_params(self):
        """Draw every parameter from the CPU init generator."""
        for module in self.modules.values():
            module.reset_parameters(self.init_generator)

    def compute_loss(self, clips, x0=None, dbs=None):
        """Return (loss, metrics); x0 and dbs override the drawn inputs."""
        raise NotImplementedError

    def compute_results(self) -> Results:
        raise NotImplementedError

    # -- dynamic clip params --------------------------------------------------
    def register_scheduled_clips(self, name: str, module):
        for attr in ("clip_model", "clip_score"):
            value = getattr(module, attr, None)
            if value is not None:
                self.scheduled_params[f"{name}.{attr}"] = float(value)

    def current_clips(self) -> dict:
        """Nested {module_name: {clip_attr: float}} for the control calls."""
        clips: dict[str, dict] = {}
        for dotted, value in self.scheduled_params.items():
            mod, attr = dotted.split(".", 1)
            clips.setdefault(mod, {})[attr] = float(value)
        return clips

    # -- training ------------------------------------------------------------
    def step(self, x0=None, dbs=None) -> dict:
        """One optimizer step; x0 and dbs override the drawn prior samples
        and noise (the parity tests feed the JAX package's)."""
        start = time.perf_counter()
        clips = self.current_clips()
        for p in self.params:
            p.grad = None
        loss, metrics = self.compute_loss(clips, x0=x0, dbs=dbs)
        if self.scale_loss is not None:
            loss = self.scale_loss * loss
        loss.backward()
        grads = self.reduce_grads()
        # the norms of this step's gradients and of the parameters before its
        # update (device tensors: no host sync)
        watched = {} if self.model_watcher is None else self.model_watcher.metrics(self.modules)

        # Guards: skip non-finite (or too large) losses and gradients
        loss = loss.detach()
        grad_inf_norm = torch.stack([g.abs().max() for g in grads]).max()
        loss_ok = (
            torch.isfinite(loss) if self.max_loss is None
            else loss.abs() <= self.max_loss
        )
        grad_ok = (
            torch.isfinite(grad_inf_norm) if self.max_grad is None
            else grad_inf_norm <= self.max_grad
        )
        ok = bool(loss_ok & grad_ok)
        if ok:
            if self.grad_clip is not None:
                self.grad_clip(grads)
            factor = float(self.lr_schedule(self.n_updates))
            for group in self.optimizer.param_groups:
                group["lr"] = group["base_lr"] * factor
            self.optimizer.step()
            self.n_updates += 1
        else:
            self.n_steps_skip += 1

        ema_decay = 0.0
        if self.ema is not None:
            self.ema_num_updates = self.ema.update(
                self.ema_params, self.ema_num_updates, self.params, apply=ok
            )
            ema_decay = self.ema.current_decay(self.ema_num_updates)
        self.n_filtered += metrics["train/n_filtered"]
        self._host_step += 1
        self.scheduler.step()
        metrics.update(
            {
                "train/loss": loss,
                "train/max_grad": grad_inf_norm,
                "train/skipped_steps": self.n_steps_skip,
                "train/ema_decay": ema_decay,
                "train/time_per_step": time.perf_counter() - start,
                **watched,
            }
        )
        return metrics

    def reduce_grads(self) -> list[torch.Tensor]:
        """The parameters' gradients (zeros where none), summed over the
        ranks with a group: one all-reduce of one flat buffer."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.group is not None:
            flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.group)
            grads = [part.view_as(p) for part, p in
                     zip(flat.split([p.numel() for p in self.params]), self.params)]
        for p, g in zip(self.params, grads):
            p.grad = g
        return grads

    def param_digest(self) -> str:
        h = hashlib.sha256()
        for p in self.params:
            h.update(p.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    @property
    def n_steps(self) -> int:
        return self._host_step

    def swap_ema(self):
        """Exchange the parameters with their EMA shadow (call twice to undo)."""
        if self.ema is None:
            return
        with torch.no_grad():
            for p, s in zip(self.params, self.ema_params):
                tmp = p.detach().clone()
                p.copy_(s)
                s.copy_(tmp)

    def loss_and_grad_var(self) -> dict[str, float]:
        """Variances of the loss and of each gradient element over
        `eval_stddev_steps` draws (the training parameters, fresh prior
        samples and noise each), unbiased (ddof = 1). Logged under
        `*_stddev_*` keys, as the JAX package and the reference log them."""
        losses, grads = [], []
        clips = self.current_clips()
        for _ in range(self.eval_stddev_steps):
            for p in self.params:
                p.grad = None
            loss, _ = self.compute_loss(clips)
            if self.scale_loss is not None:
                loss = self.scale_loss * loss
            loss.backward()
            losses.append(loss.detach())
            grads.append(torch.cat([g.reshape(-1) for g in self.reduce_grads()]))
        for p in self.params:
            p.grad = None
        loss_var = torch.stack(losses).var(correction=1)
        grads_var = torch.stack(grads).var(dim=0, correction=1)
        return {
            "eval/grad_stddev_mean": float(grads_var.mean()),
            "eval/grad_stddev_max": float(grads_var.max()),
            "eval/loss_stddev": float(loss_var),
        }

    def evaluate(self, log=True) -> Results:
        logging.info("Evaluate at step %d (%.0f min).", self.n_steps, self.time // 60)
        self.swap_ema()  # evaluate the EMA parameters, as the JAX package
        try:
            results = self.compute_results()
        finally:
            self.swap_ema()
        if self.eval_stddev_steps is not None:
            results.metrics.update(self.loss_and_grad_var())
        if log:
            self.last_metrics = self.log(results, step=self.n_steps)
        return results

    def run(self) -> Results:
        if self.n_steps == 0 and self.eval_init:
            self.evaluate()
        logging.info("Start training at step %d.", self.n_steps)
        # an optional torch.profiler window (cfg: profile_start, profile_steps)
        profile_start = self.cfg.get("profile_start")
        profile_steps = self.cfg.get("profile_steps", 10)
        profiler = None
        try:
            while self.n_steps < self.train_steps:
                if profile_start is not None:
                    if self.n_steps == profile_start:
                        profiler = self._start_profiler()
                    elif profiler is not None and self.n_steps >= profile_start + profile_steps:
                        self._stop_profiler(profiler, profile_start)
                        profiler = profile_start = None
                self._train_step()
        finally:
            if profiler is not None:  # training ended inside the window
                self._stop_profiler(profiler, profile_start)
        logging.info("Finished training at step %d.", self.n_steps)
        return self.evaluate()

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        logging.info("Profiling from step %d.", self.n_steps)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, start: int) -> None:
        """Close the window after the device has finished its work, and
        write its Chrome trace under out_dir/profile."""
        sync(self.device)
        profiler.stop()
        path = self.out_dir / "profile" / f"trace_steps_{start}_{self.n_steps}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        logging.info("Profiler trace of steps %d-%d: %s", start, self.n_steps, path)

    def _train_step(self):
        """One optimizer step of the run loop: its timing, metrics, and the
        evaluations and checkpoints that fall on it."""
        t_start = time.perf_counter()
        metrics = self.step()
        sync(self.device)
        elapsed = time.perf_counter() - t_start
        metrics["train/time_per_step"] = elapsed
        self.time += elapsed
        metrics.update({"train/time": self.time, "train/step": self.n_steps})
        metrics.update(
            {f"params/{k}": v for k, v in self.scheduler.get(self.n_steps).items()}
        )
        last_step = self.n_steps == self.train_steps
        if self.model_watcher is not None and not self.model_watcher.should_log(self.n_steps):
            metrics = {k: v for k, v in metrics.items() if not k.startswith("watch/")}
        if self.n_steps % self.log_interval == 0 or last_step:
            metrics = {
                k: float(v) if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()
            }
            metrics["train/n_filtered_cumulative"] = int(self.n_filtered)
            wandb_shim.log(metrics, step=self.n_steps)
            logging.info("Train metrics:\n%s", yaml.dump(metrics))
            self.write_metrics(metrics)
        if not last_step:
            if self.n_steps % self.eval_interval == 0:
                self.evaluate()
            if self.n_steps % self.ckpt_interval == 0:
                self.store_checkpoint(suffix=f"{self.n_steps:06}")

    # -- checkpoint protocol --------------------------------------------------
    def state_dict(self) -> dict:
        state = super().state_dict()
        state["train_state"] = {
            "modules": self.modules.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema_params": None if self.ema_params is None
            else [s.cpu() for s in self.ema_params],
            "ema_num_updates": self.ema_num_updates,
            "n_updates": self.n_updates,
            "step": self._host_step,
            "n_steps_skip": self.n_steps_skip,
            "n_filtered": int(self.n_filtered),
            "generator": self.generator.get_state(),
        }
        state["scheduled_params"] = dict(self.scheduled_params)
        return state

    def load_state_dict(self, state: dict):
        state = dict(state)
        ts = state.pop("train_state", None)
        scheduled = state.pop("scheduled_params", None)
        super().load_state_dict(state)
        if ts is not None:
            self.modules.load_state_dict(ts["modules"])
            self.optimizer.load_state_dict(ts["optimizer"])
            if ts["ema_params"] is not None and self.ema_params is not None:
                with torch.no_grad():
                    for s, saved in zip(self.ema_params, ts["ema_params"]):
                        s.copy_(saved)
            self.ema_num_updates = ts["ema_num_updates"]
            self.n_updates = ts["n_updates"]
            self._host_step = ts["step"]
            self.n_steps_skip = ts["n_steps_skip"]
            self.n_filtered.fill_(ts["n_filtered"])
            self.generator.set_state(ts["generator"])
        if scheduled is not None:
            self.scheduled_params.update(scheduled)
