"""196-d target: the log-density of a NICE normalizing flow on 14 x 14 MNIST.

Port of `sde_sampler_tpu/distr/nice.py` with its image-grid plot: additive
coupling layers (a shift MLP of the one half of the coordinates added to
the other, alternating halves) and a diagonal log-scaling, a standard
logistic latent prior, and chunked sampling. The flow is a plain dict of
tensors, `{"couplings": [[{"w", "b"}, ...], ...], "scale"}`, with each
layer's weight in (in, out) layout as the JAX package keeps it.

The weights come from the committed checkpoints (`nice.npz`, whose MLPs
are 128 wide, and `nice_smooth.npz`, 500 wide; the width is read from each
file's meta; the port reads its copies in `sde_sampler_torch/data/`), or from a JAX parameter tree carried across
(`utils/params.py::nice_params_from_tree`). Without either the JAX package
falls back to a seeded random flow drawn from its own PRNG, which the port
cannot draw: the port raises there instead. `init_nice_params`,
`nice_sample` and `save_nice_checkpoint` serve the flow's training
(`sde_sampler_torch/train_nice.py`), whose checkpoints both packages read.

The score is the base class's autograd through the flow, over any leading
batch shape, in chunks of rows so that the saved activations of a whole
trajectory's states (the loss's second phase) stay bounded.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch

from sde_sampler_torch.utils.params import nice_params_from_tree

from .base import DATA_DIR, Distribution

# rows per autograd pass of the score
SCORE_CHUNK_ROWS = 65536


class StandardLogistic:
    @staticmethod
    def log_prob(x: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros_like(x)
        return -(torch.logaddexp(x, zero) + torch.logaddexp(-x, zero))

    @staticmethod
    def sample(shape, generator: torch.Generator | None = None, device=None,
               eps: float = 1e-20) -> torch.Tensor:
        # uniform on [eps, 1 - eps): in float32 1 - eps is 1 and u + eps is u
        # for u > 0, as the JAX package's minval and maxval round
        z = torch.rand(shape, generator=generator, device=device).clamp(min=eps)
        return torch.log(z) - torch.log(1.0 - z)


# ---------------------------------------------------------------------------
# Functional NICE flow
# ---------------------------------------------------------------------------


def _linear_init(fan_in: int, fan_out: int, generator: torch.Generator) -> dict:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return {"w": w, "b": b}


def init_nice_params(
    generator: torch.Generator,
    in_out_dim: int = 196,
    mid_dim: int = 500,
    hidden: int = 5,
    coupling: int = 4,
) -> dict:
    """A flow's parameters as the JAX package's `init_nice_params` draws
    them (from torch's generator, on the CPU): each coupling's MLP has
    `hidden` layers of `mid_dim` and an output layer, every weight and bias
    uniform in ±1/sqrt(fan_in); the log-scaling starts at 0."""
    half = in_out_dim // 2
    dims = [(half, mid_dim)] + [(mid_dim, mid_dim)] * (hidden - 1) + [(mid_dim, half)]
    return {
        "couplings": [[_linear_init(i, o, generator) for i, o in dims] for _ in range(coupling)],
        "scale": torch.zeros(1, in_out_dim),
    }


def _coupling_shift(mlp, off: torch.Tensor) -> torch.Tensor:
    h = off
    for layer in mlp[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ mlp[-1]["w"] + mlp[-1]["b"]


def _coupling_apply(mlp, x: torch.Tensor, mask_config: int, reverse: bool) -> torch.Tensor:
    b, w = x.shape
    x = x.reshape(b, w // 2, 2)
    if mask_config:
        on, off = x[:, :, 0], x[:, :, 1]
    else:
        off, on = x[:, :, 0], x[:, :, 1]
    shift = _coupling_shift(mlp, off)
    on = on - shift if reverse else on + shift
    x = torch.stack((on, off), dim=2) if mask_config else torch.stack((off, on), dim=2)
    return x.reshape(b, w)


def nice_f(params: dict, x: torch.Tensor, mask_config: int = 1):
    """x -> (z, log_det_jacobian)."""
    for i, mlp in enumerate(params["couplings"]):
        x = _coupling_apply(mlp, x, (mask_config + i) % 2, reverse=False)
    return x * torch.exp(params["scale"]), params["scale"].sum()


def nice_g(params: dict, z: torch.Tensor, mask_config: int = 1) -> torch.Tensor:
    """z -> x (the inverse of f)."""
    x = z * torch.exp(-params["scale"])
    for i, mlp in reversed(list(enumerate(params["couplings"]))):
        x = _coupling_apply(mlp, x, (mask_config + i) % 2, reverse=True)
    return x


def nice_log_prob(params: dict, x: torch.Tensor, mask_config: int = 1) -> torch.Tensor:
    z, log_det = nice_f(params, x, mask_config)
    return StandardLogistic.log_prob(z).sum(dim=1) + log_det


def nice_sample(params: dict, size: int, in_out_dim: int, mask_config: int = 1,
                generator: torch.Generator | None = None) -> torch.Tensor:
    z = StandardLogistic.sample((size, in_out_dim), generator, params["scale"].device)
    return nice_g(params, z, mask_config)


def tree_leaves(params: dict) -> list[torch.Tensor]:
    """A flow's tensors in jax.tree_util's flatten order (dict keys sorted:
    each layer's `b` before its `w`, the couplings before the scale);
    `tree_from_leaves` inverts it."""
    return [t for mlp in params["couplings"] for layer in mlp
            for t in (layer["b"], layer["w"])] + [params["scale"]]


def save_nice_checkpoint(path, params: dict, meta: dict) -> None:
    """Write a flow as the JAX package's `save_nice_checkpoint` does: its
    leaves as `arr_<i>` and each meta entry as `meta_<key>` of one .npz,
    which both packages' `load_nice_checkpoint` read."""
    leaves = [t.detach().cpu().numpy() for t in tree_leaves(params)]
    np.savez_compressed(path, *leaves, **{f"meta_{k}": v for k, v in meta.items()})


def checkpoint_leaves(data) -> list[np.ndarray]:
    """The leaves `arr_<i>` of a checkpoint (an open .npz) in the order of
    their index i, which is jax.tree_util's flatten order of the parameter
    tree: never their names' lexicographic order (arr_10 < arr_2)."""
    names = [k for k in data.files if not k.startswith("meta_")]
    index = {}
    for name in names:
        match = re.fullmatch(r"arr_(\d+)", name)
        if match is None:
            raise ValueError(f"unexpected checkpoint entry {name!r}")
        index[int(match.group(1))] = name
    if sorted(index) != list(range(len(index))):
        raise ValueError(f"the checkpoint's leaves are not arr_0..arr_{len(index) - 1}")
    return [data[index[i]] for i in range(len(index))]


def tree_from_leaves(leaves: list[np.ndarray], coupling: int, hidden: int) -> dict:
    """The parameter tree of a flow from its leaves in flatten order: dict
    keys sorted, so every layer's `b` before its `w`, and the couplings
    before the scale."""
    n_layers = hidden + 1
    if len(leaves) != 2 * coupling * n_layers + 1:
        raise ValueError(
            f"{len(leaves)} leaves for {coupling} couplings of {n_layers} layers")
    it = iter(leaves)
    couplings = [[{"b": next(it), "w": next(it)} for _ in range(n_layers)]
                 for _ in range(coupling)]
    return {"couplings": couplings, "scale": next(it)}


def load_nice_checkpoint(path) -> tuple[dict, dict]:
    """(params as torch tensors, meta) of a checkpoint written by the JAX
    package's `save_nice_checkpoint`."""
    data = np.load(path)
    meta = {k[len("meta_"):]: data[k].item() for k in data.files if k.startswith("meta_")}
    tree = tree_from_leaves(checkpoint_leaves(data), int(meta["coupling"]), int(meta["hidden"]))
    params = nice_params_from_tree(tree)
    in_out, mid = int(meta["in_out_dim"]), int(meta["mid_dim"])
    first = params["couplings"][0][0]["w"]
    if first.shape != (in_out // 2, mid) or params["scale"].shape != (1, in_out):
        raise ValueError(
            f"{path}: layer shapes {tuple(first.shape)}, {tuple(params['scale'].shape)} "
            f"disagree with the meta (in_out_dim {in_out}, mid_dim {mid})")
    return params, meta


def _map_params(params: dict, fn) -> dict:
    return {
        "couplings": [[{k: fn(v) for k, v in layer.items()} for layer in mlp]
                      for mlp in params["couplings"]],
        "scale": fn(params["scale"]),
    }


class Nice(Distribution):
    """A NICE flow trained on resized MNIST as a 196-d target density."""

    def __init__(
        self,
        params: dict | None = None,
        checkpoint: str | Path = DATA_DIR / "nice.npz",
        mean_data_path: str | Path = DATA_DIR / "mnist_mean.npy",
        sample_chunk_size: int = 10000,
        dim: int = 196,
        log_norm_const: float = 0.0,
        n_reference_samples: int = int(1e6),
        mid_dim: int = 500,
        hidden: int = 5,
        coupling: int = 4,
        mask_config: int = 1,
    ):
        super().__init__(dim=dim, log_norm_const=log_norm_const,
                         n_reference_samples=n_reference_samples)
        self.shape = (14, 14)
        if self.dim != math.prod(self.shape):
            raise ValueError(f"Dimension is {self.dim} but needs to be 196.")
        self.sample_chunk_size = sample_chunk_size
        self.mask_config = mask_config

        # the 28 x 28 MNIST mean, area-resized to 14 x 14 (2 x 2 averages)
        mean28 = np.load(mean_data_path).reshape(28, 28)
        self.mean = torch.as_tensor(
            mean28.reshape(14, 2, 14, 2).mean(axis=(1, 3)).reshape(1, self.dim))

        checkpoint = Path(checkpoint)
        if not checkpoint.is_absolute() and not checkpoint.exists():
            checkpoint = DATA_DIR.parent / checkpoint  # conf/'s data/<file>: the port's copy
        if params is not None:
            self.params = params
        elif checkpoint.exists():
            self.params, meta = load_nice_checkpoint(checkpoint)
            self.mask_config = int(meta.get("mask_config", mask_config))
        else:
            raise FileNotFoundError(
                f"No NICE checkpoint at {checkpoint}. The JAX package would draw a "
                f"seeded random flow (mid_dim {mid_dim}, hidden {hidden}, coupling "
                f"{coupling}) from its own PRNG, which the port cannot draw: pass its "
                "parameters (utils/params.py::nice_params_from_tree) or a checkpoint."
            )

    def to(self, device) -> "Nice":
        super().to(device)
        self.params = _map_params(self.params, lambda t: t.to(self.device))
        return self

    def unnorm_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        lp = nice_log_prob(self.params, x.reshape(-1, self.dim), self.mask_config)
        return lp.reshape(*x.shape[:-1], 1) + self.log_norm_const

    def score(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """∇ₓ log ρ(x) by autograd through the flow, SCORE_CHUNK_ROWS rows at a
        time."""
        rows = x.reshape(-1, self.dim)
        grads = [super(Nice, self).score(chunk) for chunk in rows.split(SCORE_CHUNK_ROWS)]
        return torch.cat(grads).reshape(x.shape)

    def plots(self, samples, n_max: int = 64) -> dict:
        """The first `n_max` samples (plus the data mean) as 14 x 14 images,
        each scaled to [0, 1], tiled 8 to a row into one PIL image."""
        from PIL import Image

        from sde_sampler_torch.eval.plots import to_numpy

        samples = to_numpy(samples[:n_max]) + to_numpy(self.mean)
        imgs = samples.reshape(-1, *self.shape)
        lo = imgs.min(axis=(1, 2), keepdims=True)
        hi = imgs.max(axis=(1, 2), keepdims=True)
        imgs = (imgs - lo) / np.maximum(hi - lo, 1e-8)
        n = imgs.shape[0]
        ncol = 8
        nrow = -(-n // ncol)
        pad = nrow * ncol - n
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad, *self.shape))])
        grid = (
            imgs.reshape(nrow, ncol, *self.shape)
            .transpose(0, 2, 1, 3)
            .reshape(nrow * self.shape[0], ncol * self.shape[1])
        )
        arr = np.clip(grid * 255 + 0.5, 0, 255).astype(np.uint8)
        return {"plots/samples": Image.fromarray(arr)}

    def sample(self, shape=None, generator: torch.Generator | None = None) -> torch.Tensor:
        shape = tuple(shape or (1,))
        if len(shape) > 1:
            raise ValueError("Can only sample shapes (batch_size,).")
        chunks, remaining = [], shape[0]
        with torch.no_grad():
            while remaining > 0:
                n = min(remaining, self.sample_chunk_size)
                z = StandardLogistic.sample((n, self.dim), generator, self.device)
                chunks.append(nice_g(self.params, z, self.mask_config))
                remaining -= n
        return torch.cat(chunks)
