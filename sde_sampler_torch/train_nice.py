"""Train the NICE flow on 14 x 14 MNIST (or a synthetic stand-in) in PyTorch.

Port of `scripts/train_nice.py`: the 28 -> 14 resize (2 x 2 averages),
uniform dequantisation and mean centring, Adam (b1 = --momentum,
b2 = --decay, eps = 1e-4) with the learning rate lr·γ^k at the k-th update
(k from 0, γ = (min_lr/lr)^(1/max_iter)), a sample grid every 1000
iterations under logs/nice/, and the checkpoint that the `Nice` targets of
both packages read, written as `arr_<i>` leaves and `meta_<key>` entries of
one .npz at `sde_sampler_torch/data/<--out>` (an absolute --out is kept as
it is):

    python -m sde_sampler_torch.train_nice --data_dir /path/to/MNIST/raw
    python -m sde_sampler_torch.train_nice --synthetic 4000 --pixel-noise 0.05 \
        --out nice_new.npz [--device cpu]

MNIST is read from its IDX files (train-images-idx3-ubyte[.gz]) in
--data_dir; `--synthetic N` trains on N deterministic stroke-like images
instead, the JAX script's generator to the byte. It runs on the CUDA card
unless `--device cpu` is given. The grids need PIL: without it a run of
1000 iterations or more refuses at set-up.
"""
from __future__ import annotations

import argparse
import gzip
import struct
from pathlib import Path

import numpy as np
import torch

from sde_sampler_torch.distr import nice as nice_lib
from sde_sampler_torch.distr.base import DATA_DIR
from sde_sampler_torch.utils.device import resolve_device

REPO_ROOT = Path(__file__).resolve().parents[1]
MNIST_SIZE = 28
GRID_INTERVAL = 1000  # iterations between the loss reports and sample grids


def synthetic_images(n: int, seed: int = 0) -> np.ndarray:
    """N deterministic MNIST-shaped images in [0, 1]: 3-6 Gaussian bumps
    along a random quadratic Bezier path across the canvas."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:MNIST_SIZE, 0:MNIST_SIZE].astype(np.float32)
    imgs = np.zeros((n, MNIST_SIZE, MNIST_SIZE), dtype=np.float32)
    for i in range(n):
        k = rng.integers(3, 7)
        p = rng.uniform(4, 24, size=(3, 2)).astype(np.float32)
        t = np.linspace(0, 1, k, dtype=np.float32)[:, None]
        centers = ((1 - t) ** 2) * p[0] + 2 * (1 - t) * t * p[1] + t**2 * p[2]
        widths = rng.uniform(1.2, 2.5, size=k).astype(np.float32)
        amps = rng.uniform(0.6, 1.0, size=k).astype(np.float32)
        img = np.zeros((MNIST_SIZE, MNIST_SIZE), dtype=np.float32)
        for (cy, cx), w, a in zip(centers, widths, amps):
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * w**2))
        imgs[i] = np.clip(img, 0.0, 1.0)
    return imgs


def load_mnist_images(data_dir: Path) -> np.ndarray:
    """train-images-idx3-ubyte(.gz) -> (N, 28, 28) float32 in [0, 1]."""
    for name in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
        for opener, suffix in ((gzip.open, ".gz"), (open, "")):
            path = data_dir / (name + suffix)
            if path.exists():
                with opener(path, "rb") as f:
                    magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                    if magic != 2051:
                        raise ValueError(f"{path}: bad IDX magic {magic}")
                    data = np.frombuffer(f.read(), dtype=np.uint8)
                return data.reshape(n, rows, cols).astype(np.float32) / 255.0
    raise FileNotFoundError(
        f"No MNIST IDX files found in {data_dir}. Put train-images-idx3-ubyte.gz "
        "(from the standard MNIST distribution) into that directory."
    )


def resize_14(x: np.ndarray) -> np.ndarray:
    """28 x 28 -> 14 x 14 by 2 x 2 average pooling."""
    return x.reshape(*x.shape[:-2], 14, 2, 14, 2).mean(axis=(-1, -3))


def save_image_grid(imgs: np.ndarray, path: Path, ncol: int = 8) -> None:
    from PIL import Image

    lo = imgs.min(axis=(1, 2), keepdims=True)
    hi = imgs.max(axis=(1, 2), keepdims=True)
    imgs = (imgs - lo) / np.maximum(hi - lo, 1e-8)
    n, h, w = imgs.shape
    nrow = -(-n // ncol)
    pad = nrow * ncol - n
    if pad:
        imgs = np.concatenate([imgs, np.zeros((pad, h, w))])
    grid = imgs.reshape(nrow, ncol, h, w).transpose(0, 2, 1, 3).reshape(nrow * h, ncol * w)
    Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(path)


def nice_loss(params: dict, batch: torch.Tensor, mean: torch.Tensor, uniform: torch.Tensor,
              pixel: torch.Tensor | None, pixel_noise: float, mask_config: int) -> torch.Tensor:
    """The step's NLL: dequantise (x·255 + U)/256, centre, add the pixel
    noise σ·ξ where σ > 0, and average −log p under the flow."""
    x = (batch * 255.0 + uniform) / 256.0 - mean
    if pixel_noise > 0:
        x = x + pixel_noise * pixel
    return -nice_lib.nice_log_prob(params, x, mask_config).mean()


def make_optimizer(params: list[torch.Tensor], args):
    """Adam (optax's scale_by_adam: b1 = momentum, b2 = decay, eps = 1e-4)
    scaled by lr·γ^k at the k-th update, k from 0."""
    gamma = (args.min_lr / args.lr) ** (1 / args.max_iter)
    optimizer = torch.optim.Adam(params, lr=args.lr, betas=(args.momentum, args.decay), eps=1e-4)
    return optimizer, torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma)


def train_step(params: dict, optimizer, scheduler, batch, mean, uniform, pixel,
               pixel_noise: float, mask_config: int) -> torch.Tensor:
    """One Adam step on the batch with the given noise; returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = nice_loss(params, batch, mean, uniform, pixel, pixel_noise, mask_config)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return loss.detach()


def train_nice(args) -> list[float]:
    """Train as the JAX script does; returns the loss of every iteration."""
    device = resolve_device(args.device)
    if args.max_iter >= GRID_INTERVAL:
        try:
            import PIL  # noqa: F401
        except ImportError as err:
            raise ImportError(
                f"the sample grids written every {GRID_INTERVAL} iterations need PIL "
                "(Pillow), which is not installed: install it, or train for fewer "
                f"than {GRID_INTERVAL} iterations (--max_iter)") from err
    resize = args.resize
    full_dim = resize * resize
    mid_dim = args.mid_dim or int(1000 * resize / MNIST_SIZE)
    hidden, coupling, mask_config = 5, 4, 1
    log_dir = REPO_ROOT / "logs" / "nice"

    mean28 = np.load(DATA_DIR / "mnist_mean.npy").reshape(28, 28)
    mean = torch.as_tensor(resize_14(mean28).reshape(1, full_dim), dtype=torch.float32,
                           device=device)
    if args.synthetic:
        images = resize_14(synthetic_images(args.synthetic, seed=args.seed))
        print(f"Generated synthetic dataset: {images.shape}")
    else:
        images = resize_14(load_mnist_images(Path(args.data_dir)))
        print(f"Loaded MNIST: {images.shape}")
    images = images.reshape(images.shape[0], full_dim)

    init_generator = torch.Generator().manual_seed(args.seed)
    params = nice_lib.init_nice_params(init_generator, in_out_dim=full_dim, mid_dim=mid_dim,
                                       hidden=hidden, coupling=coupling)
    params = nice_lib._map_params(params, lambda t: t.to(device).requires_grad_())
    optimizer, scheduler = make_optimizer(nice_lib.tree_leaves(params), args)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # fresh pixel noise every step (synthetic data only): the learned density
    # is the bump manifold convolved with N(0, σ² I), σ-thick in every dimension
    pixel_noise = float(args.pixel_noise) if args.synthetic else 0.0

    rng = np.random.default_rng(args.seed)  # the batches of the JAX script
    losses, running_loss = [], 0.0
    for it in range(1, args.max_iter + 1):
        idx = rng.integers(0, images.shape[0], args.batch_size)
        batch = torch.as_tensor(images[idx], device=device)
        uniform = torch.rand(batch.shape, generator=generator, device=device)
        pixel = (torch.randn(batch.shape, generator=generator, device=device)
                 if pixel_noise > 0 else None)
        loss = float(train_step(params, optimizer, scheduler, batch, mean, uniform, pixel,
                                pixel_noise, mask_config))
        losses.append(loss)
        running_loss += loss
        if it % GRID_INTERVAL == 0:
            mean_loss = running_loss / GRID_INTERVAL
            bits = (mean_loss + np.log(256.0) * full_dim) / (full_dim * np.log(2.0))
            lr = optimizer.param_groups[0]["lr"]  # lr·γ^it, the JAX script's schedule(it)
            print(f"iter {it}: loss = {mean_loss:.3f} bits/dim = {bits:.3f} lr = {lr:.5f}")
            running_loss = 0.0
            with torch.no_grad():
                samples = nice_lib.nice_sample(params, args.sample_size, full_dim, mask_config,
                                               generator)
            log_dir.mkdir(parents=True, exist_ok=True)
            save_image_grid((samples + mean).cpu().numpy().reshape(-1, resize, resize),
                            log_dir / f"samples_iter{it}.png")

    k = max(1, len(losses) // 10)
    if losses:
        print(f"mean loss: iterations 1-{k} {np.mean(losses[:k]):.4f}, "
              f"{len(losses) - k + 1}-{len(losses)} {np.mean(losses[-k:]):.4f}")
    out = DATA_DIR / args.out
    nice_lib.save_nice_checkpoint(out, params, {
        "in_out_dim": full_dim, "mid_dim": mid_dim, "hidden": hidden,
        "coupling": coupling, "mask_config": mask_config,
    })
    print(f"Saved checkpoint to {out}")
    return losses


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("train NICE on MNIST")
    parser.add_argument("--data_dir", default=str(REPO_ROOT / "data" / "MNIST"))
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N deterministic synthetic images instead of MNIST")
    parser.add_argument("--pixel-noise", type=float, default=0.0,
                        help="Gaussian pixel noise added to the synthetic images every step")
    parser.add_argument("--out", type=str, default="nice.npz",
                        help="checkpoint file under sde_sampler_torch/data/ (or an absolute path)")
    parser.add_argument("--mid_dim", type=int, default=0,
                        help="hidden width override (default: 1000*resize/28)")
    parser.add_argument("--batch_size", type=int, default=200)
    parser.add_argument("--resize", type=int, default=14)
    parser.add_argument("--latent", default="logistic")
    parser.add_argument("--max_iter", type=int, default=10000)
    parser.add_argument("--sample_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--min_lr", type=float, default=1e-4)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--decay", type=float, default=0.999)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="cuda (the default: the card) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    train_nice(parse_args())
