"""`python -m sde_sampler_torch.train_nice` against `scripts/train_nice.py`, on the CPU.

- Data: the synthetic images, the 2 x 2 resize and the IDX reader (on
  files the test writes, plain and gzipped) give the JAX script's bytes.
- The flow's init: the tree of `init_nice_params` (shapes, flatten order,
  the ±1/sqrt(fan_in) bounds, a zero log-scaling).
- The loss and its gradients, on parameters carried across from the JAX
  package's `init_nice_params` and on shared dequantisation and pixel
  noise: the NLL to 1e-5 relative, each gradient to 1e-5 of its tensor's
  largest element (float32 products 8-24 wide through 4 couplings of 6
  layers, summed in another order on each side).
- Three optimizer steps against the optax chain the script builds
  (scale_by_adam with eps = 1e-4, then the schedule lr·γ^k): the
  parameters to 1e-6 relative plus 1e-3 of one update's size (lr). Adam's
  eps = 1e-4 bounds how far a gradient's rounding can move its update, so
  no element is exempted.
- A checkpoint written by the port loads in the JAX `load_nice_checkpoint`
  and in the port's `Nice`, which give the same log-density.
- An end-to-end `--device cpu` run, which leaves the committed
  `sde_sampler_torch/data/nice*.npz` as they are; the set-up refusals
  (no card without --device cpu; no PIL for a run that writes grids).
"""
from __future__ import annotations

import gzip
import hashlib
import importlib.util
import math
import struct
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sde_sampler_tpu.distr import nice as jax_nice
from sde_sampler_torch import train_nice as port
from sde_sampler_torch.distr import nice as port_nice
from sde_sampler_torch.utils.params import nice_params_from_tree

REPO_ROOT = Path(__file__).resolve().parents[1]
MID, BATCH, SIGMA = 16, 8, 0.05


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_nice", REPO_ROOT / "scripts" / "train_nice.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_train_nice"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_images_and_resize_match_the_script(script):
    images = port.synthetic_images(20, seed=3)
    want = script.synthetic_images(20, seed=3)
    assert images.dtype == want.dtype and images.tobytes() == want.tobytes()
    assert port.resize_14(images).tobytes() == script.resize_14(want).tobytes()
    assert port.resize_14(images).shape == (20, 14, 14)


@pytest.mark.parametrize("name", ["train-images-idx3-ubyte.gz", "train-images-idx3-ubyte",
                                  "train-images.idx3-ubyte"])
def test_idx_reader_matches_the_script(script, tmp_path, name):
    pixels = np.random.default_rng(0).integers(0, 256, size=(5, 28, 28), dtype=np.uint8)
    payload = struct.pack(">IIII", 2051, 5, 28, 28) + pixels.tobytes()
    opener = gzip.open if name.endswith(".gz") else open
    with opener(tmp_path / name, "wb") as f:
        f.write(payload)
    got = port.load_mnist_images(tmp_path)
    assert got.tobytes() == script.load_mnist_images(tmp_path).tobytes()
    assert got.shape == (5, 28, 28) and got.max() <= 1.0


def test_idx_reader_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="No MNIST IDX files"):
        port.load_mnist_images(tmp_path)
    (tmp_path / "train-images-idx3-ubyte").write_bytes(struct.pack(">IIII", 7, 0, 28, 28))
    with pytest.raises(ValueError, match="bad IDX magic 7"):
        port.load_mnist_images(tmp_path)


def test_init_nice_params_matches_the_jax_tree():
    params = port_nice.init_nice_params(torch.Generator().manual_seed(0), in_out_dim=196,
                                        mid_dim=MID, hidden=5, coupling=4)
    jax_leaves = jax.tree_util.tree_leaves(
        jax_nice.init_nice_params(jax.random.PRNGKey(0), in_out_dim=196, mid_dim=MID))
    leaves = port_nice.tree_leaves(params)
    assert [tuple(a.shape) for a in leaves] == [a.shape for a in jax_leaves]
    assert all(a.dtype == torch.float32 and b.dtype == np.float32
               for a, b in zip(leaves, jax_leaves))
    for mlp in params["couplings"]:
        for layer in mlp:
            bound = 1.0 / math.sqrt(layer["w"].shape[0])
            assert layer["w"].abs().max() <= bound and layer["b"].abs().max() <= bound
    assert not params["scale"].any()


@pytest.fixture(scope="module")
def flow():
    """A JAX flow (a non-zero log-scaling), the port's copy, the data mean,
    and a run's first three batches with their noise, all as numpy."""
    tree = jax_nice.init_nice_params(jax.random.PRNGKey(5), in_out_dim=196, mid_dim=MID)
    tree["scale"] = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (1, 196))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    mean = port.resize_14(np.load(REPO_ROOT / "data" / "mnist_mean.npy").reshape(28, 28))
    images = port.resize_14(port.synthetic_images(50, seed=0)).reshape(50, 196)
    rng = np.random.default_rng(0)
    noise = np.random.default_rng(1)
    steps = [(images[rng.integers(0, 50, BATCH)],
              noise.uniform(size=(BATCH, 196)).astype(np.float32),
              noise.standard_normal(size=(BATCH, 196)).astype(np.float32)) for _ in range(3)]
    return tree, mean.reshape(1, 196).astype(np.float32), steps


def jax_loss(params, batch, mean, uniform, pixel):
    """The JAX script's loss_fn with its two draws given."""
    x = (batch * 255.0 + uniform) / 256.0 - mean + SIGMA * pixel
    return -jax_nice.nice_log_prob(params, x, 1).mean()


def port_params(tree) -> dict:
    params = nice_params_from_tree(tree)
    return {"couplings": [[{k: v.requires_grad_() for k, v in layer.items()} for layer in mlp]
                          for mlp in params["couplings"]],
            "scale": params["scale"].requires_grad_()}


def test_loss_and_gradients_match_jax(flow):
    tree, mean, steps = flow
    batch, uniform, pixel = steps[0]
    want, grads = jax.value_and_grad(jax_loss)(tree, batch, mean, uniform, pixel)
    params = port_params(tree)
    loss = port.nice_loss(params, *map(torch.from_numpy, (batch, mean, uniform, pixel)),
                          SIGMA, 1)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for got, ref in zip(port_nice.tree_leaves(params), jax.tree_util.tree_leaves(grads)):
        err = np.abs(got.grad.numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_three_optimizer_steps_match_optax(flow):
    tree, mean, steps = flow
    args = port.parse_args(["--max_iter", "10", "--device", "cpu"])
    gamma = (args.min_lr / args.lr) ** (1 / args.max_iter)
    tx = optax.chain(optax.scale_by_adam(b1=args.momentum, b2=args.decay, eps=1e-4),
                     optax.scale_by_schedule(lambda s: -(args.lr * gamma**s)))
    jparams, opt_state = tree, tx.init(tree)
    params = port_params(tree)
    optimizer, scheduler = port.make_optimizer(port_nice.tree_leaves(params), args)
    for batch, uniform, pixel in steps:
        grads = jax.grad(jax_loss)(jparams, batch, mean, uniform, pixel)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port.train_step(params, optimizer, scheduler,
                        *map(torch.from_numpy, (batch, mean, uniform, pixel)), SIGMA, 1)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(args.lr * gamma**3, rel=1e-12)
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)]
    for got, want in zip(port_nice.tree_leaves(params), jleaves):
        err = np.abs(got.detach().numpy() - want)
        assert (err <= 1e-6 * np.abs(want) + 1e-3 * args.lr).all(), err.max()
    moved = [np.abs(w - t).max() for w, t in zip(jleaves, jax.tree_util.tree_leaves(tree))]
    assert min(moved) > 0.5 * args.lr  # every tensor took its three updates


def test_checkpoint_reads_the_same_in_both_loaders(flow, tmp_path):
    tree, _, _ = flow
    params = nice_params_from_tree(tree)
    meta = {"in_out_dim": 196, "mid_dim": MID, "hidden": 5, "coupling": 4, "mask_config": 1}
    path = tmp_path / "flow.npz"
    port_nice.save_nice_checkpoint(path, params, meta)
    jparams, jmeta = jax_nice.load_nice_checkpoint(path)
    assert jmeta == meta
    for got, want in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(np.asarray(got), want)
    x = np.random.default_rng(2).standard_normal((6, 196)).astype(np.float32)
    target = port_nice.Nice(checkpoint=path, n_reference_samples=10)
    got = target.unnorm_log_prob(torch.from_numpy(x)).squeeze(-1).numpy()
    want = np.asarray(jax_nice.nice_log_prob(jparams, jnp.asarray(x), 1))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _committed_flows() -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO_ROOT / "sde_sampler_torch" / "data").glob("nice*.npz"))}


def test_end_to_end_cpu_run(tmp_path):
    before = _committed_flows()
    out = tmp_path / "trained.npz"
    losses = port.train_nice(port.parse_args([
        "--synthetic", "40", "--pixel-noise", "0.05", "--max_iter", "3", "--mid_dim", "8",
        "--batch_size", "16", "--device", "cpu", "--out", str(out)]))
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    target = port_nice.Nice(checkpoint=out, n_reference_samples=10)
    assert target.params["couplings"][0][0]["w"].shape == (98, 8)
    assert torch.isfinite(target.sample((5,), generator=torch.Generator().manual_seed(0))).all()
    assert _committed_flows() == before and len(before) == 2


def test_set_up_refusals(monkeypatch, tmp_path):
    out = str(tmp_path / "never.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="No CUDA device"):
            port.train_nice(port.parse_args(["--synthetic", "4", "--max_iter", "1", "--out", out]))
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(ImportError, match=r"PIL \(Pillow\)"):
        port.train_nice(port.parse_args(["--synthetic", "4", "--max_iter", "1000",
                                         "--device", "cpu", "--out", out]))
    assert not Path(out).exists()
