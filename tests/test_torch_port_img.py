"""The image target of the port (`sde_sampler_torch/distr/img.py`) vs the
JAX package, on the CPU.

- The committed pixels (`sde_sampler_torch/data/labrador_rgb.npz`) equal
  matplotlib's decode of `data/labrador.jpg`, which the JAX package reads,
  and the port's copies of the other targets' data files are the bytes of
  the JAX package's (`data/`).
- The energy table, the log-density table and the inverse-CDF table are
  the same float32 arrays (the same numpy and scipy preprocessing).
- `unnorm_log_prob` and `score` on seeded points inside and outside the
  image and on inputs whose pixel cast saturates in JAX (|x| about 1e8
  and 1e10, ±inf, NaN): the same values, NaN where JAX's are, to 1e-6
  relative (float32 arithmetic of the same order; the outside penalty
  reaches 9.2e18 at 1e10). Img has no log Z, so `log_prob` raises on
  both sides.
- The sampler on shared uniforms: the pixel of each u by the JAX
  package's inverse CDF (`jnp.searchsorted(..., side="right")`, clipped)
  and the same jitter give the same samples to 1e-6.
- Kernel 1's image form: the plain twin against the JAX kernel in
  interpret mode and its scan is in tests/test_torch_port_rollout.py.
- Three DIS optimizer steps from the same parameters, prior samples and
  noise, at the tolerances of tests/test_torch_port_targets.py.
- A tiny CPU run of the entry point writes a finite log Z estimate, ESS
  and Sinkhorn value.
"""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr.img import Img as JImg
from sde_sampler_tpu.utils.config import compose, locate
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr.base import DATA_DIR
from sde_sampler_torch.distr.img import Img, to_int32
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = Path(__file__).parents[1]
B, STEPS = 16, 6


def tiny(target, *extra):
    """A small DIS run of `target` on both packages' config engines."""
    return [
        f"target={target}", "solver=dis", "loss.method=lv", f"train_batch_size={B}",
        f"train_timesteps.steps={STEPS}", "plot_results=False", "eval_init=False",
        "store_last_ckpt=False", "n_devices=1", "train_steps=10",
        "loss.scan_unroll=1",  # JAX compile time only; the port has no scan
        *extra,
    ]


def three_steps_match_jax(tmp_path, args, loss_rtol=1e-5, grad_rtol=1e-4, low=1e-2,
                          off=1e-3, low_at=None, max_excluded=None):
    """Three optimizer steps of the port's solver against the JAX train step
    from the same parameters, prior samples and noise, at the tolerances of
    tests/test_torch_port_targets.py by default: losses to `loss_rtol`, max
    gradients to `grad_rtol`, parameters to 5e-5 absolute (1% of one Adam
    step of lr 5e-3) except elements whose gradient in some step was
    nonzero but below `low` of its tensor's largest (`low_at[name]` for
    the tensors it names; Adam normalises every update to about lr, so such
    an element's step goes whichever way the rounding says), held to two
    steps of 2 lr; fewer than a share `off` of all elements may exceed
    5e-5. `max_excluded` = (per tensor, of all) bounds the shares of
    elements that the low-gradient rule exempts."""
    cfg = compose(REPO / "conf", "base", args + [f"out_dir={tmp_path / 'jax'}"])
    js = locate(cfg["solver"]["_target_"])(cfg)
    ps = entry.make_solver(args + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    assert type(ps.generative_ctrl).__name__ == "LerpCtrl"
    load_flax_params(ps.generative_ctrl,
                     jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)
    params = dict(ps.generative_ctrl.named_parameters())
    low_mask = {name: np.zeros(p.shape, dtype=bool) for name, p in params.items()}
    for _ in range(3):
        _, k_loss = jax.random.split(js.train_state.key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        j_metrics = js.step()
        metrics = ps.step(x0=torch.from_numpy(np.array(x0)), dbs=torch.from_numpy(np.array(dbs)))
        assert float(metrics["train/loss"]) == pytest.approx(
            float(j_metrics["train/loss"]), rel=loss_rtol)
        assert float(metrics["train/max_grad"]) == pytest.approx(
            float(j_metrics["train/max_grad"]), rel=grad_rtol)
        for name, p in params.items():
            grad = p.grad.abs().numpy()
            low_mask[name] |= (grad > 0) & (grad < (low_at or {}).get(name, low) * grad.max())
    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, js.train_state.params["generative_ctrl"]))
    lr, n_off, n_all = 5e-3, 0, 0
    for name, value in ps.generative_ctrl.state_dict().items():
        err = np.abs(value.numpy() - want[name].numpy())
        assert err[~low_mask[name]].max(initial=0.0) <= 5e-5, name
        assert err.max() <= 2 * 2 * lr, name
        n_off += int((err > 5e-5).sum())
        n_all += err.size
    assert n_off < off * n_all
    if max_excluded is not None:
        shares = {name: mask.mean() for name, mask in low_mask.items()}
        assert max(shares.values()) <= max_excluded[0], shares
        assert sum(m.sum() for m in low_mask.values()) <= max_excluded[1] * n_all
    assert ps.n_steps == 3 and ps.n_updates == 3 and ps.n_steps_skip == 0


@pytest.fixture(scope="module")
def pair():
    return JImg(n_reference_samples=1000), Img(n_reference_samples=1000)


def test_decoded_image_file_equals_matplotlib_decode():
    import matplotlib.image as mpimg

    rgb = np.load(DATA_DIR / "labrador_rgb.npz")["rgb"]
    want = mpimg.imread(REPO / "data" / "labrador.jpg")
    assert rgb.dtype == np.uint8 and rgb.shape == (720, 1280, 3)
    np.testing.assert_array_equal(rgb, want)


@pytest.mark.parametrize("name", ["pines.csv", "mnist_mean.npy", "nice.npz", "nice_smooth.npz"])
def test_port_data_files_are_the_jax_packages(name):
    assert (DATA_DIR / name).read_bytes() == (REPO / "data" / name).read_bytes()


def test_tables_are_the_jax_packages(pair):
    j, p = pair
    np.testing.assert_array_equal(p.pixel_energy.numpy(), np.asarray(j.pixel_energy))
    np.testing.assert_array_equal(p.density_cdf.numpy(), np.asarray(j.density_cdf))
    np.testing.assert_array_equal(p.log_density_flat.numpy(), np.asarray(j.log_density_flat))
    assert (p.maxindex_x, p.maxindex_y) == (j.maxindex_x, j.maxindex_y)


SATURATING = [[1e8, -1e8], [-1e8, 2e8], [3e7, 0.2], [1e10, -1e10], [-1e10, 1e10],
              [math.inf, 0.0], [-math.inf, 0.3], [0.1, math.inf], [math.nan, 0.0],
              [0.0, math.nan], [math.nan, math.inf], [1e30, -1e30]]


def test_xla_int32_cast_is_reproduced():
    v = np.array([1e10, -1e10, np.nan, np.inf, -np.inf, 2.5, -2.5, 2147483520.0, -2147483648.0],
                 dtype=np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    assert want.tolist()[:3] == [2147483647, -2147483648, 0]
    np.testing.assert_array_equal(to_int32(torch.from_numpy(v)).numpy(), want)


def test_log_density_and_score_match_jax(pair):
    j, p = pair
    rng = np.random.default_rng(0)
    # inside the image (|x| < 3.5 maps onto its 700 pixels) and outside it
    x = np.concatenate([rng.normal(size=(256, 2)) * 2.0, np.array(SATURATING)]).astype(np.float32)
    xt = torch.from_numpy(x)
    for name in ("unnorm_log_prob", "score"):
        got = getattr(p, name)(xt).numpy()
        want = np.asarray(getattr(j, name)(jnp.asarray(x)))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    # over any leading batch shape
    torch.testing.assert_close(p.score(xt[:256].reshape(16, 16, 2)),
                               p.score(xt[:256]).reshape(16, 16, 2))
    with pytest.raises(NotImplementedError):
        p.log_prob(xt)
    with pytest.raises(NotImplementedError):
        j.log_prob(jnp.asarray(x))


def test_sampler_on_shared_uniforms_matches_jax(pair):
    j, p = pair
    rng = np.random.default_rng(1)
    n = 4096
    u = rng.uniform(size=n).astype(np.float32)
    u[:3] = [0.0, np.float32(1.0 - 2**-24), float(np.asarray(j.density_cdf)[1000])]
    jitter = rng.uniform(size=(n, 2)).astype(np.float32)
    # the JAX package's Img.sample on these uniforms
    i = jnp.clip(jnp.searchsorted(j.density_cdf, jnp.asarray(u), side="right"),
                 0, j.density_cdf.shape[0] - 1)
    ixy = j.idx[i].astype(jnp.float32)
    want = (ixy + jnp.asarray(jitter) - 0.5 - j.mean) / j.scale
    got = p.sample_from_uniforms(torch.from_numpy(u), torch.from_numpy(jitter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    samples = p.sample((10,), generator=torch.Generator().manual_seed(0))
    assert samples.shape == (10, 2) and bool(torch.isfinite(samples).all())


def test_three_img_optimizer_steps_match_jax(tmp_path):
    three_steps_match_jax(tmp_path, tiny("img", "target.n_reference_samples=1000"))


def entry_run(tmp_path, target, *extra):
    """A tiny CPU run of the entry point; the last metrics line."""
    out = tmp_path / target
    args = [a for a in tiny(target, *extra) if a != "train_steps=10"]
    entry.main(args + ["device=cpu", "train_steps=3", "eval_batch_size=64", f"out_dir={out}"])
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any(math.isfinite(line.get("train/loss", math.nan)) for line in lines)
    return lines[-1]


def test_entry_point_cpu_run_of_img(tmp_path):
    final = entry_run(tmp_path, "img", "target.n_reference_samples=1000")
    for key in ("eval/log_norm_const_lb_ito", "eval/effective_sample_size", "error/sinkhorn",
                "error/avg_marginal_stddev"):
        assert math.isfinite(final[key]), key
