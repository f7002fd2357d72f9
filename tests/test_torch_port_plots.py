"""Evaluation plots, the solvers' plot hooks and the profiler window of the
port against `sde_sampler_tpu/eval/plots.py` and the JAX targets' `plots`.

The same samples, weights and trajectories go through both packages'
plots; the drawn data are read back from the matplotlib artists (bar
heights, line data, image arrays) and compared. Everything computed from
the inputs agrees to float32 rounding; the ground-truth draws come from
each package's own random stream (JAX keys, torch generators), so those
are compared by shape only, and the funnel's Monte Carlo marginal by its
statistical error.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from sde_sampler_tpu.distr.double_well import DoubleWell as JDoubleWell  # noqa: E402
from sde_sampler_tpu.distr.funnel import Funnel as JFunnel  # noqa: E402
from sde_sampler_tpu.distr.gauss import GMM as JGMM  # noqa: E402
from sde_sampler_tpu.distr.img import Img as JImg  # noqa: E402
from sde_sampler_tpu.distr.nice import Nice as JNice  # noqa: E402
from sde_sampler_tpu.eval import plots as jplots  # noqa: E402
from sde_sampler_torch import main as entry  # noqa: E402
from sde_sampler_torch.distr.double_well import DoubleWell  # noqa: E402
from sde_sampler_torch.distr.funnel import Funnel  # noqa: E402
from sde_sampler_torch.distr.gauss import GMM  # noqa: E402
from sde_sampler_torch.distr.img import Img  # noqa: E402
from sde_sampler_torch.distr.nice import Nice  # noqa: E402
from sde_sampler_torch.eval import plots  # noqa: E402

from test_torch_port_models import REPO  # noqa: E402

GMM_KW = dict(dim=2, loc=[[-2.0, 0.0], [1.5, 1.0], [0.0, -2.5]],
              scale=[[0.5, 0.8], [1.0, 0.4], [0.7, 0.7]], mixture_weights=[1.0, 2.0, 1.5])


def drawn(fig) -> dict:
    """The data a figure draws, axis by axis: bar heights, line data (and
    colours), image arrays and mesh arrays."""
    out = []
    for ax in fig.axes:
        out.append(dict(
            bars=np.array([p.get_height() for p in ax.patches]),
            lines=[l.get_xydata() for l in ax.lines],
            colors=[l.get_color() for l in ax.lines],
            images=[np.ma.filled(np.asarray(im.get_array(), dtype=float), 0.0)
                    for im in ax.images],
            meshes=[np.ma.filled(np.asarray(c.get_array(), dtype=float), 0.0)
                    for c in ax.collections if hasattr(c, "get_array")
                    and c.get_array() is not None],
        ))
    return out


def assert_same_drawing(got, want, rtol=1e-5, atol=1e-6, lines=True):
    g, w = drawn(got), drawn(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a["bars"], b["bars"], rtol=rtol, atol=atol)
        assert len(a["images"]) == len(b["images"]) and len(a["meshes"]) == len(b["meshes"])
        for x, y in zip(a["images"] + a["meshes"], b["images"] + b["meshes"]):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)
        if lines:
            assert len(a["lines"]) == len(b["lines"])
            for x, y in zip(a["lines"], b["lines"]):
                np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)
            assert a["colors"] == b["colors"]


def inputs(d, n=400, T=6, seed=0):
    rng = np.random.default_rng(seed)
    samples = (1.5 * rng.normal(size=(n, d))).astype(np.float32)
    samples[3, 0] = np.nan  # a non-finite sample and trajectory are dropped
    weights = rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32)
    ts = np.linspace(0.0, 1.0, T + 1).astype(np.float32)
    xs = np.cumsum(rng.normal(size=(T + 1, 64, d)), axis=0).astype(np.float32)
    xs[2, 5, 0] = np.inf
    return samples, weights, ts, xs


@pytest.mark.parametrize("target", ["gmm", "funnel"])
def test_get_plots_keys_and_drawn_data_match_jax(target):
    if target == "gmm":
        j_distr, distr, d = JGMM(**GMM_KW), GMM(**GMM_KW), 2
    else:  # the first marginal exact, the others by Monte Carlo
        j_distr = JFunnel(dim=3, n_reference_samples=10**5)
        distr, d = Funnel(dim=3, n_reference_samples=10**5), 3
    samples, weights, ts, xs = inputs(d)
    dims = [0, 1]
    want = jplots.get_plots(j_distr, samples, weights=weights, ts=ts, xs=xs,
                            marginal_dims=dims)
    got = plots.get_plots(distr, torch.from_numpy(samples), weights=torch.from_numpy(weights),
                          ts=torch.from_numpy(ts), xs=torch.from_numpy(xs), marginal_dims=dims,
                          generator=torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for key in want:
        if "groundtruth" in key:  # each package's own draws
            assert drawn(got[key])[0]["images"][0].shape == drawn(want[key])[0]["images"][0].shape
        elif target == "funnel" and key == "plots/hist_1":
            assert_same_drawing(got[key], want[key], lines=False)
            (g_line,), (w_line,) = drawn(got[key])[0]["lines"], drawn(want[key])[0]["lines"]
            np.testing.assert_allclose(g_line[:, 0], w_line[:, 0], rtol=1e-6)
            # 1e5 draws of the first coordinate: a few percent where it is
            # not tiny
            np.testing.assert_allclose(g_line[:, 1], w_line[:, 1], rtol=0.05, atol=2e-3)
        else:
            assert_same_drawing(got[key], want[key])
    plt.close("all")


def test_target_plots_match_jax():
    """The double well's rejection-sampling diagnostic (the density and
    the scaled proposal), the image's energies and sample histogram, and
    NICE's image grid, on the same samples."""
    j_well, well = JDoubleWell(), DoubleWell()
    j_well.compute_stats(jax.random.PRNGKey(0))  # log Z by quadrature
    well.compute_stats()
    x = np.random.default_rng(1).normal(size=(300, 1)).astype(np.float32)
    got, want = well.plots(torch.from_numpy(x)), j_well.plots(jnp.asarray(x))
    assert set(got) == set(want) == {"plots/rejection_sampling"}
    (g,), (w,) = drawn(got["plots/rejection_sampling"]), drawn(want["plots/rejection_sampling"])
    assert len(g["bars"]) == len(w["bars"]) == 100  # from each side's own draws
    for a, b in zip(g["lines"], w["lines"]):  # the density and the proposal
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    j_img, img = JImg(path=REPO / "data" / "labrador.jpg"), Img()
    x = np.random.default_rng(2).uniform(-3.0, 3.0, size=(500, 2)).astype(np.float32)
    got, want = img.plots(torch.from_numpy(x)), j_img.plots(jnp.asarray(x))
    assert set(got) == set(want) == {"plots/comparison", "plots/groundtruth"}
    # the energies: the decoded image, exp(-energy), its contours
    assert_same_drawing(got["plots/groundtruth"], want["plots/groundtruth"])
    # the prediction's histogram (the first axis; the second is each
    # package's ground-truth draws)
    g, w = drawn(got["plots/comparison"]), drawn(want["plots/comparison"])
    np.testing.assert_array_equal(g[0]["meshes"][0], w[0]["meshes"][0])
    assert g[1]["meshes"][0].shape == w[1]["meshes"][0].shape

    j_nice, nice = JNice(checkpoint=REPO / "data" / "nice.npz"), Nice()
    x = np.random.default_rng(3).normal(size=(70, 196)).astype(np.float32)
    got, want = nice.plots(torch.from_numpy(x)), j_nice.plots(jnp.asarray(x))
    assert set(got) == set(want) == {"plots/samples"}
    np.testing.assert_array_equal(np.asarray(got["plots/samples"]),
                                  np.asarray(want["plots/samples"]))
    assert np.asarray(got["plots/samples"]).shape == (8 * 14, 8 * 14)
    plt.close("all")


TINY = ["target=gmm", "solver=dis", "device=cpu", "train_batch_size=16",
        "train_timesteps.steps=8", "eval_batch_size=64", "traj_batch_size=32",
        "target.n_reference_samples=1000", "~eval_sample_losses", "store_last_ckpt=False"]


def test_solver_writes_the_plots_under_out_dir(tmp_path):
    """A DIS run with the default plot_results: the evaluation's plots at
    every evaluation (`{key}_step_{n}.png`) and the final ones
    (`{key}.png`), the trajectory plots from the traj_batch_size rollout."""
    solver = entry.main(TINY + ["train_steps=2", "eval_init=False", f"out_dir={tmp_path}"])
    assert solver.plot_results and solver.traj_batch_size == 32
    names = {p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.png")}
    for key in ("traj_0", "hist_0", "hist_1", "density_0_1", "groundtruth_density_0_1"):
        assert f"plots/{key}.png" in names and f"plots/{key}_step_2.png" in names, key
    results = solver.compute_results()
    assert results.xs.shape == (solver.eval_ts.shape[0], 32, 2)
    plt.close("all")


def test_bridge_inference_plots(tmp_path):
    """The Bridge with a learned inference control plots its inference
    SDE's trajectories from target samples (keys `*_inference`)."""
    solver = entry.make_solver([*TINY, "solver=bridge_diff_init", "train_steps=1",
                                f"out_dir={tmp_path}"])
    solver.setup()
    results = solver.compute_results()
    assert {"plots/traj_0_inference", "plots/hist_0_inference",
            "plots/density_0_1_inference"} <= set(results.plots)
    plt.close("all")


def test_missing_matplotlib_raises_at_set_up(tmp_path):
    """With matplotlib hidden the port imports, runs with plot_results=False,
    and plot_results=True raises at the solver's set-up, naming the package
    and plot_results=False."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "from sde_sampler_torch import main\n"
        "import sde_sampler_torch.eval.plots, sde_sampler_torch.solver.oc\n"
        f"args = {TINY!r} + ['train_steps=1', 'out_dir=' + sys.argv[1]]\n"
        "main.make_solver(args + ['plot_results=False'])\n"
        "try:\n"
        "    main.make_solver(args)\n"
        "except ImportError as err:\n"
        "    print(err)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "matplotlib" in out.stdout and "plot_results=False" in out.stdout, out.stdout


def test_profiler_window_writes_a_trace(tmp_path):
    """profile_start=1 profile_steps=2 over 4 steps writes one Chrome trace
    of steps 1-3 under out_dir/profile; without the keys there is none."""
    args = TINY + ["plot_results=False", "train_steps=4", "eval_init=False"]
    entry.main(args + ["+profile_start=1", "+profile_steps=2", f"out_dir={tmp_path / 'on'}"])
    traces = list((tmp_path / "on" / "profile").glob("*.json"))
    assert [t.name for t in traces] == ["trace_steps_1_3.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    entry.main(args + [f"out_dir={tmp_path / 'off'}"])
    assert not (tmp_path / "off" / "profile").exists()
