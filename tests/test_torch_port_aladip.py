"""The alanine dipeptide target of the port (`sde_sampler_torch/distr/
aladip.py`, `aladip_ff.py`, `aladip_transform.py`) vs the JAX package's
native backend, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; float32 on
both, summed in other orders (XLA's fused reductions against torch's):

- the AMBER energy, per term and in total, at the minimum-energy structure,
  at perturbed ones and at degenerate ones (coincident and collinear
  atoms): to 1e-5 relative plus 1e-3 kJ/mol, and inf on both sides where
  two unbonded atoms coincide; its gradient (the forces, up to about 1e5
  kJ/mol/nm on the degenerate geometries) to 1e-4 of the geometry's
  largest plus 1e-2, finite where JAX's is. At an exact tie of the angle's clip both sides split the
  gradient in halves (`torch.maximum`/`minimum`, as `jnp.clip`), where
  `torch.clamp` would pass it whole; a non-finite energy gives a nan
  gradient through `regularize_energy` on both sides;
- the transform: the reference means (computed in float32 from the float64
  structure on both sides, by other libm routines: at most 2 ulp, 2.4e-7,
  apart, which moves the log-density at the minimum by below 1e-5 relative),
  forward (positions to 2e-6 nm, the log-Jacobian and the domain violation
  to 1e-5 relative) and inverse (to 1e-5), and `clamp_internals` outside
  the domain (exactly);
- the log-density on all of R^60 (states at 0.5 and at 30 standard
  deviations: finite where JAX's is, to 1e-5 relative) and the autograd
  score (to 1e-4 relative to each row's largest entry: the force field's
  sums of hundreds of pair terms, in another order);
- the chirality filter, which selects exactly JAX's rows, at the wrap-around
  (differences near ±pi and on the ties of the argmin), and rejects the
  mirrored structure; `phi_psi` at the minimum, (-146°, +150°);
- the eval-set sampler (draws with replacement from the port's copy of
  `data/aladip_eval.npy`, which is the JAX package's file byte for byte);
- two `solver=dis` optimizer steps at B 32 on the first 16 steps of the
  config's grid: before each, the loss and every gradient at the same
  parameters on the JAX package's own prior samples and noise buffer (the
  given-score plain twin in phase 1) to 1e-4 relative, and each gradient
  to 1e-4 of its tensor's largest (sums over 512 recorded states of
  scores summed in another order).
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.distr import aladip_ff as jff
from sde_sampler_tpu.distr import aladip_transform as jtf
from sde_sampler_tpu.distr.aladip import AlaDip as JAlaDip
from sde_sampler_tpu.distr.aladip import filter_chirality as j_filter
from sde_sampler_tpu.solver.oc import Bridge as JBridge
from sde_sampler_tpu.utils.config import compose
from sde_sampler_tpu.utils.torch_import import convert_state_dict
from sde_sampler_torch import main as entry
from sde_sampler_torch.distr import aladip_ff as ff
from sde_sampler_torch.distr import aladip_transform as tf
from sde_sampler_torch.distr.aladip import AlaDip, filter_chirality
from sde_sampler_torch.distr.base import DATA_DIR
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = Path(__file__).parents[1]
KW = dict(dim=60, temperature=300, energy_cut=1e8, energy_max=1e20, transform="internal",
          env="vacuum", backend="jax")


@pytest.fixture(scope="module")
def pair():
    return (JAlaDip(**KW, eval_data_path=REPO / "data" / "aladip_eval.npy"),
            AlaDip(**KW, eval_data_path="data/aladip_eval.npy"))


def reference():
    return np.load(REPO / "data" / "position_min_energy.npy").reshape(22, 3).astype(np.float32)


def geometries():
    """The minimum, perturbed structures and degenerate ones: an atom on
    another (the bonded CH3 carbon on its carbonyl carbon, two unbonded
    hydrogens on one point) and three backbone atoms on a line."""
    rng = np.random.default_rng(0)
    ref = reference()
    pert = ref[None] + rng.normal(size=(6, 22, 3)).astype(np.float32) * np.array(
        [0.002, 0.01, 0.03, 0.05, 0.1, 0.2], np.float32)[:, None, None]
    degenerate = np.repeat(ref[None], 3, axis=0)
    degenerate[0, 1] = degenerate[0, 4]
    degenerate[1, 0] = degenerate[1, 19]
    degenerate[2, 8] = 0.5 * (degenerate[2, 6] + degenerate[2, 14])
    return np.concatenate([ref[None], pert, degenerate]).astype(np.float32)


def test_port_data_files_are_the_jax_packages():
    for name in ("position_min_energy.npy", "aladip_eval.npy"):
        assert (DATA_DIR / name).read_bytes() == (REPO / "data" / name).read_bytes(), name


def test_energy_terms_and_total_match_jax():
    pos = geometries()
    got = ff.energy_terms(torch.from_numpy(pos))
    want = jff.energy_terms(jnp.asarray(pos))
    for name in ("bond", "angle", "dihedral", "nb14", "nb"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-3, err_msg=name)
    total = ff.energy_kj(torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(total, np.asarray(jff.energy_kj(jnp.asarray(pos))), rtol=1e-5,
                               atol=1e-3)
    # two unbonded atoms on one point: the Lennard-Jones term overflows to
    # inf on both sides (regularize_energy caps it); every other is finite
    assert total[0] < 0.0 and np.isfinite(np.delete(total, 8)).all() and total[8] == np.inf


def test_energy_gradient_matches_jax():
    pos = geometries()
    x = torch.from_numpy(pos).requires_grad_(True)
    (got,) = torch.autograd.grad(ff.energy_kj(x).sum(), x)
    want = np.asarray(jax.jit(jax.grad(lambda p: jff.energy_kj(p).sum()))(jnp.asarray(pos)))
    got = got.numpy()
    # finite where JAX's is (the overflowing pair of geometry 8 is not)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want).all(axis=(1, 2))
    assert finite.sum() == 9
    got, want = got[finite], want[finite]
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * scale + 1e-2).all()


def test_clip_splits_the_gradient_at_a_tie_as_jax():
    """At cos = 1 - 1e-7 exactly (the angle clip's bound in float32) both
    sides pass half the gradient; torch.clamp would pass all of it."""
    hi = np.float32(1.0 - 1e-7)
    v = np.array([0.5, hi, -hi, 1.0], np.float32)
    x = torch.from_numpy(v).requires_grad_(True)
    (got,) = torch.autograd.grad(ff.clip(x, -1.0 + 1e-7, 1.0 - 1e-7).sum(), x)
    want = jax.grad(lambda c: jnp.clip(c, -1.0 + 1e-7, 1.0 - 1e-7).sum())(jnp.asarray(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1.0, 0.5, 0.5, 0.0]
    (whole,) = torch.autograd.grad(x.clamp(-1.0 + 1e-7, 1.0 - 1e-7).sum(), x)
    assert whole.tolist()[1] == 1.0


def test_regularize_energy_matches_jax_and_its_nan_gradient():
    e = np.array([-50.0, 1e7, 1e8, 3e8, 1e25, np.inf, -np.inf, np.nan], np.float32)
    x = torch.from_numpy(e).requires_grad_(True)
    got = ff.regularize_energy(x, 1e8, 1e20)
    want = jff.regularize_energy(jnp.asarray(e), 1e8, 1e20)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), x)
    jg = np.asarray(jax.grad(lambda v: jff.regularize_energy(v, 1e8, 1e20).sum())(jnp.asarray(e)))
    np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(jg))
    np.testing.assert_allclose(g.numpy()[:5], jg[:5], rtol=1e-6)


def test_transform_both_ways_and_its_logdet_match_jax():
    ref = np.load(REPO / "data" / "position_min_energy.npy").reshape(-1)
    p, j = tf.AlaDipTransform(ref), jtf.AlaDipTransform(ref)
    # the means, float32 from the float64 structure on both sides
    np.testing.assert_allclose(p.mean.numpy(), j.mean, rtol=0, atol=2.4e-7)
    assert p.logdet_norm == j.logdet_norm
    rng = np.random.default_rng(1)
    z = (rng.normal(size=(64, 60)) * np.repeat([0.3, 3.0], 32)[:, None]).astype(np.float32)
    pos, logdet, viol = p.forward_with_penalty(torch.from_numpy(z))
    j_pos, j_logdet, j_viol = j.forward_with_penalty(jnp.asarray(z))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(j_logdet), rtol=1e-5)
    np.testing.assert_allclose(viol.numpy(), np.asarray(j_viol), rtol=1e-5, atol=1e-12)
    # the inverse of in-domain geometries, and the round trip
    inv = p.inverse(pos[:32]).numpy()
    np.testing.assert_allclose(inv, np.asarray(j.inverse(j_pos[:32])), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(inv, z[:32], rtol=0, atol=5e-3)
    # the log-Jacobian's row terms, summed in one reduction, against JAX's
    # own placement-order sum on raw internals
    raw = torch.from_numpy(z[:32]) * p.std + p.mean
    _, got = tf.internal_to_cartesian(raw)
    _, want = jtf.internal_to_cartesian(jnp.asarray(raw.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_clamp_internals_outside_the_domain():
    rng = np.random.default_rng(2)
    kinds = tf.coordinate_kinds()
    z = rng.normal(size=(16, 60)).astype(np.float32) * 4.0
    z[0, kinds == 0] = -0.2   # negative bonds
    z[1, kinds == 1] = 3.5    # angles past pi
    z[2, kinds == 1] = 0.0    # on the lower angle guard's far side
    z[3, kinds == 0] = tf.R_MIN  # exactly on the bound
    got, viol = tf.clamp_internals(torch.from_numpy(z))
    want, j_viol = jtf.clamp_internals(jnp.asarray(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(viol.numpy(), np.asarray(j_viol), rtol=1e-6)
    assert float(viol[3]) == float(j_viol[3])


def test_log_density_and_score_on_all_of_r60_match_jax(pair):
    j, p = pair
    rng = np.random.default_rng(3)
    z = (rng.normal(size=(48, 60)) * np.repeat([0.5, 30.0], 24)[:, None]).astype(np.float32)
    z = np.concatenate([z, np.zeros((1, 60), np.float32)])
    lp = p.unnorm_log_prob(torch.from_numpy(z)).numpy()
    j_lp, j_score = map(np.asarray, jax.jit(lambda v: (j.unnorm_log_prob(v), j.score(v)))(
        jnp.asarray(z)))
    assert lp.shape == j_lp.shape == (49, 1)
    np.testing.assert_array_equal(np.isfinite(lp), np.isfinite(j_lp))
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(lp, j_lp, rtol=1e-5)
    score = p.score(torch.from_numpy(z)).numpy()
    assert np.isfinite(score).all() and np.isfinite(j_score).all()
    scale = np.abs(j_score).max(axis=1, keepdims=True)
    assert (np.abs(score - j_score) <= 1e-4 * scale + 1e-4).all()
    # over any leading batch shape
    torch.testing.assert_close(p.unnorm_log_prob(torch.from_numpy(z[:48]).reshape(6, 8, 60)),
                               torch.from_numpy(lp[:48]).reshape(6, 8, 1))


def test_chirality_filter_matches_jax_at_the_wrap_around(pair):
    j, p = pair
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 60)).astype(np.float32)
    # differences near ±pi and ±2pi, and on the argmin's ties (|raw| = |raw
    # - 2 pi| at raw = pi)
    raw = np.concatenate([np.linspace(-7.0, 7.0, 56),
                          [np.pi, -np.pi, 2 * np.pi - 0.043, -2 * np.pi - 0.043,
                           -0.043 + 0.8, -0.043 - 0.8, 0.0, 2 * np.pi]]).astype(np.float32)
    x[:, 26] = 0.25
    x[:, 17] = raw + np.float32(0.25)
    got = filter_chirality(torch.from_numpy(x)).numpy()
    want = np.asarray(j_filter(jnp.asarray(x)))
    assert got.shape == want.shape == (64, 1) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    # the minimum-energy structure is the L form, its mirror image is not
    ref = reference()
    mirror = ref * np.array([1.0, 1.0, -1.0], np.float32)
    z = p._tf.inverse(torch.from_numpy(np.stack([ref, mirror])))
    assert p.filter(z)[:, 0].tolist() == [True, False]
    np.testing.assert_array_equal(
        p.filter(z).numpy(), np.asarray(j.filter(j._tf.inverse(jnp.asarray(np.stack([ref, mirror]))))))


def test_phi_psi_at_the_minimum(pair):
    j, p = pair
    phi, psi = p.phi_psi(torch.zeros(1, 60))
    assert math.degrees(float(phi[0])) == pytest.approx(-146.0, abs=0.5)
    assert math.degrees(float(psi[0])) == pytest.approx(150.0, abs=0.5)
    rng = np.random.default_rng(5)
    z = (rng.normal(size=(32, 60)) * 0.5).astype(np.float32)
    for got, want in zip(p.phi_psi(torch.from_numpy(z)), j.phi_psi(jnp.asarray(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_eval_set_sampler_and_backends(pair):
    _, p = pair
    g = torch.Generator().manual_seed(0)
    samples = p.sample((100,), generator=g)
    assert samples.shape == (100, 60) and samples.dtype == torch.float32
    data = np.load(REPO / "data" / "aladip_eval.npy")
    idx = torch.randint(0, data.shape[0], (100,), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(samples.numpy(), data[idx.numpy()])
    assert not hasattr(AlaDip(**KW), "sample")  # no eval set, no sampler
    assert AlaDip(**{**KW, "backend": "auto"}).backend == "jax"
    with pytest.raises(ImportError, match="openmm"):
        AlaDip(**{**KW, "backend": "openmm"})
    with pytest.raises(ValueError, match="vacuum"):
        AlaDip(**{**KW, "env": "implicit"})
    # the plots: the Ramachandran histograms of the samples and of the
    # validation set and the 60 marginals against it, as the JAX package's
    # native-backend plots draw them
    j, _ = pair
    z = data[idx.numpy()]
    got, want = p.plots(torch.from_numpy(z)), j._plots_jax(z)
    assert set(got) == set(want) == {"plots/ramachandran_prediction",
                                     "plots/ramachandran_groundtruth", "plots/marginals"}
    for key in ("plots/ramachandran_prediction", "plots/ramachandran_groundtruth"):
        g = np.ma.filled(got[key].axes[0].collections[0].get_array(), 0.0)
        w = np.ma.filled(want[key].axes[0].collections[0].get_array(), 0.0)
        # float32 dihedrals: a point on a bin edge may fall either side
        assert g.shape == w.shape and np.abs(g - w).sum() <= 2 and g.sum() == w.sum()
    for ax_g, ax_w in zip(got["plots/marginals"].axes, want["plots/marginals"].axes):
        np.testing.assert_allclose([b.get_height() for b in ax_g.patches],
                                   [b.get_height() for b in ax_w.patches], rtol=1e-5)
    import matplotlib.pyplot as plt

    plt.close("all")


# the first 16 steps of the config's 200-step grid (dt = 0.005): coarser
# EM steps throw the states out of the domain, where the score of a state
# moves by O(1) with its rounding and the two sides' rollouts part
B, STEPS = 32, 16
TINY = [
    "target=aladip_vacuum", "solver=dis", "loss.method=lv", f"train_batch_size={B}",
    f"train_timesteps.steps={STEPS}", f"train_timesteps.end={STEPS / 200}",
    "plot_results=False", "eval_init=False",
    "store_last_ckpt=False", "n_devices=1", "train_steps=10", "loss.scan_unroll=1",
]


class JitInitBridge(JBridge):
    """The JAX package's DIS solver with its parameter init under one jit
    (the same draws as its eager init, which compiles the force field's
    score op by op for half a minute)."""

    def init_params(self):
        t0, x0 = jnp.zeros(()), jnp.zeros((2, self.target.dim))
        return {"generative_ctrl": jax.jit(self.generative_ctrl.init)(self.next_key(), t0, x0)[
            "params"]}


def test_two_dis_steps_loss_and_gradients_match_jax(tmp_path):
    """Two optimizer steps of the port; before each, its loss and gradients
    against the JAX package's (`_grad_fn`, the train step's loss and
    gradient) at the same parameters, on the JAX key chain's prior samples
    and noise."""
    cfg = compose(REPO / "conf", "base", TINY + [f"out_dir={tmp_path / 'jax'}"])
    js = JitInitBridge(cfg)
    ps = entry.make_solver(TINY + ["device=cpu", f"out_dir={tmp_path / 'port'}"])
    tree = jax.tree_util.tree_map(np.asarray, js.train_state.params)
    load_flax_params(ps.generative_ctrl, tree["generative_ctrl"])
    with torch.no_grad():
        for shadow, p in zip(ps.ema_params, ps.params):
            shadow.copy_(p)
    params = dict(ps.generative_ctrl.named_parameters())
    key = js.train_state.key
    for _ in range(2):
        key, k_loss = jax.random.split(key)
        k_prior, k_noise = jax.random.split(k_loss)
        x0 = js.prior.sample(k_prior, (B,))
        dbs, _ = js.loss._pregen_scan_inputs(k_noise, js.train_ts, x0)
        j_value, j_flat = js._grad_fn(tree, k_loss, js.current_clips())
        leaves = jax.tree_util.tree_leaves(tree)
        splits = np.split(np.asarray(j_flat), np.cumsum([a.size for a in leaves])[:-1])
        j_grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [g.reshape(a.shape) for g, a in zip(splits, leaves)])
        want = flax_to_state_dict(j_grads["generative_ctrl"])
        # the port's loss and gradients on the same inputs, then its step
        x0_t, dbs_t = torch.from_numpy(np.array(x0)), torch.from_numpy(np.array(dbs))
        for p in ps.params:
            p.grad = None
        loss, _ = ps.compute_loss(ps.current_clips(), x0=x0_t, dbs=dbs_t)
        (ps.scale_loss * loss).backward()
        assert float(ps.scale_loss * loss.detach()) == pytest.approx(float(j_value), rel=1e-4)
        for name, p in params.items():
            w = want[name].numpy()
            err = np.abs(p.grad.numpy() - w).max()
            assert err <= 1e-4 * np.abs(w).max() + 1e-7, (name, err, np.abs(w).max())
        metrics = ps.step(x0=x0_t, dbs=dbs_t)
        assert float(metrics["train/loss"]) == pytest.approx(float(j_value), rel=1e-4)
        tree = {"generative_ctrl": convert_state_dict(ps.generative_ctrl.state_dict())}
    assert ps.n_steps == 2 and ps.n_updates == 2 and ps.n_steps_skip == 0


def test_entry_point_cpu_run_of_aladip(tmp_path):
    out = tmp_path / "run"
    args = [a for a in TINY if a != "train_steps=10"]
    solver = entry.main(args + ["device=cpu", "train_steps=2", "eval_batch_size=64",
                                f"out_dir={out}"])
    final = solver.last_metrics
    for key in ("eval/log_norm_const_is", "eval/log_norm_const_lb_ito_finite",
                "eval/effective_sample_size", "error/sinkhorn"):
        assert math.isfinite(final[key]), key
    assert type(solver.target).__module__ == "sde_sampler_torch.distr.aladip"
