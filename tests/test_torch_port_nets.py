"""The nets without a kernel body: FeedForward, DenseNet, LevelNet and
MultilevelNet of the port against `sde_sampler_tpu/models/mlp.py`.

JAX's parameters (its init, every leaf moved off its init so that zeroed
last layers and unit LayerNorm scales are compared too) go through the
weight carry (`utils/params.py`); the same numpy inputs go through both
nets, on (B, d) states with a scalar t and on (T, B, d) states with (T, 1, 1)
times (the port's batched phase 2; the JAX side vmaps its scalar-t call over
the steps). Outputs agree to 1e-5 relative of the output's scale: float32 on
both sides, with LayerNorm's mean and variance and the matmuls summed in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sde_sampler_tpu.models import mlp as jmlp
from sde_sampler_torch.models import mlp
from sde_sampler_torch.utils.config import compose
from sde_sampler_torch.utils.params import flax_to_state_dict, load_flax_params

from test_torch_port_models import REPO

D, B, T = 3, 16, 4

# (name, kwargs): a few widths, with and without LayerNorm, each activation
NETS = [
    ("FeedForward", dict(arch=(16, 24))),
    ("FeedForward", dict(arch=(16, 24), use_layernorm=True, activation="silu")),
    ("FeedForward", dict(arch=(8,), use_layernorm=True, activation="elu", dim_out=1)),
    ("DenseNet", dict(arch=(12, 20))),
    ("DenseNet", dict(arch=(10,), activation="tanh")),
    ("LevelNet", dict(dim_embed=8, level=1, activation="sigmoid")),
    ("LevelNet", dict(dim_embed=8, level=2, use_layernorm=True)),
    ("MultilevelNet", dict(factor=2, levels=3)),
    ("MultilevelNet", dict(factor=2, levels=3, use_layernorm=True, activation="relu")),
]


def _pair(name, kwargs):
    j_net = getattr(jmlp, name)(dim=D, **kwargs)
    net = getattr(mlp, name)(dim=D, **kwargs)
    params = j_net.init(jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, D)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(
        tree, [a + 0.3 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])
    load_flax_params(net, jax.tree_util.tree_map(np.asarray, params), name)
    return j_net, net, params


def _out(value):
    """A LevelNet's list of outputs as one array, a net's output as is."""
    if isinstance(value, (list, tuple)):
        return np.concatenate([np.asarray(v) for v in value], axis=-1)
    return np.asarray(value)


@pytest.mark.parametrize("name,kwargs", NETS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(NETS)])
def test_net_matches_jax_after_the_weight_carry(name, kwargs):
    j_net, net, params = _pair(name, kwargs)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    ts = np.linspace(0.1, 0.9, T).astype(np.float32)
    apply = jax.jit(lambda t, xx: j_net.apply({"params": params}, t, xx))
    want = np.stack([_out(apply(jnp.float32(t), jnp.asarray(xk))) for t, xk in zip(ts, x)])
    scale = np.abs(want).max()
    with torch.no_grad():
        for k, t in enumerate(ts):  # (B, d) states, scalar t
            got = _out(net(torch.tensor(t), torch.from_numpy(x[k])))
            np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-5 * scale)
        # (T, B, d) states with (T, 1, 1) times: one call
        got = _out(net(torch.from_numpy(ts).reshape(T, 1, 1), torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_bias_under_layernorm_and_the_carried_names():
    """LevelNet's embedding and inner layers drop their bias under
    LayerNorm, the final projection keeps it (tests/test_solvers.py's
    case); FeedForward's hidden layers likewise. The port's parameter names
    are the carried flax tree's, and its LayerNorm takes flax's epsilon."""
    j_net, net, params = _pair("MultilevelNet", dict(levels=2, use_layernorm=True))
    names = set(net.state_dict())
    assert names == set(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    assert "level_net.1.dense_layer.0.bias" not in names
    assert "level_net.1.dense_layer.1.bias" not in names  # inner
    assert "level_net.1.dense_layer.2.bias" in names  # the final projection
    assert "level_net.1.norm_layer.0.weight" in names
    assert net.level_net[1].norm_layer[0].eps == 1e-6
    plain = mlp.MultilevelNet(dim=3, levels=2)
    assert "level_net.1.dense_layer.0.bias" in plain.state_dict()
    ff = mlp.FeedForward(dim=3, arch=(8, 8), use_layernorm=True)
    assert ff.hidden_layer[0].bias is None and ff.out_layer.bias is not None
    assert set(ff.state_dict()) == set(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jmlp.FeedForward(dim=3, arch=(8, 8), use_layernorm=True).init(
            jax.random.PRNGKey(0), jnp.zeros(()), jnp.zeros((2, 3)))["params"])))


def test_activation_table_and_last_layer_inits_match_jax():
    # the exact GELU's erf rounds differently (up to 5e-7 on these inputs
    # of order 1)
    x = np.linspace(-4.0, 4.0, 101).astype(np.float32)
    assert set(mlp.ACTIVATIONS) == set(jmlp._ACTIVATIONS)
    for name, fn in mlp.ACTIVATIONS.items():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jmlp._ACTIVATIONS[name](jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the configs' last-layer inits go through init_linear_, as FourierMLP's
    g = torch.Generator().manual_seed(0)
    for cls, kw in ((mlp.FeedForward, {}), (mlp.DenseNet, {}), (mlp.MultilevelNet, {})):
        net = cls(dim=D, last_weight_init="zeros", last_bias_init={"constant": 0.5}, **kw)
        net.reset_parameters(g)
        last = net.level_net[0].dense_layer[-1] if cls is mlp.MultilevelNet else net.out_layer
        assert float(last.weight.detach().abs().max()) == 0.0
        assert torch.equal(last.bias, torch.full_like(last.bias, 0.5))
        if cls is not mlp.MultilevelNet:  # (its output adds the finer levels')
            with torch.no_grad():
                out = net(torch.tensor(0.3), torch.randn(5, D, generator=g))
            torch.testing.assert_close(out, torch.full((5, D), 0.5))


def test_densenet_and_multilevel_configs_compose_and_build():
    """conf/model/base/densenet.yaml replaces the generative control's base
    net through `model/base@base_model=densenet` (that package is the one
    of the model configs' defaults entry), and a MultilevelNet through a
    `_target_` override."""
    from sde_sampler_torch.utils.config import instantiate

    cfg = compose(REPO / "conf", overrides=[
        "target=dw_shift", "solver=pis", "model/base@base_model=densenet"])
    base = cfg["generative_ctrl"]["base_model"]
    assert base["_target_"].endswith("mlp.DenseNet") and "num_layers" not in base
    net = instantiate(base)
    assert isinstance(net, mlp.DenseNet) and net.activation == "relu"
    assert [l.out_features for l in net.hidden_layer] == [200, 200]
    cfg = compose(REPO / "conf", overrides=[
        "target=gmm", "solver=pis",
        "generative_ctrl.base_model._target_=sde_sampler_tpu.models.mlp.MultilevelNet",
        "~generative_ctrl.base_model.num_layers", "~generative_ctrl.base_model.channels"])
    net = instantiate(cfg["generative_ctrl"]["base_model"])
    assert isinstance(net, mlp.MultilevelNet) and len(net.level_net) == 4
    assert net.level_net[0].dense_layer[0].out_features == 5 * (2 + 1)
