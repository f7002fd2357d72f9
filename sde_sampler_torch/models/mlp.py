"""Control-network backbones on `nn.Linear`: TimeEmbed, FourierMLP,
FeedForward, DenseNet, LevelNet and MultilevelNet.

Port of the plain branch of `sde_sampler_tpu/models/mlp.py`. Parameter
names follow the reference torch code (`input_embed`, `timestep_phase`,
`hidden_layer.K`, `out_layer`), so reference checkpoints load natively and
`utils/params.py` carries JAX parameters across; the other nets keep the
flax modules' indices (`norm_layer.K`, `dense_layer.K`, `level_net.L`).
LayerNorm takes flax's epsilon, 1e-6, and a layer followed by one has no
bias, as in the JAX package.

`t` is a scalar per step, as in the JAX package: its embedding is computed
once with batch 1 and broadcast over the (B, C) state embedding. A (T,)
vector of step times together with a (T, B, d) state gives a (T, 1, C)
embedding that broadcasts over the batch (the batched phase-2 evaluation).
Every parameter can be re-drawn from an explicit `torch.Generator` with
`reset_parameters`: torch's default init (U(±1/sqrt(fan_in))) and the
configured zero/constant last-layer init.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS: dict[str, Callable] = {
    # exact (erf) GELU, the reference's torch.nn.GELU default
    "gelu": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "sigmoid": torch.sigmoid,
}


def get_activation(name) -> Callable:
    if callable(name):
        return name
    return ACTIVATIONS[name]


def _check_init_spec(spec):
    if spec is None or spec == "zeros":
        return spec
    if hasattr(spec, "get") and spec.get("constant") is not None:
        return spec
    raise ValueError(f"Unknown initializer spec: {spec!r}")


@torch.no_grad()
def init_linear_(
    layer: nn.Linear,
    generator: torch.Generator | None = None,
    weight_spec=None,
    bias_spec=None,
):
    """torch.nn.Linear's default init drawn from `generator`, or the
    configured spec (None, "zeros" or {"constant": value})."""
    bound = 1.0 / math.sqrt(layer.in_features)
    for param, spec in ((layer.weight, weight_spec), (layer.bias, bias_spec)):
        if param is None:  # a layer without bias
            continue
        if spec is None:
            param.copy_(
                torch.empty(param.shape).uniform_(-bound, bound, generator=generator)
            )
        elif spec == "zeros":
            param.zero_()
        else:
            param.fill_(float(spec["constant"]))


def _as_t_column(t, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=torch.float32, device=like.device)
    return t.reshape(-1, 1)


class TimeEmbed(nn.Module):
    """Sinusoidal time features (learned phase) followed by an MLP head."""

    def __init__(
        self,
        dim_out: int,
        num_layers: int = 2,
        channels: int = 64,
        activation: str | Callable = "gelu",
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.dim_out = dim_out
        self.channels = channels
        self.activation = activation
        self.act = get_activation(activation)
        self.last_bias_init = _check_init_spec(last_bias_init)
        self.last_weight_init = _check_init_spec(last_weight_init)
        self.register_buffer(
            "timestep_coeff",
            torch.linspace(0.1, 100, channels).unsqueeze(0),
            persistent=False,
        )
        self.timestep_phase = nn.Parameter(torch.zeros(1, channels))
        self.hidden_layer = nn.ModuleList(
            [nn.Linear(2 * channels, channels)]
            + [nn.Linear(channels, channels) for _ in range(num_layers - 2)]
        )
        self.out_layer = nn.Linear(channels, dim_out)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.timestep_phase.copy_(
            torch.randn(self.timestep_phase.shape, generator=generator)
        )
        for layer in self.hidden_layer:
            init_linear_(layer, generator)
        init_linear_(
            self.out_layer, generator, self.last_weight_init, self.last_bias_init
        )

    def forward(self, t, *args) -> torch.Tensor:
        t = _as_t_column(t, self.timestep_phase)
        angle = self.timestep_coeff * t + self.timestep_phase
        embed = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
        for layer in self.hidden_layer:
            embed = self.act(layer(embed))
        return self.out_layer(embed)


def broadcast_time_rows(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n, C) time rows -> (n, 1, ..., C) so that they broadcast against x.

    For a (B, d) state n is 1 (scalar t); for a (T, B, d) stack of states
    n is T and each step's row broadcasts over its batch.
    """
    return embed.reshape(-1, *([1] * (x.dim() - 2)), embed.shape[-1])


class FourierMLP(nn.Module):
    """Default control backbone: x-embed + t-embed summed, GELU MLP."""

    def __init__(
        self,
        dim: int,
        dim_out: int | None = None,
        num_layers: int = 4,
        channels: int = 64,
        activation: str | Callable = "gelu",
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.dim = dim
        self.channels = channels
        self.activation = activation
        self.act = get_activation(activation)
        self.last_bias_init = _check_init_spec(last_bias_init)
        self.last_weight_init = _check_init_spec(last_weight_init)
        self.input_embed = nn.Linear(dim, channels)
        self.timestep_embed = TimeEmbed(
            dim_out=channels,
            num_layers=2,
            channels=channels,
            activation=activation,
        )
        self.hidden_layer = nn.ModuleList(
            nn.Linear(channels, channels) for _ in range(num_layers - 2)
        )
        self.out_layer = nn.Linear(channels, dim_out or dim)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        # same order as flax's setup: time embedding first
        self.timestep_embed.reset_parameters(generator)
        init_linear_(self.input_embed, generator)
        for layer in self.hidden_layer:
            init_linear_(layer, generator)
        init_linear_(
            self.out_layer, generator, self.last_weight_init, self.last_bias_init
        )

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        embed_t = broadcast_time_rows(self.timestep_embed(t), x)
        embed = self.input_embed(x) + embed_t
        for layer in self.hidden_layer:
            embed = layer(self.act(embed))
        return self.out_layer(self.act(embed))


# flax.linen.LayerNorm's default epsilon (torch's is 1e-5)
LAYERNORM_EPS = 1e-6


def time_column(t, x: torch.Tensor) -> torch.Tensor:
    """t broadcast to x's rows as a (..., 1) column: a scalar t to every
    row, a (T, 1, 1) or (T,) stack of step times to each step's rows of a
    (T, B, d) state."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    return t.reshape(-1, *([1] * (x.dim() - 1))).expand(*x.shape[:-1], 1)


def _reset(modules, generator):
    for module in modules:
        if isinstance(module, nn.LayerNorm):
            module.reset_parameters()
        else:
            init_linear_(module, generator)


class FeedForward(nn.Module):
    """Plain MLP on concat(t, x) with optional LayerNorm after each
    activation (the hidden layers then have no bias)."""

    def __init__(
        self,
        dim: int,
        arch=(64, 64),
        dim_out: int | None = None,
        activation: str | Callable = "gelu",
        use_layernorm: bool = False,
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.dim = dim
        self.activation = activation
        self.act = get_activation(activation)
        self.use_layernorm = use_layernorm
        self.last_bias_init = _check_init_spec(last_bias_init)
        self.last_weight_init = _check_init_spec(last_weight_init)
        widths = [dim + 1, *arch]
        self.hidden_layer = nn.ModuleList(
            nn.Linear(w_in, w_out, bias=not use_layernorm)
            for w_in, w_out in zip(widths[:-1], widths[1:])
        )
        self.norm_layer = nn.ModuleList(
            nn.LayerNorm(w, eps=LAYERNORM_EPS) for w in arch
        ) if use_layernorm else None
        self.out_layer = nn.Linear(widths[-1], dim_out or dim)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _reset(self.hidden_layer, generator)
        if self.norm_layer is not None:
            _reset(self.norm_layer, generator)
        init_linear_(
            self.out_layer, generator, self.last_weight_init, self.last_bias_init
        )

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([time_column(t, x), x], dim=-1)
        for i, layer in enumerate(self.hidden_layer):
            h = self.act(layer(h))
            if self.norm_layer is not None:
                h = self.norm_layer[i](h)
        return self.out_layer(h)


class DenseNet(nn.Module):
    """Densely concatenated MLP on concat(t, x): each layer's activation is
    appended to its input."""

    def __init__(
        self,
        dim: int,
        arch=(200, 200),
        dim_out: int | None = None,
        activation: str | Callable = "relu",
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.dim = dim
        self.activation = activation
        self.act = get_activation(activation)
        self.last_bias_init = _check_init_spec(last_bias_init)
        self.last_weight_init = _check_init_spec(last_weight_init)
        layers, width = [], dim + 1
        for w in arch:
            layers.append(nn.Linear(width, w))
            width += w
        self.hidden_layer = nn.ModuleList(layers)
        self.out_layer = nn.Linear(width, dim_out or dim)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _reset(self.hidden_layer, generator)
        init_linear_(
            self.out_layer, generator, self.last_weight_init, self.last_bias_init
        )

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([time_column(t, x), x], dim=-1)
        for layer in self.hidden_layer:
            h = torch.cat([h, self.act(layer(h))], dim=-1)
        return self.out_layer(h)


class LevelNet(nn.Module):
    """One level of the multilevel net: an embedding and 2**level inner
    layers, each after an optional LayerNorm and the activation, adding the
    coarser level's residual of the same index. Under LayerNorm the
    embedding and the inner layers have no bias; the final projection keeps
    it. Returns the outputs of the odd layers (every layer's at level 0)."""

    def __init__(
        self,
        dim: int,
        dim_embed: int,
        level: int,
        dim_out: int | None = None,
        activation: str | Callable = "gelu",
        use_layernorm: bool = False,
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.level = level
        self.act = get_activation(activation)
        self.last_bias_init = _check_init_spec(last_bias_init)
        self.last_weight_init = _check_init_spec(last_weight_init)
        n_inner = 2**level
        bias = not use_layernorm
        self.dense_layer = nn.ModuleList(
            [nn.Linear(dim + 1, dim_embed, bias=bias)]
            + [nn.Linear(dim_embed, dim_embed, bias=bias) for _ in range(n_inner - 1)]
            + [nn.Linear(dim_embed, dim_out or dim)]
        )
        self.norm_layer = nn.ModuleList(
            nn.LayerNorm(dim_embed, eps=LAYERNORM_EPS) for _ in range(n_inner)
        ) if use_layernorm else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _reset(self.dense_layer[:-1], generator)
        if self.norm_layer is not None:
            _reset(self.norm_layer, generator)
        init_linear_(
            self.dense_layer[-1], generator, self.last_weight_init, self.last_bias_init
        )

    def forward(self, t, x: torch.Tensor, res_tensors=None) -> list[torch.Tensor]:
        h = self.dense_layer[0](torch.cat([time_column(t, x), x], dim=-1))
        out = []
        for i, layer in enumerate(self.dense_layer[1:]):
            if self.norm_layer is not None:
                h = self.norm_layer[i](h)
            h = layer(self.act(h))
            if res_tensors is not None:
                h = h + res_tensors[i]
            if i % 2 or self.level == 0:
                out.append(h)
        return out


class MultilevelNet(nn.Module):
    """Multilevel residual net: levels from the finest (2**(levels-1) inner
    layers) to the coarsest (one), each fed the finer level's outputs as
    residuals; the coarsest level's last output is the net's."""

    def __init__(
        self,
        dim: int,
        dim_out: int | None = None,
        factor: int = 5,
        levels: int = 4,
        activation: str | Callable = "gelu",
        use_layernorm: bool = False,
        last_bias_init=None,
        last_weight_init=None,
    ):
        super().__init__()
        self.dim = dim
        self.activation = activation
        self.level_net = nn.ModuleList(
            LevelNet(
                dim=dim, dim_embed=factor * (dim + 1), level=level, dim_out=dim_out,
                activation=activation, use_layernorm=use_layernorm,
                last_bias_init=last_bias_init, last_weight_init=last_weight_init,
            )
            for level in range(levels)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for net in reversed(self.level_net):  # flax's order: the finest first
            net.reset_parameters(generator)

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        res_tensors = None
        for net in reversed(self.level_net):
            res_tensors = net(t, x, res_tensors)
        return res_tensors[-1]
