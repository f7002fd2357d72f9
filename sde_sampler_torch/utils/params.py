"""Weight carry: JAX-package parameters -> the port's `state_dict`.

The inverse of `convert_state_dict` in `sde_sampler_tpu/utils/torch_import.py`
(a copy of the naming map, not an import). It takes the JAX package's
parameter tree for one control (for example `params["generative_ctrl"]`)
as nested dicts of numpy arrays and returns a flat torch `state_dict`;
`load_solver_params` carries a solver's tree, one subtree per control
(`generative_ctrl`, and a Bridge's `inference_ctrl`), into its modules (a
`params_file` warm start: `load_params_file` reads the pickle that
`scripts/import_torch_ckpt.py` writes);
`nice_params_from_tree` carries a NICE flow's parameter tree (the JAX
package's `init_nice_params` layout, as `distr/nice.py` keeps it):

    flax path                          torch key
    ---------------------------------  --------------------------------
    input_embed.kernel  (in, out)      input_embed.weight  (out, in)
    timestep_embed.timestep_phase      timestep_embed.timestep_phase
    timestep_embed.hidden_K.*          timestep_embed.hidden_layer.K.*
    hidden_K.{kernel,bias}             hidden_layer.K.{weight,bias}
    out.{kernel,bias}                  out_layer.{weight,bias}
    norm_K.{scale,bias}                norm_layer.K.{weight,bias}
    level_L.dense_K.{kernel,bias}      level_net.L.dense_layer.K.{weight,bias}
    level_L.norm_K.{scale,bias}        level_net.L.norm_layer.K.{weight,bias}
"""
from __future__ import annotations

import pickle
import re

import numpy as np
import torch

# flax's indexed submodule names -> the port's module lists
_INDEXED = re.compile(r"^(hidden|norm|dense|level)_(\d+)$")
_LISTS = {"hidden": "hidden_layer", "norm": "norm_layer", "dense": "dense_layer",
          "level": "level_net"}
# flax leaf names -> torch's (a LayerNorm's scale is its weight)
_LEAVES = {"out": "out_layer", "kernel": "weight", "scale": "weight"}


def _rename(parts: list[str]) -> list[str]:
    out: list[str] = []
    for p in parts:
        match = _INDEXED.match(p)
        if match:
            out += [_LISTS[match.group(1)], match.group(2)]
        else:
            out.append(_LEAVES.get(p, p))
    return out


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """Nested flax parameter dict -> flat torch state_dict (float32)."""
    state = {}
    for path, value in _flatten(tree):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if path[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(
                    f"{'.'.join(path)}: expected a 2-D kernel, got {arr.shape}"
                )
            arr = arr.T  # flax (in, out) -> torch (out, in)
        state[".".join(_rename(list(path)))] = torch.from_numpy(
            np.ascontiguousarray(arr)
        )
    return state


def _shapes(state: dict) -> dict:
    return {key: tuple(value.shape) for key, value in sorted(state.items())}


def load_flax_params(module: torch.nn.Module, tree: dict, name: str = "module") -> None:
    """Load a JAX parameter tree into `module`, every key and shape checked
    (a ValueError names both where they differ)."""
    state = flax_to_state_dict(tree)
    model, imported = _shapes(module.state_dict()), _shapes(state)
    if model != imported:
        raise ValueError(
            f"imported {name!r} does not match the model architecture:\n"
            f"  model:    {model}\n  imported: {imported}"
        )
    module.load_state_dict(state, strict=True)


def load_solver_params(modules, params: dict) -> None:
    """Load a JAX solver's parameter tree (`train_state.params`: one subtree
    per control) into the port solver's `modules` of the same names. The
    tree replaces the controls it holds and the others keep their
    parameters, as the JAX package's `merge_params` does; a control the
    solver lacks is refused."""
    extra = sorted(set(params) - set(modules.keys()))
    if extra:
        raise ValueError(
            f"the imported tree has controls {extra} that this solver lacks; it has "
            f"{sorted(modules.keys())}"
        )
    for name, tree in params.items():
        load_flax_params(modules[name], tree, name)


# top-level packages whose classes a params pickle must not name: unpickling
# them would import JAX
_REFUSED = ("jax", "jaxlib", "flax", "optax", "sde_sampler_tpu")


class _ParamsUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"the params file holds {module}.{name}, whose unpickling would import "
                f"{module.split('.')[0]}: the port reads nested dicts of numpy arrays only "
                "(convert the leaves with numpy.asarray before pickling)"
            )
        return super().find_class(module, name)


def load_params_file(path) -> dict:
    """A params pickle (nested dicts of numpy arrays, one subtree per
    control), as `scripts/import_torch_ckpt.py` writes it; refuses one whose
    unpickling would import JAX."""
    with open(path, "rb") as f:
        return _ParamsUnpickler(f).load()


def nice_params_from_tree(tree: dict) -> dict:
    """A NICE flow's JAX parameter tree, `{"couplings": [[{"w": (in, out),
    "b": (out,)}, ...], ...], "scale": (1, d)}` with numpy (or array-like)
    leaves, as float32 torch tensors in the same layout."""
    def tensor(value):
        return torch.from_numpy(np.array(value, dtype=np.float32))

    couplings = [[{"w": tensor(layer["w"]), "b": tensor(layer["b"])} for layer in mlp]
                 for mlp in tree["couplings"]]
    for mlp in couplings:
        for layer in mlp:
            if layer["w"].ndim != 2 or layer["b"].shape != layer["w"].shape[1:]:
                raise ValueError(
                    f"a NICE layer has w {tuple(layer['w'].shape)}, b {tuple(layer['b'].shape)}")
    return {"couplings": couplings, "scale": tensor(tree["scale"])}
