"""Debug setup hooks (conf/utils/debug.yaml).

Port of `sde_sampler_tpu/utils/debug.py`. The solver instantiates each
entry of the config's `setup` list before anything else. The reference
enables torch's autograd anomaly detection there, which is what
`enable_debug_nans` sets here (JAX's counterpart is `jax_debug_nans`);
eager torch has no jit, so `disable_jit` has nothing to turn off.
"""
from __future__ import annotations

import torch


def enable_debug_nans(mode: bool = True):
    """Autograd anomaly detection: a backward pass that produces nan raises,
    naming the forward operation at fault."""
    torch.autograd.set_detect_anomaly(mode)


def disable_jit(mode: bool = True):
    """A no-op: the port runs eagerly, there is no jit to disable."""
