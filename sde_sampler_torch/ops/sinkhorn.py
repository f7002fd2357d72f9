"""Softmin and transport-cost reductions of the log-domain Sinkhorn loop.

Port of `sde_sampler_tpu/ops/sinkhorn_pallas.py` (`softmin_pallas`,
`transport_cost_pallas`). On a CUDA tensor each wrapper launches its
hand-written kernel (`csrc/sinkhorn.cu`); on a CPU tensor it runs the plain
PyTorch version below. There is no other route and no fallback.

Both versions form the distance by direct differences: the plain version
through `torch.cdist(..., compute_mode="donot_use_mm_for_euclid_dist")`,
never the quadratic form whose cancellation broke the TPU's d = 1 path.

Both kernels split the columns across blocks so that a 100k-row problem
fills the card. The kernel library picks the body by width (d <= 16: rows
held in registers against staged column records; d > 16: the wide body, a
register-blocked tile of 128 rows by 128 columns over k-major copies of
both clouds) and sizes the splits, the rows per block and the scratch
(packed columns, for the wide body also packed rows, and per-split
partials); `softmin_plan` and `transport_plan` read them and the wrappers
allocate the scratch. A launch reports its body, and a wide one counts
once more under "softmin.wide" or "transport.wide".
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sde_sampler_torch.ops import build

ROW_CHUNK = 1024  # rows per dense (ROW_CHUNK, m) tile of the plain versions


class SplitPlan(NamedTuple):
    splits: int
    cols: int  # split s holds columns [s * cols, (s + 1) * cols), the last fewer
    rows: int  # rows per block
    scratch_floats: int


# the body a launch reports: rows in registers (d <= 16) or the wide body
BODY_NAMES = {0: "staged", 1: "wide"}


def _plan(kernel: str, n: int, m: int, d: int) -> SplitPlan:
    splits, cols, rows = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    scratch = getattr(build.library(), f"{kernel}_scratch")
    floats = scratch(n, m, d, ctypes.byref(splits), ctypes.byref(cols), ctypes.byref(rows))
    if floats < 0:
        raise ValueError(f"{kernel} takes no n={n}, m={m}, d={d}")
    return SplitPlan(splits.value, cols.value, rows.value, floats)


def softmin_plan(n: int, m: int, d: int) -> SplitPlan:
    """The softmin kernel's column splits, rows per block and scratch for n
    rows of width d against m columns, as the kernel library sizes them
    (needs the library, so a CUDA build)."""
    return _plan("softmin", n, m, d)


def transport_plan(n: int, m: int, d: int) -> SplitPlan:
    """The transport kernel's column splits and scratch, as `softmin_plan`."""
    return _plan("transport", n, m, d)


def _check(*tensors: torch.Tensor) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.device != device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")


def _dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.cdist(x, y, compute_mode="donot_use_mm_for_euclid_dist")


def softmin_plain(x, y, dual, eps: float, row_chunk: int = ROW_CHUNK):
    """eps * logsumexp_j((-|x_i - y_j| + dual_j)/eps), dense row chunks."""
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], row_chunk):
        z = (-_dist(x[r0 : r0 + row_chunk], y) + dual[None, :]) / eps
        out[r0 : r0 + row_chunk] = eps * torch.logsumexp(z, dim=1)
    return out


def transport_cost_plain(x, y, u, v, eps: float, row_chunk: int = ROW_CHUNK):
    """sum_ij exp((-M_ij + u_i + v_j)/eps) * M_ij, dense row chunks."""
    rows = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], row_chunk):
        m = _dist(x[r0 : r0 + row_chunk], y)
        plan = torch.exp((-m + u[r0 : r0 + row_chunk, None] + v[None, :]) / eps)
        rows[r0 : r0 + row_chunk] = (plan * m).sum(dim=1)
    return rows.sum(dtype=torch.float64).to(x.dtype)


def softmin(x: torch.Tensor, y: torch.Tensor, dual: torch.Tensor, eps: float):
    """(n,) softmin of (n, d) x against (m, d) y with column dual (m,)."""
    _check(x, y, dual)
    if x.device.type == "cpu":
        return softmin_plain(x, y, dual, eps)
    if y.shape[1] != x.shape[1] or dual.shape != (y.shape[0],):
        raise ValueError("shape mismatch between x, y and dual")
    return _softmin_launch(x, y, dual, eps)


def _softmin_launch(x, y, dual, eps: float) -> torch.Tensor:
    """Launch the softmin kernel on checked inputs, with the scratch the
    library sizes; returns the (n,) output."""
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    scratch = torch.empty(softmin_plan(n, m, d).scratch_floats, dtype=torch.float32,
                          device=x.device)
    body = ctypes.c_int(-1)
    code = build.library().softmin_launch(
        x.data_ptr(), y.data_ptr(), dual.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, m, d, float(eps), ctypes.byref(body), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "softmin")
    build.count_launch("softmin", body=BODY_NAMES[body.value])
    return out


def transport_cost(x, y, u, v, eps: float) -> torch.Tensor:
    """Scalar transport cost of the plan exp((-M + u_i + v_j)/eps)."""
    _check(x, y, u, v)
    if x.device.type == "cpu":
        return transport_cost_plain(x, y, u, v, eps)
    n, d = x.shape
    m = y.shape[0]
    if y.shape[1] != d or u.shape != (n,) or v.shape != (m,):
        raise ValueError("shape mismatch between x, y, u and v")
    return _transport_launch(x, y, u, v, eps)


def _transport_launch(x, y, u, v, eps: float) -> torch.Tensor:
    """Launch the transport kernel on checked inputs, with the scratch the
    library sizes; returns the float32 scalar."""
    n, d = x.shape
    m = y.shape[0]
    total = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = torch.empty(transport_plan(n, m, d).scratch_floats, dtype=torch.float32,
                          device=x.device)
    body = ctypes.c_int(-1)
    code = build.library().transport_launch(
        x.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(), total.data_ptr(),
        scratch.data_ptr(), n, m, d, float(eps), ctypes.byref(body),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "transport")
    build.count_launch("transport", body=BODY_NAMES[body.value])
    return total
