"""Build and load the port's CUDA kernels, and count their launches.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one `nvcc` per source,
all started together), linked into one shared library with a plain C
interface, and loaded with `ctypes`. The library is built at first use into
`sde_sampler_torch/_build/` (listed in .gitignore) under a name that hashes
the sources and flags, so an edited source is always rebuilt. The build
holds an exclusive lock on `_build/.lock`, so that processes that start
cold together (the jobs of a multirun) build once: the others wait and load
the library it wrote. Nothing is compiled or imported when this module is
imported: the CPU tests import it.

Each C launch entry point launches on the caller's stream, allocates
nothing and returns `cudaGetLastError()`; `check` raises on a non-zero
code. The kernels' shapes and tiling are decided on the C side: a launch
reports the body it took (`rollout_launch`, which also reports or, asked
`dry`, only computes its plan; `softmin_launch`, `transport_launch`), and
`softmin_scratch` and `transport_scratch` size the scratch that the
Sinkhorn wrappers allocate.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts of the kernel wrappers: each wrapper adds one where it
# launches its kernel, and nowhere else. The rollout kernels also count by
# control form ("<kernel>.<form>") and by form and target
# ("<kernel>.<form>.<target>"), and launches of the any-shape generic body
# once more under "<kernel>.<form>.generic", those of the wide body (a given
# score where the generic body would hold fewer than two blocks an SM:
# d = 196 and up) under "<kernel>.<form>.<target>.wide",
# and those of a per-coordinate score net under "<kernel>.<form>.dim", so a
# run shows which instance it took. A DenseNet's launches (the DenseNet
# body) count under "<kernel>.<form>.<target>.dense" in place of
# "<kernel>.<form>.<target>", and those whose weights stream through its
# ring once more under "<kernel>.<form>.dense.streamed". The Sinkhorn
# kernels count the launches of their wide body (d > 16) once more under
# "<kernel>.wide".
LAUNCHES: dict[str, int] = {
    "rollout": 0, "rollout_exp": 0, "softmin": 0, "transport": 0,
}
# the targets of the forms with a score ("given": a score computed before
# each one-step launch)
_SCORED = ("funnel", "gmm", "wells", "rings", "rosenbrock", "img", "given")
ROLLOUT_INSTANCES = {
    "rollout": {"lerp": _SCORED, "score": _SCORED, "clipped": ("none",),
                "lerp_target": _SCORED, "potential": ("none",), "cancel_drift": _SCORED,
                "lerp_prior": ("none",)},
    "rollout_exp": {"score": _SCORED},
}
# the forms whose instances take a per-coordinate score net: every form
# with a score net
SCORE_DIM_INSTANCES = {"rollout": ("lerp", "score", "lerp_target", "cancel_drift", "lerp_prior"),
                       "rollout_exp": ("score",)}
# the forms without a DenseNet body
NO_DENSE_FORMS = ("potential",)
FORM_LAUNCHES: dict[str, int] = {
    key: 0
    for kernel, forms in ROLLOUT_INSTANCES.items()
    for form, targets in forms.items()
    for key in (f"{kernel}.{form}", f"{kernel}.{form}.generic",
                *(f"{kernel}.{form}.{target}" for target in targets),
                *((f"{kernel}.{form}.given.wide",) if "given" in targets else ()),
                *((f"{kernel}.{form}.dim",) if form in SCORE_DIM_INSTANCES[kernel] else ()),
                *(() if form in NO_DENSE_FORMS else (
                    *(f"{kernel}.{form}.{target}.dense" for target in targets),
                    f"{kernel}.{form}.dense.streamed")))
} | {"softmin.wide": 0, "transport.wide": 0}


# Phase-1 rollouts that took a route other than a kernel: "route.scan"
# counts the calls of `ops/rollout.py::scan_rollout` (one per phase 1 of a
# loss whose step no kernel instance runs), beside the launch counts.
ROUTES: dict[str, int] = {"route.scan": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def count_route(route: str) -> None:
    """One phase-1 rollout through `route` ("scan")."""
    ROUTES[f"route.{route}"] += 1


def count_launch(name: str, form: str | None = None, target: str | None = None,
                 body: str = "fast", per_coord: bool = False) -> None:
    """One launch of kernel `name`, of its `form` and `target`, in `body`
    ("fast", "generic" or "wide", a DenseNet's "dense" or "dense_streamed";
    a Sinkhorn kernel's "staged" or "wide"), with a per-coordinate score net
    or not."""
    LAUNCHES[name] += 1
    if form is None and body == "wide":
        FORM_LAUNCHES[f"{name}.wide"] += 1
    if form is not None:
        FORM_LAUNCHES[f"{name}.{form}"] += 1
        if per_coord:
            FORM_LAUNCHES[f"{name}.{form}.dim"] += 1
        if body in ("dense", "dense_streamed"):
            FORM_LAUNCHES[f"{name}.{form}.{target}.dense"] += 1
            if body == "dense_streamed":
                FORM_LAUNCHES[f"{name}.{form}.dense.streamed"] += 1
            return
        if target is not None:
            FORM_LAUNCHES[f"{name}.{form}.{target}"] += 1
        if body == "generic":
            FORM_LAUNCHES[f"{name}.{form}.generic"] += 1
        elif body == "wide":
            FORM_LAUNCHES[f"{name}.{form}.{target}.wide"] += 1


# the hidden layers of a DenseNet that a launch takes at most
# (csrc/rollout.cuh kDenseMaxLayers)
DENSE_MAX_LAYERS = 8


class RolloutLaunch(ctypes.Structure):
    """The argument of `rollout_launch`, field for field the C structure of
    `csrc/rollout.cu`: the tensors' pointers, the stream, the shapes and
    the table's width and height, the sscore columns; the update (0: kernel
    1, 1: kernel 2), form, target, body asked for, rows a block asked for (0:
    the plan's), `dry` (plan only); the clips and four target
    scalars; out: the body used and the plan (rows a block, blocks, shared
    memory bytes, the wide or streamed body's slice); then the base net (0:
    a FourierMLP, 1: a DenseNet, whose t table goes as `temb`, its packed
    weights as `w_in` and its hidden layers as H), a DenseNet's widths,
    and the lerp forms' prior: its locs and variances, d each."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "x0", "dbs", "tab", "temb", "w_in", "w_hid", "b_hid", "w_out", "b_out", "gmm",
            "xs", "x_T", "stream")]
        + [(name, ctypes.c_int) for name in (
            "B", "D", "C", "H", "T", "K", "tab_w", "tab_h", "score_cols",
            "update", "form", "target", "body", "rows", "dry")]
        + [(name, ctypes.c_float) for name in ("clip_model", "clip_score", "t0", "t1", "t2", "t3")]
        + [(name, ctypes.c_int) for name in (
            "used", "plan_rows", "plan_blocks", "plan_smem", "plan_slice", "net")]
        + [("widths", ctypes.c_int * DENSE_MAX_LAYERS)]
        + [("prior_loc", ctypes.c_void_p), ("prior_var", ctypes.c_void_p)]
    )


# The C entry points' arguments (pointers and the stream as void*, so that
# ctypes does not cut them to 32 bits); each returns a cudaError_t.
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_OUT = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    # one launch (or plan) of kernel 1 or 2
    "rollout_launch": [ctypes.POINTER(RolloutLaunch)],
    # n, m, d; splits, cols, rows per block (out)
    "softmin_scratch": [_I32] * 3 + [_OUT] * 3,
    # x, y, dual, out, scratch; n, m, d; eps; used body; stream
    "softmin_launch": [_PTR] * 5 + [_I32] * 3 + [_F32, _OUT, _PTR],
    # n, m, d; splits, cols, rows per block (out)
    "transport_scratch": [_I32] * 3 + [_OUT] * 3,
    # x, y, u, v, total, scratch; n, m, d; eps; used body; stream
    "transport_launch": [_PTR] * 6 + [_I32] * 3 + [_F32, _OUT, _PTR],
}
RESTYPES = {"softmin_scratch": ctypes.c_longlong, "transport_scratch": ctypes.c_longlong}


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        logs = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        os.replace(tmp_lib, lib_path)
    lib_path.with_suffix(".log").write_text("\n".join(logs))


def library_path() -> Path:
    """Where the library of the current sources lives (its nvcc log, with
    the -Xptxas -v register and spill report, beside it as .log)."""
    return BUILD_DIR / f"libsde_kernels_{_digest(_sources())}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built from `csrc/` on first use (by one process
    at a time: a process that waited for the lock finds the library built)."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if not lib_path.exists():
                _build(lib_path, _sources())
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {code}")
