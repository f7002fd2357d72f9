"""Build and load the port's CUDA kernels, and count their launches.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` (one `nvcc` per source,
all started together), linked into one shared library with a plain C
interface, and loaded with `ctypes`. The library is built at first use into
`sde_sampler_torch/_build/` (listed in .gitignore) under a name that hashes
the sources and flags, so an edited source is always rebuilt. Nothing is
compiled or imported when this module is imported: the CPU tests import it.

Each C entry point launches on the caller's stream, allocates nothing and
returns `cudaGetLastError()`; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
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
# control form ("<kernel>.<form>"), so a run shows which instance it took.
LAUNCHES: dict[str, int] = {
    "rollout": 0, "rollout_exp": 0, "softmin": 0, "transport": 0,
}
FORM_LAUNCHES: dict[str, int] = {
    "rollout.lerp": 0, "rollout.score": 0, "rollout_exp.score": 0,
}


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(name: str, form: str | None = None) -> None:
    LAUNCHES[name] += 1
    if form is not None:
        FORM_LAUNCHES[f"{name}.{form}"] += 1


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
    """The kernel library, built from `csrc/` on first use."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path, _sources())
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rollout_launch.argtypes = (
        [ptr] * 11 + [i32] * 5 + [f32] * 5 + [i32, ptr]
    )
    lib.rollout_exp_launch.argtypes = [ptr] * 11 + [i32] * 5 + [f32] * 3 + [ptr]
    lib.softmin_launch.argtypes = [ptr] * 4 + [i32] * 3 + [f32, ptr]
    lib.transport_launch.argtypes = [ptr] * 6 + [i32] * 3 + [f32, ptr]
    for fn in (lib.rollout_launch, lib.rollout_exp_launch, lib.softmin_launch,
               lib.transport_launch):
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {code}")
