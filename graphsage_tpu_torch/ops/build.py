"""Build the CUDA sources under ``csrc/`` into shared libraries and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
for ``sm_90a`` into ``build/kernels/lib<name>.so`` at the root of the
checkout (listed in ``.gitignore``). A library is rebuilt when it is
missing or older than its source or a shared ``csrc/*.cuh`` header,
and is written under a temporary name
and renamed, so concurrent processes never load a half-written file.
Nothing is built when a module is imported: the first kernel launch
builds, or a caller that wants the build time up front calls
:func:`build`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels "
            "build only where the CUDA toolkit is installed"
        )
    return found


def build(name: str) -> tuple[Path, str]:
    """(path of lib<name>.so, compiler output; empty if it was current)."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
