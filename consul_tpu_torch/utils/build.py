"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/lib<name>-<hash>.so`` at the repository root, at first
use; the hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Several sources build in
parallel: one nvcc process each, all started together. Nothing here
includes PyTorch's headers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"

#: sm_90a keeps Hopper's wgmma/setmaxnreg available; -fmad=false keeps
#: every f32 step rounded on its own like the plain PyTorch versions;
#: -Xptxas -v reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc failed or is missing; carries the compiler's output."""


def nvcc_path() -> str:
    """The nvcc binary: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" /
                          "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def report_path(name: str) -> pathlib.Path:
    """nvcc's output for the current library, kept beside it."""
    return library_path(name).with_suffix(".nvcc.txt")


def build(names: Iterable[str]) -> dict:
    """Compile every named source that has no current library, all in
    parallel. Returns {name: nvcc's output} for every name (the -Xptxas
    -v register and spill report; for a library built earlier, the
    output kept beside it); raises ``KernelBuildError`` with the
    compiler's output on any failure."""
    names = list(names)
    todo = [n for n in names if not library_path(n).exists()]
    reports = {n: report_path(n).read_text() for n in names
               if n not in todo and report_path(n).exists()}
    if not todo:
        return reports
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
        else:
            report_path(name).write_text(text)
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
