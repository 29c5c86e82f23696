"""Build the port's CUDA sources and load them through ctypes.

Each ``csrc/<name>.cu`` holds kernels with a plain C interface (no PyTorch
headers), compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``accelerate_tpu_torch/_build/`` at first use and loaded with ``ctypes``: a
build of seconds, where one that includes ``torch/extension.h`` takes
minutes. The library's file name carries a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so a stale build is never loaded.
Nothing here runs at import time.

A build or load failure raises; no caller catches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every CUDA source of the port (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        found = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda); "
            "the CUDA kernels of accelerate_tpu_torch are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of its source,
    every shared header (``csrc/*.cuh``, in name order) and the flags: a
    change to a header a source includes never loads a stale build."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together. Returns each compiled source's compiler
    output (``-Xptxas -v`` register and spill report with ``ptxas_info``);
    sources already built map to ``""``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {name: "" for name in names}
    failures = []
    for name, (proc, tmp, out) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
