"""Builds the port's CUDA sources into shared libraries, one per source.

Each ``csrc/*.cu`` file has a plain C interface.  ``build_library(name)``
compiles ``csrc/<name>.cu`` with nvcc for sm_90a into ``build/torch_kernels/``
at the root of the checkout, once per source version (the file name carries a
hash of the source, of every header in ``csrc/`` and of the flags), and
``load_library(name)`` opens it with ctypes.  Nothing is built when a module is imported: the wrappers call
``load_library`` where they launch.  A failed build raises; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# every csrc/*.cu: the two kernel sources that the package's wrappers load, and
# a measuring tool that only chip_smoke.py loads
SOURCES = ("hungarian_jv", "flash_attention", "latency_probe")
HEADER_GLOBS = ("*.cuh", "*.h")  # what a source may include from csrc/


def _nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, else ``PATH``, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels (csrc/*.cu) cannot be built")


def source_tag(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, of every header beside it (name and
    content: an edited header must not reuse an old library) and of the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(h for glob in HEADER_GLOBS for h in CSRC_DIR.glob(glob)):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:12]


def build_library(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless this version is already built;
    returns the shared library's path.  ``verbose`` prints what ptxas says
    about each kernel's registers and shared memory."""
    source = CSRC_DIR / f"{name}.cu"
    tag = source_tag(name)
    lib = BUILD_DIR / f"lib{name}-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)  # atomic: concurrent builds never load a partial file
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``; the caller declares argtypes."""
    return ctypes.CDLL(str(build_library(name)))
