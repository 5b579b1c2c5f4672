"""Kernel K1: batched rectangular linear sum assignment (Jonker-Volgenant).

``lsap(cost)`` solves B independent problems ``cost [B, nr, nc]`` (nr <= nc)
exactly and returns row-for-column ``[B, nc]`` int32, with -1 on the nc - nr
columns left free.  It is the counterpart of the JAX package's
``pallas_hungarian_packed`` lane-packed kernel (``_jv_lane_kernel``).

* On a CUDA tensor it launches the hand-written warp-per-problem kernel in
  ``csrc/hungarian_jv.cu`` (built with nvcc for sm_90a on first use, loaded
  with ctypes) or raises.  Problems wider than 31 columns need the JAX
  package's second kernel (``_jv_packed_kernel``), which is not ported yet.
* On a CPU tensor it runs :func:`lsap_plain`, the same algorithm written as
  masked fixed-bound loops vectorised over problems.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

INF = 1.0e18
LSEG = 32  # one warp: the virtual root plus at most 31 columns

_PKG_DIR = Path(__file__).resolve().parents[1]
_SOURCE = _PKG_DIR / "csrc" / "hungarian_jv.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, else ``PATH``, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: kernel K1 (csrc/hungarian_jv.cu) cannot be built")


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/hungarian_jv.cu`` into ``build/torch_kernels`` once per
    source version (the file name carries a hash of the source) and return
    the shared library's path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libhungarian_jv-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_SOURCE}:\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.sedt_jv_lane.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.sedt_jv_lane.restype = ctypes.c_int
    return lib


def lsap(cost: torch.Tensor) -> torch.Tensor:
    """Exact batched LSAP: cost f32 [B, nr, nc] (nr <= nc) -> [B, nc] int32.

    CPU tensors take :func:`lsap_plain`; CUDA tensors launch kernel K1 and
    count the launch in ``lsap.launches``.
    """
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, nr, nc], got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    b, nr, nc = cost.shape
    if nr > nc:
        raise ValueError(f"rectangular solve needs rows <= cols, got {nr} x {nc}")
    if cost.device.type == "cpu":
        return lsap_plain(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    if nc + 1 > LSEG:
        raise NotImplementedError(
            f"nc + 1 = {nc + 1} > {LSEG}: this width needs kernel K2 "
            "(_jv_packed_kernel), which is not ported yet"
        )
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    out = torch.empty((b, nc), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = _library().sedt_jv_lane(cost.data_ptr(), out.data_ptr(), b, nr, nc, stream)
    if err != 0:
        raise RuntimeError(f"kernel K1 launch failed: cudaError {err}")
    lsap.launches += 1
    return out


lsap.launches = 0


def lsap_plain(cost: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1, on any device.

    Same arithmetic as the kernel, over [B, nr+1, nc+1] 1-indexed tensors
    (column 0 is the virtual root).  Inserting row i needs at most i Dijkstra
    expansions and an augmenting path of at most i links, so both inner loops
    run a fixed i steps with per-problem ``active`` / ``walk`` masks that
    freeze problems that finished early.
    """
    b, nr, nc = cost.shape
    dev = cost.device
    a = torch.zeros((b, nr + 1, nc + 1), dtype=torch.float32, device=dev)
    a[:, 1:, 1:] = cost
    cols = torch.arange(nc + 1, device=dev)
    rows = torch.arange(nr + 1, device=dev)
    in_range = cols >= 1
    bidx = torch.arange(b, device=dev)
    u = torch.zeros((b, nr + 1), dtype=torch.float32, device=dev)
    v = torch.zeros((b, nc + 1), dtype=torch.float32, device=dev)
    p = torch.zeros((b, nc + 1), dtype=torch.long, device=dev)  # col -> row, 1-indexed
    pick = lambda t, j: t.gather(1, j[:, None])[:, 0]

    for i in range(1, nr + 1):
        p[:, 0] = i
        minv = torch.full((b, nc + 1), INF, dtype=torch.float32, device=dev)
        used = torch.zeros((b, nc + 1), dtype=torch.bool, device=dev)
        way = torch.zeros((b, nc + 1), dtype=torch.long, device=dev)
        in_tree = torch.zeros((b, nr + 1), dtype=torch.bool, device=dev)
        j0 = torch.zeros((b,), dtype=torch.long, device=dev)
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        for _ in range(i):
            act = active[:, None]
            used = used | (act & (cols == j0[:, None]))
            i0 = pick(p, j0)
            in_tree = in_tree | (act & (rows == i0[:, None]))
            cur = a[bidx, i0] - pick(u, i0)[:, None] - v
            valid = in_range & ~used
            better = act & valid & (cur < minv)
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            # +inf, above any live minv (<= INF): the argmin is a live column
            masked = torch.where(valid, minv, float("inf"))
            delta = masked.min(dim=1).values
            j1 = torch.where(masked <= delta[:, None], cols, nc + 1).min(dim=1).values
            delta = torch.where(active, delta, 0.0)[:, None]
            u = u + delta * in_tree
            v = v - delta * used
            minv = minv - delta * ~used
            j0 = torch.where(active, j1, j0)
            active = active & (pick(p, j0) != 0)
        walk = torch.ones((b,), dtype=torch.bool, device=dev)
        for _ in range(i):
            j1 = pick(way, j0)
            p = torch.where(walk[:, None] & (cols == j0[:, None]), pick(p, j1)[:, None], p)
            j0 = torch.where(walk, j1, j0)
            walk = walk & (j0 != 0)
    return (p[:, 1:] - 1).to(torch.int32)
