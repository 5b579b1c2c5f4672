"""Kernels K1, K2 and K3: batched linear sum assignment (Jonker-Volgenant).

``lsap(cost)`` solves B independent problems ``cost [B, nr, nc]`` (nr <= nc)
exactly and returns row-for-column ``[B, nc]`` int32, with -1 on the nc - nr
columns left free.  It is the counterpart of the JAX package's
``pallas_hungarian_packed`` and dispatches as that does: kernel K1
(``_jv_lane_kernel``) when nc + 1 <= 32, kernel K2 (``_jv_packed_kernel``) for
wider problems or when ``force_block`` is set.  ``lsap_square(cost [B, n, n])``
is the counterpart of ``pallas_hungarian``: kernel K3 (``_jv_kernel``).

One CUDA kernel, ``jv_warp_kernel<C>`` (one warp per problem, C columns a
lane, no block barrier), serves all three up to 255 columns: K1 at C = 1;
K2 and K3 at C = 2, 4 or 8.  Beyond, K2 and K3 each have a kernel of their
own, chosen from the shape alone: :func:`block_variant` gives ``"warp"``
(nc + 1 <= 256 and a cost block and state of at most 64 KB) or ``"block"``
(one block per problem); :func:`square_variant` gives ``"warp"`` (n <= 126)
or ``"square"`` (one warp per problem with the columns strided over the
lanes and the state in shared memory, any n).

* On a CUDA tensor each wrapper launches its hand-written kernel of
  ``csrc/hungarian_jv.cu`` (built with nvcc for sm_90a on first use, loaded
  with ctypes) or raises, and counts the launch in its ``launches``;
  ``lsap_block`` also counts each variant, in ``launches_warp`` and
  ``launches_block``, and ``lsap_square`` in ``launches_warp`` and
  ``launches_square``.
* On a CPU tensor it runs the kernel's plain PyTorch version:
  :func:`lsap_plain` for K1 and K2, :func:`lsap_square_plain` for K3.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library

INF = 1.0e18
LSEG = 32  # K1: the virtual root plus at most 31 columns, one a lane
MAX_BLOCK = 1024  # one block: the virtual root plus at most 1023 columns
MAX_WARP = 256  # the warp variant of K2 and K3: 32 lanes of at most 8 columns
WARP_SHARED_BYTES = 64 * 1024  # and at most this much cost and state a problem


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("hungarian_jv")
    rect = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    for fn in (lib.sedt_jv_lane, lib.sedt_jv_warp, lib.sedt_jv_block):
        fn.argtypes = rect
        fn.restype = ctypes.c_int
    lib.sedt_jv_square.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.sedt_jv_square.restype = ctypes.c_int
    lib.sedt_jv_init.argtypes = []
    lib.sedt_jv_init.restype = ctypes.c_int
    return lib


@functools.cache
def _device(index: int) -> ctypes.CDLL:
    """The library made ready on device ``index``: shared-memory limits are
    raised and the SM count is read once, not per launch."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.sedt_jv_init()
    if err != 0:
        raise RuntimeError(f"sedt_jv_init failed: cudaError {err}")
    return lib


def _check_cost(cost: torch.Tensor) -> None:
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, nr, nc], got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if cost.shape[1] > cost.shape[2]:
        raise ValueError(f"rectangular solve needs rows <= cols, got "
                         f"{cost.shape[1]} x {cost.shape[2]}")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cost.device}")
    if cost.is_cuda and not cost.is_contiguous():
        raise ValueError("cost must be contiguous")


def _launch(wrapper, name: str, cost: torch.Tensor, *dims: int) -> torch.Tensor:
    """Run the C launcher ``name`` of a wrapper on ``cost`` and count it."""
    out = torch.empty((cost.shape[0], cost.shape[2]), dtype=torch.int32, device=cost.device)
    index = cost.device.index if cost.device.index is not None else torch.cuda.current_device()
    lib = _device(index)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = getattr(lib, name)(cost.data_ptr(), out.data_ptr(), cost.shape[0], *dims, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def lsap_lane(cost: torch.Tensor) -> torch.Tensor:
    """K1: cost f32 [B, nr, nc], nr <= nc <= 31 -> [B, nc] int32; the warp
    kernel at one column a lane."""
    _check_cost(cost)
    _, nr, nc = cost.shape
    if nc + 1 > LSEG:
        raise ValueError(f"nc + 1 = {nc + 1} > {LSEG}: kernel K1 holds one problem in a warp")
    if not cost.is_cuda:
        return lsap_plain(cost)
    return _launch(lsap_lane, "sedt_jv_lane", cost, nr, nc)


def block_variant(nr: int, nc: int) -> str:
    """Which of K2's kernels takes an nr x nc problem: ``"warp"`` while the
    virtual root and the columns fit 32 lanes of 8 and the problem's cost and
    state fit ``WARP_SHARED_BYTES`` of shared memory, else ``"block"``."""
    shared = 4 * (nr * nc + (nr + 1) + 2 * (nc + 1))
    return "warp" if nc + 1 <= MAX_WARP and shared <= WARP_SHARED_BYTES else "block"


def square_variant(n: int) -> str:
    """Which of K3's kernels takes an n x n problem: ``"warp"`` where the
    warp kernel takes it as a rectangle with nr = nc (n <= 126), else
    ``"square"``."""
    return "warp" if block_variant(n, n) == "warp" else "square"


def ordered_key(x) -> np.ndarray:
    """The order-preserving uint32 image of f32 bids that the warp kernel
    hands to the integer warp minimum, mirrored from the kernel: the sign bit
    of a non-negative is set, a negative is complemented, and -0 maps as +0,
    so that ``a < b`` exactly when ``key(a) < key(b)`` for all non-NaN bids."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).copy()
    bits[bits == 0x80000000] = 0
    negative = (bits & 0x80000000) != 0
    return np.where(negative, ~bits, bits | np.uint32(0x80000000)).astype(np.uint32)


def lsap_block(cost: torch.Tensor) -> torch.Tensor:
    """K2: cost f32 [B, nr, nc], nr <= nc <= 1023 -> [B, nc] int32."""
    _check_cost(cost)
    _, nr, nc = cost.shape
    if nc + 1 > MAX_BLOCK:
        raise ValueError(f"nc + 1 = {nc + 1} > {MAX_BLOCK}: kernel K2 holds one problem in "
                         "a block")
    if not cost.is_cuda:
        return lsap_plain(cost)
    variant = block_variant(nr, nc)
    out = _launch(lsap_block, f"sedt_jv_{variant}", cost, nr, nc)
    if variant == "warp":
        lsap_block.launches_warp += 1
    else:
        lsap_block.launches_block += 1
    return out


def lsap_square(cost: torch.Tensor) -> torch.Tensor:
    """K3: cost f32 [B, n, n] -> [B, n] int32, the row of each column."""
    _check_cost(cost)
    _, n, nc = cost.shape
    if n != nc:
        raise ValueError(f"cost must be square, got {n} x {nc}")
    if not cost.is_cuda:
        return lsap_square_plain(cost)
    if square_variant(n) == "warp":
        out = _launch(lsap_square, "sedt_jv_warp", cost, n, n)
        lsap_square.launches_warp += 1
    else:
        out = _launch(lsap_square, "sedt_jv_square", cost, n)
        lsap_square.launches_square += 1
    return out


lsap_lane.launches = 0
lsap_block.launches = 0  # both variants
lsap_block.launches_warp = 0
lsap_block.launches_block = 0
lsap_square.launches = 0  # both variants
lsap_square.launches_warp = 0
lsap_square.launches_square = 0


def lsap(cost: torch.Tensor, force_block: bool = False) -> torch.Tensor:
    """Exact batched LSAP: cost f32 [B, nr, nc] (nr <= nc) -> [B, nc] int32.

    K1 when nc + 1 <= 32, else K2; ``force_block`` pins K2 at any width (the
    JAX function's ``force_sublane``).
    """
    if cost.dim() == 3 and cost.shape[2] + 1 <= LSEG and not force_block:
        return lsap_lane(cost)
    return lsap_block(cost)


def lsap_plain(cost: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1 and K2, on any device.

    It is K2's own formulation in the JAX package (``_jv_packed_kernel``):
    fixed-bound masked loops over a batch of problems.  Same arithmetic as
    the kernels, over [B, nr+1, nc+1] 1-indexed tensors
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


def lsap_square_plain(cost: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3, on any device: the JAX package's
    ``jv_body``, one problem at a time, with its data-dependent loops.  The
    assignment p stays on the host, since only single entries are read."""
    b, n, _ = cost.shape
    dev = cost.device
    n1 = n + 1
    ids = torch.arange(n1, device=dev)
    in_range = ids >= 1
    out = torch.empty((b, n), dtype=torch.int32)
    for bi in range(b):
        a = torch.zeros((n1, n1), dtype=torch.float32, device=dev)
        a[1:, 1:] = cost[bi]
        u = torch.zeros(n1, dtype=torch.float32, device=dev)
        v = torch.zeros(n1, dtype=torch.float32, device=dev)
        p = [0] * n1  # col -> row, 1-indexed
        for i in range(1, n1):
            p[0] = i
            minv = torch.full((n1,), INF, dtype=torch.float32, device=dev)
            used = torch.zeros(n1, dtype=torch.bool, device=dev)
            way = torch.zeros(n1, dtype=torch.long, device=dev)
            row_in_tree = torch.zeros(n1, dtype=torch.bool, device=dev)
            j0 = 0
            while True:
                i0 = p[j0]
                used = used | (ids == j0)
                row_in_tree = row_in_tree | (ids == i0)
                cur = a[i0] - u[i0] - v
                valid = in_range & ~used
                better = valid & (cur < minv)
                minv = torch.where(better, cur, minv)
                way = torch.where(better, j0, way)
                # +inf on dead columns, live bids clamped to INF: a live one wins
                masked = torch.where(valid, minv.clamp(max=INF), float("inf"))
                j1 = int(masked.argmin())  # the first of equal minima
                delta = masked[j1]
                u = u + delta * row_in_tree
                v = v - delta * used
                minv = minv - delta * ~used
                j0 = j1
                if p[j0] == 0:
                    break
            way = way.tolist()
            while j0 != 0:
                j1 = way[j0]
                p[j0] = p[j1]
                j0 = j1
        out[bi] = torch.tensor(p[1:], dtype=torch.int32) - 1
    return out.to(dev)
