"""Weight bridge from the JAX package's flax variable trees to torch.

``from_flax(params, frozen)`` takes the ``params`` and ``frozen`` trees as
nested dicts of numpy arrays and returns a ``state_dict`` for the port's
modules, whose names mirror the flax tree.  Load it with ``strict=True`` so
that a missing or unused key fails.  A gradient tree has the ``params``
tree's layout, so ``from_flax(grads, {})`` maps it onto the port's parameter
names and layouts too.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _param(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax parameter -> (torch name, torch-layout value)."""
    *mod, leaf = path
    if leaf == "kernel" and value.ndim == 4:  # HWIO conv -> OIHW
        return ".".join(mod + ["weight"]), value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return ".".join(mod + ["weight"]), value.T
    if leaf in ("embedding", "scale"):  # nn.Embed, nn.LayerNorm
        return ".".join(mod + ["weight"]), value
    if leaf == "bias":
        return ".".join(mod + ["bias"]), value
    raise KeyError(f"no torch counterpart for flax parameter {'/'.join(path)}")


def from_flax(params: Mapping[str, Any], frozen: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``frozen`` (FrozenBN scale/bias/mean/var) -> state_dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        name, arr = _param(path, np.asarray(value))
        state[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    for path, value in _leaves(frozen):  # FrozenBN buffers keep their names
        state[".".join(path)] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return state
