"""The (data x model) layout of a model and a batch: each data rank's share
of a global batch, the tensor-parallel cut of the transformer's projections
over the model axis, and the model wrapped for the data axis' gradient
all-reduce.

Counterpart of the JAX package's ``parallel/mesh.py``.  Where pjit keeps
one global array and shards it, each rank here holds its part:

* the data axis (:func:`share`): a data rank takes 1/N of every stream of
  the batch (strong | weak | unlabeled), so its local batch keeps the global
  layout; a batch of one stream gives the contiguous chunk, as the JAX
  package's ``host_slice`` does.  ``DistributedDataParallel`` over the data
  group averages the gradients (:func:`wrap_model`);
* the model axis (:data:`TP_RULES`, :func:`param_spec`, :func:`shard_model`):
  the JAX package's ``_TP_RULES`` over the port's parameter names.  The
  FFN's first linear and the q/k/v projections are cut by output rows
  (dim 0 of a torch ``[out, in]`` weight, JAX's ``P(None, model)`` of an
  ``[in, out]`` kernel), the FFN's second linear and ``out_proj`` by input
  columns (dim 1); their biases of the row cut stay whole and are added
  once.  A parameter is cut only where its dim divides by the model ranks,
  as ``param_sharding`` rules.  GSPMD may then cut inside a head; the
  port's attention runs whole heads, so a cut projection whose heads do not
  divide raises.  Everything else is replicated.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .distribute import data_group, data_rank, data_world, model_group, model_rank, model_world

T = TypeVar("T")


def local_sizes(stream_sizes: Sequence[int], world: int) -> List[int]:
    """Each stream's rows on one rank; raises unless every stream divides by
    ``world`` (called before any data is read)."""
    if any(s % world for s in stream_sizes):
        raise ValueError(f"a global batch of streams {list(stream_sizes)} does not divide over "
                         f"{world} processes: every stream must")
    return [s // world for s in stream_sizes]


def share(rows: Sequence[T] | np.ndarray | torch.Tensor,
          stream_sizes: Optional[Sequence[int]] = None, rank: Optional[int] = None,
          world: Optional[int] = None):
    """Rank ``rank``'s share of a global batch (a list, an array or a tensor
    along its first axis): 1/``world`` of each stream, the streams ``stream_sizes``
    laid end to end (one stream, the whole batch, when None).  ``rank`` and
    ``world`` default to the data axis'."""
    rank = data_rank() if rank is None else rank
    world = data_world() if world is None else world
    sizes = [len(rows)] if stream_sizes is None else list(stream_sizes)
    if sum(sizes) != len(rows):
        raise ValueError(f"streams {sizes} do not add up to the batch's {len(rows)} rows")
    if world == 1:
        return rows
    parts, start = [], 0
    for size, per in zip(sizes, local_sizes(sizes, world)):
        parts.append(rows[start + rank * per:start + (rank + 1) * per])
        start += size
    if isinstance(rows, torch.Tensor):
        return torch.cat(parts)
    if isinstance(rows, np.ndarray):
        return np.concatenate(parts)
    return [r for part in parts for r in part]


# (pattern over a parameter name, the dim of a torch weight or bias cut over
# ``model``); the JAX package's _TP_RULES, first match decides
TP_RULES = (
    (re.compile(r"(^|\.)ffn\.linear1\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)ffn\.linear2\.weight$"), 1),
    (re.compile(r"(^|\.)(q|k|v)_proj\.(weight|bias)$"), 0),
    (re.compile(r"(^|\.)out_proj\.weight$"), 1),
)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def param_spec(model: torch.nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """``{parameter name: the dim cut over n_model ranks, or None}``: the
    first rule of :data:`TP_RULES` that names the parameter, where the dim
    divides (nothing is cut at ``n_model`` 1).  Raises for an attention
    whose projections would be cut while its heads do not divide."""
    spec: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        spec[name] = None
        for rule, dim in TP_RULES:
            if rule.search(name):
                if n_model > 1 and p.shape[dim] % n_model == 0:
                    spec[name] = dim
                break
    for name, mod in model.named_modules():
        heads = getattr(mod, "nhead", None)
        if heads is not None and spec.get(_join(name, "q_proj.weight")) is not None \
                and heads % n_model:
            raise ValueError(f"{name}: {heads} heads do not divide over {n_model} model ranks "
                             "(each rank runs whole heads)")
    return spec


def shard_state_dict(full: Mapping[str, torch.Tensor], spec: Mapping[str, Optional[int]],
                     rank: int, n_model: int) -> Dict[str, torch.Tensor]:
    """Model rank ``rank``'s part of a whole ``state_dict`` (or gradient
    dict): the ``rank``-th of ``n_model`` equal slices of every entry that
    ``spec`` cuts, the other entries as they are."""
    out = {}
    for name, t in full.items():
        dim = spec.get(name)
        out[name] = t if dim is None else t.chunk(n_model, dim)[rank].clone()
    return out


def full_state_dict(local: Mapping[str, torch.Tensor] | torch.nn.Module,
                    spec: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The whole tensors of this rank's parts (a dict, or a module's
    ``state_dict``): every cut entry rebuilt over the model group by one
    ``all_reduce`` of a zero-filled whole tensor holding this rank's slice
    (a collective: every rank of the model group calls it with the same
    names), the other entries as they are."""
    if isinstance(local, torch.nn.Module):
        local = local.state_dict()
    n, m = model_world(), model_rank()
    out = {}
    for name, t in local.items():
        dim = spec.get(name)
        if dim is None or n == 1:
            out[name] = t
            continue
        shape = list(t.shape)
        shape[dim] *= n
        whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
        whole.narrow(dim, m * t.shape[dim], t.shape[dim]).copy_(t)
        dist.all_reduce(whole, group=model_group())
        out[name] = whole
    return out


def shard_model(model: torch.nn.Module, n_model: Optional[int] = None,
                rank: Optional[int] = None) -> Dict[str, Optional[int]]:
    """Cut a whole model in place to model rank ``rank``'s part of
    ``n_model`` (by default this rank's of the layout's model axis), and
    return its :func:`param_spec`: each cut parameter becomes its slice
    (``requires_grad`` kept, ``model_shard_dim`` set on it, which the
    optimizer's clip reads), and each attention and FFN whose parameters are
    cut learns its ``model_parts`` and ``model_index``.  The identity at one
    model rank.  Build the optimizer after it."""
    n = model_world() if n_model is None else n_model
    m = model_rank() if rank is None else rank
    spec = param_spec(model, n)
    if n == 1:
        return spec
    for name, mod in model.named_modules():
        if hasattr(mod, "model_parts") and any(
                spec[_join(name, k)] is not None for k, _ in mod.named_parameters()):
            mod.model_parts, mod.model_index = n, m
    for name, p in list(model.named_parameters()):
        dim = spec[name]
        if dim is None:
            continue
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        part = torch.nn.Parameter(p.detach().chunk(n, dim)[m].clone(),
                                  requires_grad=p.requires_grad)
        part.model_shard_dim = dim
        setattr(owner, leaf, part)
    return spec


def wrap_model(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``model`` under ``DistributedDataParallel`` over the data group when a
    process group exists (a group of one too), else ``model`` itself.
    Buffers are not broadcast: the FrozenBN statistics are the same on every
    rank and never change.  Call it after the optimizer froze its
    parameters, which DDP then leaves out."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    kw = {"device_ids": [device.index]} if device.type == "cuda" else {}
    return DistributedDataParallel(model, broadcast_buffers=False, process_group=data_group(),
                                   **kw)
