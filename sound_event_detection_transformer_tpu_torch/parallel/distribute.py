"""The process group, its (data x model) layout, rank helpers and the
collectives the trainers use.

Counterpart of the JAX package's ``parallel/distribute.py`` and of the
device grid of its ``make_mesh``.  A run of N processes is a
``torch.distributed`` group: NCCL when each rank has a card of its own, gloo
on the CPU and for several ranks on one card (NCCL refuses two ranks on one
device).  Without a group the world has one member and every collective
here is the identity.

The layout (:func:`init_layout`, a :class:`~..config.MeshConfig`) cuts the
world into ``n_data`` x ``n_model`` ranks, rank ``d * n_model + m`` at data
index d and model index m, and makes two families of groups: the model
group of a data index (its ``n_model`` consecutive ranks, which hold one
batch shard and split the transformer's heads and hidden units) and the
data group of a model index (its ``n_data`` ranks, one per batch shard).
Without a layout the data axis is the whole world and the model axis has
one rank.  A batch shard is held by every rank of its model group, so the
collectives over batch shards (the criterion's denominators, metrics, the
bank, gathers of rows) run over the data group: over the world they would
count every shard ``n_model`` times.

Every helper is one collective, so all ranks of its group must call it in
the same order.  Small host values travel as one tensor on
:func:`comm_device` (the current card under NCCL, the CPU under gloo).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

COLLECTIVE_TIMEOUT_S = 180  # a mismatched collective fails the run after this


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


@dataclass(frozen=True)
class Layout:
    """This rank's place in the (data x model) grid and its two groups."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: Any  # the ranks of this model index; None: the whole world
    model_group: Any  # the ranks of this data index; None: this rank alone


_layout: Optional[Layout] = None


def layout_shape(cfg: MeshConfig, world: int) -> tuple:
    """(n_data, n_model) of ``cfg`` over ``world`` ranks; raises unless the
    two fill the world exactly (``make_mesh`` may leave devices over, a
    process group may not)."""
    n_model = max(1, cfg.n_model)
    n_data = cfg.n_data if cfg.n_data > 0 else world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a layout of {n_data} x {n_model} (data x model) ranks does not fill "
                         f"a world of {world}")
    return n_data, n_model


def init_layout(cfg: MeshConfig = MeshConfig()) -> Layout:
    """Lay the current world out as ``cfg`` says and make its groups (a
    collective: every rank calls it, in the same order as its other group
    calls).  ``n_model`` 1 keeps the world as the data group, so the
    collectives run exactly as without a layout."""
    global _layout
    world, rank = get_world_size(), get_rank()
    n_data, n_model = layout_shape(cfg, world)
    data_group = model_group = None
    if n_model > 1:
        for d in range(n_data):  # every rank makes every group, in one order
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    _layout = Layout(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)
    return _layout


def clear_layout() -> None:
    """Forget the layout (its groups end with the process group)."""
    global _layout
    _layout = None


def data_world() -> int:
    """Ranks on the data axis: the number of batch shards."""
    return _layout.n_data if _layout is not None else get_world_size()


def data_rank() -> int:
    """This rank's batch shard."""
    return _layout.data_rank if _layout is not None else get_rank()


def model_world() -> int:
    """Ranks on the model axis: the parts each sharded projection is cut in."""
    return _layout.n_model if _layout is not None else 1


def model_rank() -> int:
    """This rank's part of each sharded projection."""
    return _layout.model_rank if _layout is not None else 0


def data_group():
    """The group of the ranks that hold this rank's model part, one per batch
    shard (None, torch's default group, when that is the whole world)."""
    return _layout.data_group if _layout is not None else None


def model_group():
    """The group of the ranks that hold this rank's batch shard (None when
    this rank holds its shard alone)."""
    return _layout.model_group if _layout is not None else None


def local_rank() -> int:
    """This process's index on its machine: torchrun's ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(backend: Optional[str] = None, device: Optional[torch.device | str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank``, ``world_size`` and the rendezvous default to torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
    through ``env://``); ``init_method`` (a ``file://`` or ``tcp://`` URL)
    replaces the environment's address.  ``device`` defaults to
    ``cuda:LOCAL_RANK``; an index the machine lacks raises.  ``backend``
    defaults to NCCL for a CUDA device and gloo for the CPU; gloo on CUDA
    tensors is the caller's explicit choice.  A group that exists already is
    kept (its backend must agree), never made twice.
    """
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the group on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist: this machine has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"the {backend} backend is not available in this torch build")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group exists; {backend} was asked for")
        return dev
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def comm_device() -> torch.device:
    """Where a small host value goes for a collective: the current card under
    NCCL (which takes no CPU tensor), else the CPU."""
    if get_world_size() > 1 and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_seed(seed: int, rank: Optional[int] = None) -> int:
    """The seed of a rank's step generator: ``seed`` on data rank 0 (so world
    1 draws what a run without a group draws), a hash of (seed, data rank) on
    the others, so that their dropout masks and draws differ.  The ranks of
    one model group share a seed: their generators stay in lockstep, so the
    replicated activations see one dropout mask and the sharded ones the
    slices of one global mask."""
    rank = data_rank() if rank is None else rank
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` summed over ``group``'s ranks, by default the data group's
    (one rank per batch shard), as a new tensor (the input is kept): the
    global denominators of the criterion.  The identity for one rank."""
    n = data_world() if group is None else dist.get_world_size(group)
    if n == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=data_group() if group is None else group)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (a picklable value): its decisions."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=comm_device())
    return box[0]


def gather_rows(rows: List) -> Optional[List]:
    """Every data rank's ``rows`` (one rank per batch shard) concatenated in
    data-rank order, on rank 0 (None on the others)."""
    if data_world() == 1:
        return list(rows)
    parts: List = [None] * data_world()
    dist.all_gather_object(parts, rows, group=data_group())
    return [r for part in parts for r in part] if is_main_process() else None


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def reduce_dict(input_dict: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Average (or sum) python-scalar metrics over the data ranks (one per
    batch shard) in one ``all_reduce`` of a float64 vector, as the JAX
    package's allgather-sum."""
    world = data_world()
    if world == 1:
        return dict(input_dict)
    names = sorted(input_dict)
    values = torch.tensor([float(input_dict[k]) for k in names], dtype=torch.float64,
                          device=comm_device())
    dist.all_reduce(values, group=data_group())
    if average:
        values /= world
    return dict(zip(names, values.cpu().tolist()))


def get_reduced_loss(loss_dict, weight_dict, metric_logger, prefix: str = "") -> float:
    """Log the scaled and unscaled losses; return the weighted total.  The
    losses are already global (the trainers reduce them once an epoch), so
    they are not reduced again."""
    reduced = {k: float(v) for k, v in loss_dict.items()}
    unscaled = {f"{prefix}{k}_unscaled": v for k, v in reduced.items()}
    scaled = {f"{prefix}{k}": v * weight_dict[k] for k, v in reduced.items() if k in weight_dict}
    if metric_logger is not None:
        metric_logger.update(**unscaled)
        metric_logger.update(**scaled)
    return float(sum(scaled.values()))
