"""The multi-process dryrun: each training step of the port at N ranks
against world 1 on the same global batch.

Counterpart of the JAX package's multichip dryrun (``__graft_entry__``'s
five legs).  A leg is a function of one input dict that runs at the current
world (the process group's under its (data x model) layout, or one process
without a group) and returns a result dict; the same call at world 1 is the
reference.  Each leg builds its model whole, loads the whole weights and cuts
them to its model rank's part (``mesh.shard_model``); its results hold the
whole parameters and gradients again (``mesh.full_state_dict``), so a
layout's results compare with world 1's entry by entry.

* ``step``: the supervised train step (plain, ``fine_tune``, ``normalize``,
  and SP-SEDT under a ``self_sup`` config), augment off;
* ``semi``: the mean-teacher step on fixed clean and noisy views, at the
  rank's local ``n_labeled``;
* ``bank``: the feature bank (sharded over the ranks in a group of several)
  gathered at global index batches, checked row for row against the
  dataset, and fed to the supervised step through ``batch_iterator``;
* ``audio_tag``: the audio-tag step.

:func:`spawn` runs :func:`run_legs` on N processes of a fresh group
(``torch.multiprocessing.spawn``; a child's failure raises in the caller)
under one layout, :func:`default_mesh` the JAX dryrun's layout for a world,
:func:`compare` holds a world-N result against world 1, and
:func:`tiny_inputs` makes every leg's inputs at the tiny test config from
seeds.  The root script ``dryrun_multigpu_torch.py`` runs the whole dryrun.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import MeshConfig, SEDTConfig
from ..data.dataset import batch_iterator, collate
from ..data.encoder import BoxEncoder
from ..data.feature_bank import FeatureBank
from ..data.synthetic import SyntheticDataset
from ..engine import Batch, init_train_state, make_semi_train_step, make_teacher, make_train_step
from ..models import AudioTagBackbone, build_model
from ..models.criterion import DenseTargets
from ..ops import hungarian
from ..parallel.optim import make_audio_tag_optimizer
from ..train_lib import AT_CLIP_MAX_NORM, make_audio_tag_step
from . import tensor
from .distribute import (
    all_reduce_sum,
    clear_layout,
    data_group,
    data_rank,
    data_world,
    get_rank,
    get_world_size,
    init_distributed,
    init_layout,
    layout_shape,
    model_rank,
    model_world,
    rank_seed,
)
from .mesh import full_state_dict, local_sizes, share, shard_model, shard_state_dict, wrap_model


# ------------------------------------------------------------------ process group


def spawn(fn: Callable, world: int, args: Sequence, workdir: str, device: str,
          backend: str = "gloo") -> None:
    """``fn(*args)`` on ``world`` processes of a fresh ``backend`` group,
    every rank on ``device`` (``"cuda"``: rank r on ``cuda:r``), rendezvous
    through a ``file://`` store in ``workdir``; returns when every rank has
    ended and raises if one failed (``torch.multiprocessing.spawn``, which
    then ends the others).  On the CPU each child runs one thread."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(os.path.abspath(workdir), f"group_store_{time.time_ns()}")
    mp.spawn(_child, args=(world, store, backend, device, fn, tuple(args)), nprocs=world,
             join=True)


def _child(rank: int, world: int, store: str, backend: str, device: str, fn: Callable,
           args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    elif device == "cuda":  # a card per rank
        device = f"cuda:{rank}"
    init_distributed(backend=backend, device=device, init_method=f"file://{store}", rank=rank,
                     world_size=world)
    fn(*args)
    clear_layout()
    dist.destroy_process_group()


def default_mesh(world: int) -> MeshConfig:
    """The JAX dryrun's layout for ``world`` ranks: two model ranks when the
    world is even and at least 4 (``__graft_entry__.py:132``), the rest on
    the data axis."""
    return MeshConfig(n_model=2 if world % 2 == 0 and world >= 4 else 1)


def run_legs(inputs_path: str, out_dir: str, names: Sequence[str],
             mesh: Optional[MeshConfig] = None) -> None:
    """Run the legs ``names`` on this rank under the layout ``mesh`` (every
    rank on the data axis when None; an input's own ``"mesh"`` wins) with
    the inputs saved at ``inputs_path`` (``{name: input dict}``); each rank
    saves its result of leg ``name`` to ``<out_dir>/<name>_rank<r>.pt``
    (rank 0's with the whole parameters and first-step gradients, the
    others' without)."""
    inputs = torch.load(inputs_path, weights_only=False)
    os.makedirs(out_dir, exist_ok=True)
    laid = None
    for name in names:
        inp = inputs[name]
        want = inp.get("mesh") or mesh or MeshConfig()
        if want != laid:  # a collective: every rank runs the same legs in one order
            init_layout(want)
            laid = want
        res = LEGS[inp["leg"]](inp)
        if get_rank() != 0:
            res = {k: v for k, v in res.items()
                   if k not in ("params", "params1", "grads", "teacher")}
        torch.save(res, os.path.join(out_dir, f"{name}_rank{get_rank()}.pt"))


def load_results(out_dir: str, name: str, world: int) -> List[Dict]:
    """Every rank's result of leg ``name``, rank 0's first."""
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------------ the legs


class exact_math:
    """No TF32 in cuDNN's or cuBLAS's f32 work while a leg runs (world 1 and
    world N then differ only where the batch split does); restores the
    flags after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def _keep_grads(optimizer, model: torch.nn.Module, spec: Dict) -> Dict[str, torch.Tensor]:
    """Make ``optimizer.step`` keep the first update's whole gradients (after
    DDP's mean, before the clip; the cut ones gathered over the model group)
    on the CPU; returns the dict it fills."""
    grads: Dict[str, torch.Tensor] = {}
    real = optimizer.step

    def step():
        if not grads:
            local = {n: p.grad.detach() for n, p in model.named_parameters()
                     if p.grad is not None}
            grads.update({n: g.cpu().clone() for n, g in full_state_dict(local, spec).items()})
        real()

    optimizer.step = step
    return grads


def _global(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The partial metrics summed over the data axis (one collective; the
    ranks of a model group hold the same partial): the global values, as
    numpy."""
    keys = sorted(metrics)
    flat = torch.cat([metrics[k].detach().float().reshape(-1) for k in keys])
    flat = all_reduce_sum(flat).cpu().numpy()
    out, start = {}, 0
    for k in keys:
        n = metrics[k].numel()
        out[k] = flat[start] if metrics[k].dim() == 0 else flat[start:start + n]
        start += n
    return out


def _same_as(flat: torch.Tensor, group, n: int) -> bool:
    """Whether ``flat`` equals the first member's of ``group`` (of ``n``
    ranks) bit for bit (its broadcast; True for one rank or none to hold)."""
    if n == 1 or flat.numel() == 0:
        return True
    ref = flat.clone()
    dist.broadcast(ref, 0 if group is None else dist.get_global_rank(group, 0), group=group)
    return bool(torch.equal(ref, flat))


def _ranks_equal(model: torch.nn.Module) -> Dict[str, bool]:
    """Whether this rank's replicated parameters equal rank 0's and its
    parts of the cut ones equal its model index's on data rank 0, bit for
    bit (two broadcasts; True for one process)."""
    whole, cut = [], []
    for p in model.parameters():
        (cut if getattr(p, "model_shard_dim", None) is not None else whole).append(
            p.detach().reshape(-1))
    flat = lambda ts: torch.cat(ts) if ts else torch.zeros(0)
    return {"replicated": _same_as(flat(whole), None, get_world_size()),
            "cut": _same_as(flat(cut), data_group(), data_world())}


def _device(name: str) -> torch.device:
    """A leg's device: ``name``, a bare ``"cuda"`` being the current card."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allreduce_ms(model: torch.nn.Module, dev: torch.device, reps: int = 3) -> float:
    """ms of one all_reduce over the data group of this rank's trainable
    gradients' bytes, alone (the gradient traffic of a step without DDP's
    overlap with the backward)."""
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    buf = torch.zeros(n, dtype=torch.float32, device=dev)
    dist.all_reduce(buf, group=data_group())
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf, group=data_group())
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _share_batch(batch: Batch, streams: Optional[Sequence[int]]) -> Batch:
    cut = lambda t: None if t is None else share(t, streams)
    return Batch(feats=cut(batch.feats), pad_mask=cut(batch.pad_mask),
                 targets=DenseTargets(*(cut(t) for t in batch.targets)), strong=cut(batch.strong),
                 weak=cut(batch.weak))


def _model(cfg: SEDTConfig, state: Dict, dev: torch.device):
    """The whole model with the whole ``state``, cut to this rank's part of
    the model axis: (model, loss weights, its parameter spec)."""
    model, wd = build_model(cfg, device=dev)
    model.load_state_dict(state)
    return model, wd, shard_model(model)


def _finish(res: Dict, model: torch.nn.Module, dev: torch.device, inp: Dict,
            spec: Dict) -> Dict:
    # after one step the final parameters are the first step's (one copy saved)
    res["params"] = res["params1"] if len(res["loss"]) == 1 else _params(model, spec)
    res["world"] = get_world_size()
    res["layout"] = [data_world(), model_world()]
    res["place"] = [data_rank(), model_rank()]
    res["n_cut"] = sum(dim is not None for dim in spec.values())  # parameters cut over model
    if inp.get("time_allreduce") and data_world() > 1:
        res["allreduce_ms"] = _allreduce_ms(model, dev)
    return res


def _params(model: torch.nn.Module, spec: Dict) -> Dict[str, torch.Tensor]:
    """The whole parameters and buffers on the CPU (a collective over the
    model group)."""
    return {k: v.detach().cpu().clone() for k, v in full_state_dict(model, spec).items()}


class _CollectiveTimer:
    """``parallel.tensor.timer`` on a card: CUDA events around every
    tensor-parallel ``all_reduce``, summed by :meth:`ms` after the step's
    synchronize."""

    def __init__(self):
        self.spans = []

    @contextlib.contextmanager
    def __call__(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.spans.append((start, end))

    def ms(self) -> float:
        total = sum(start.elapsed_time(end) for start, end in self.spans)
        self.spans = []
        return total


def _run_steps(step_fn, model, dev, steps: int, spec: Dict,
               time_collectives: bool = False) -> Dict:
    """``step_fn()`` ``steps`` times: the global metrics of every step, the
    ranks' equality after it (``ranks_equal``; ``replicated_equal`` and
    ``cut_equal`` apart), its seconds, the parameters after the first
    (``params1``) and K1's launches and last shape; with
    ``time_collectives`` each step's ms in the tensor-parallel all_reduces
    (``collective_ms``, a list of a step's calls' sum)."""
    k1 = hungarian.lsap_lane.launches
    res = {"metrics": [], "ranks_equal": [], "replicated_equal": [], "cut_equal": [],
           "step_s": [], "collective_ms": []}
    timer = _CollectiveTimer() if time_collectives else None
    tensor.timer = timer
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        metrics = step_fn()
        _sync(dev)
        res["step_s"].append(time.perf_counter() - t0)
        if timer is not None:
            res["collective_ms"].append(timer.ms())
        res["metrics"].append(_global(metrics))
        equal = _ranks_equal(model)
        res["replicated_equal"].append(equal["replicated"])
        res["cut_equal"].append(equal["cut"])
        res["ranks_equal"].append(equal["replicated"] and equal["cut"])
        if i == 0:
            res["params1"] = _params(model, spec)
    tensor.timer = None
    res["loss"] = [float(m["loss"]) for m in res["metrics"]]
    res["k1"] = hungarian.lsap_lane.launches - k1
    res["k1_shape"] = getattr(hungarian.lsap_lane, "last_shape", None)
    return res


def leg_step(inp: Dict) -> Dict:
    """The supervised (or, under a ``self_sup`` config, SP-SEDT) train step
    on this rank's share of ``inp["batch"]`` (streams ``inp["streams"]``),
    ``inp["steps"]`` times, augment off; ``inp["kind"]`` holds
    ``fine_tune`` / ``normalize``.  The step generator is seeded by data
    rank; ``inp["seed_by"] = "rank"`` seeds it by global rank instead, which
    breaks the model group's lockstep (a check that the lockstep matters)."""
    dev, cfg = _device(inp["device"]), inp["cfg"]
    with exact_math():
        model, wd, spec = _model(cfg, inp["state"], dev)
        state = init_train_state(model, cfg, inp.get("steps_per_epoch", 10))
        grads = _keep_grads(state.optimizer, model, spec)
        step = make_train_step(wrap_model(model, dev), wd, cfg, state.optimizer,
                               augment_on=False, device=dev, **inp.get("kind", {}))
        batch = _share_batch(inp["batch"], inp.get("streams"))
        rank = get_rank() if inp.get("seed_by") == "rank" else None
        gen = torch.Generator(device=dev).manual_seed(rank_seed(inp.get("seed", 0), rank))
        res = _run_steps(lambda: step(batch, gen), model, dev, inp["steps"], spec,
                         inp.get("time_collectives", False))
    res["grads"] = grads
    return _finish(res, model, dev, inp, spec)


def leg_semi(inp: Dict) -> Dict:
    """The mean-teacher step on this rank's share of every stream
    (``inp["streams"]``: strong, weak, unlabeled) of fixed clean and noisy
    views, at its local ``n_labeled``, ``inp["steps"]`` times with the EMA;
    the pseudo counts summed over the ranks."""
    dev, cfg = _device(inp["device"]), inp["cfg"]
    local = local_sizes(inp["streams"], data_world())
    with exact_math():
        model, wd, spec = _model(cfg, inp["state"], dev)
        state = init_train_state(model, cfg, inp.get("steps_per_epoch", 10), schedule="cosine")
        teacher = make_teacher(model)  # cut as the student is
        teacher.load_state_dict(shard_state_dict(inp["teacher"], spec, model_rank(),
                                                 model_world()))
        grads = _keep_grads(state.optimizer, model, spec)
        state = state._replace(model=wrap_model(model, dev))
        step = make_semi_train_step(wd, cfg, n_labeled=local[0] + local[1], device=dev,
                                    **inp.get("kind", {}))
        cut = lambda t: share(t, inp["streams"]).to(dev)
        targets = DenseTargets(*(cut(t) for t in inp["targets"]))
        args = [cut(inp[k]) for k in ("teacher_feats", "student_feats", "pad_mask")]
        flags = [cut(f) for f in inp["flags"]]
        thr = inp["thresholds"].to(dev)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(inp.get("seed", 0)))

        def one():
            metrics, counts = step(state, teacher, *args, targets, *flags, thr, gen, True)
            return dict(metrics, pseudo_counts=counts)

        res = _run_steps(one, model, dev, inp["steps"], spec)
    res["grads"] = grads
    res["teacher"] = _params(teacher, spec)
    return _finish(res, model, dev, inp, spec)


def leg_bank(inp: Dict) -> Dict:
    """The feature bank of the ``inp["clips"]`` seeded clips of seed
    ``inp["clip_seed"]`` (sharded over the data axis in a group of several),
    gathered at every global index
    list of ``inp["indexes"]`` and checked row for row against the
    dataset's features of this rank's share, each gather's seconds kept;
    then, unless ``inp["train"]`` is False, the supervised step on
    ``batch_iterator``'s batches with the bank, as the trainer runs it, the
    lists read as the streams ``inp["streams"]``."""
    dev, cfg = _device(inp["device"]), inp["cfg"]
    ds = _clips(cfg, inp["clips"], inp["clip_seed"])
    with exact_math():
        bank = FeatureBank(ds, dev, shard=get_world_size() > 1)
        equal, gather_s = [], []
        for idx in inp["indexes"]:
            _sync(dev)
            t0 = time.perf_counter()
            got = bank.gather(torch.tensor(idx))
            _sync(dev)
            gather_s.append(time.perf_counter() - t0)
            want = np.stack([ds.features_only(i)[0] for i in share(idx)])[..., None]
            equal.append(bool(np.array_equal(got.cpu().numpy(), want)))
        gathered = dict(bank_equal=equal, gather_s=gather_s, sharded=bank.sharded,
                        world=get_world_size())
        if not inp.get("train", True):
            return gathered
        model, wd, spec = _model(cfg, inp["state"], dev)
        state = init_train_state(model, cfg, len(inp["indexes"]))
        grads = _keep_grads(state.optimizer, model, spec)
        step = make_train_step(wrap_model(model, dev), wd, cfg, state.optimizer,
                               augment_on=False, device=dev)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(inp.get("seed", 0)))
        batches = iter(batch_iterator(ds, inp["indexes"], cfg.model.max_events,
                                      cfg.features.max_len_seconds, bank=bank,
                                      stream_sizes=inp["streams"]))

        def one():
            b = next(batches)
            return step(b._replace(feats=bank.gather(b.indexes), indexes=None), gen)

        res = _run_steps(one, model, dev, len(inp["indexes"]), spec)
    res.update(grads=grads, **gathered)
    return _finish(res, model, dev, inp, spec)


def leg_audio_tag(inp: Dict) -> Dict:
    """The audio-tag step on this rank's contiguous share of ``inp["x"]``,
    ``inp["y"]``, ``inp["steps"]`` times."""
    dev = _device(inp["device"])
    with exact_math():
        model = AudioTagBackbone(*inp["model"], logits_out=True).to(dev).eval()
        model.load_state_dict(inp["state"])
        spec = shard_model(model)  # no transformer: every parameter replicated
        opt = make_audio_tag_optimizer(model, inp["lr"], 100, 10, AT_CLIP_MAX_NORM)
        grads = _keep_grads(opt, model, spec)
        step = make_audio_tag_step(wrap_model(model, dev), opt)
        x, y = share(inp["x"]).to(dev), share(inp["y"]).to(dev)
        res = _run_steps(lambda: {"loss": step(x, y)}, model, dev, inp["steps"], spec)
    res["grads"] = grads
    return _finish(res, model, dev, inp, spec)


LEGS = {"step": leg_step, "semi": leg_semi, "bank": leg_bank, "audio_tag": leg_audio_tag}


# ------------------------------------------------------------------ checks


def pinned_mask(g: np.ndarray, g_got: np.ndarray, eps: float) -> np.ndarray:
    """The entries whose two gradients pin Adam's update, about lr *
    sign(g): the reference gradient at least 1e-6 of its leaf's largest (or
    0 in both), the same sign, and first Adam steps within 1e-4 of each
    other (the single-process step tests' rule)."""
    apart = eps * np.abs(g_got - g) / ((np.abs(g) + eps) * (np.abs(g_got) + eps))
    both_zero = (g == 0) & (g_got == 0)
    return (((np.abs(g) >= 1e-6 * np.abs(g).max()) | both_zero)
            & (np.sign(g) == np.sign(g_got)) & (apart <= 1e-4))


def grad_error(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]):
    """The largest difference of two gradients of one step, leaf by leaf,
    relative to the leaf's largest entry in either, but to no less than
    1e-3 of the largest entry of all (a leaf whose exact gradient is 0,
    as a key projection's bias is under softmax, holds only rounding); and
    the leaf that gives it.  A gradient off by a factor s gives
    |1 - s| / max(1, s) on every leaf above the floor (0.5 when halved or
    doubled).  Raises unless both hold the same leaves."""
    if set(ref) != set(got):
        raise ValueError(f"gradients of different leaves: {sorted(set(ref) ^ set(got))}")
    top = {k: float(torch.maximum(g.abs().max(), got[k].abs().max())) for k, g in ref.items()}
    least = 1e-3 * max(top.values(), default=0.0)
    worst, leaf = 0.0, None
    for name, g in ref.items():
        scale = max(top[name], least)
        err = float((got[name].double() - g.double()).abs().max()) / scale if scale > 0 else 0.0
        if leaf is None or err > worst:
            worst, leaf = err, name
    return worst, leaf


def compare(ref: Dict, got: Sequence[Dict], before: Dict[str, torch.Tensor], lr: float,
            wd: float, loss_rtol: float = 1e-5, later_rtol: float = 1e-3,
            update_tol: float = 1e-3, min_pinned: float = 0.9,
            grad_tol: float = 1e-2) -> Dict:
    """World N (``got``: every rank's result, rank 0's first) against world
    1 (``ref``) of one leg, from the parameters ``before``.

    * ``grad_err``: the first step's gradients (after DDP's mean, before
      the clip) against world 1's, leaf by leaf relative to the leaf's
      largest entry (:func:`grad_error`, ``grad_leaf`` its leaf): the check
      that sees a wrong gradient scale, which neither the loss (summed from
      the partials) nor Adam's first update (about lr * sign(g), after the
      clip) would show;
    * ``loss_rel``: the relative difference of the first step's global
      loss; ``later_rel`` the largest of the later steps' (which start from
      parameters that the first update moved apart where no gradient pins
      them, so a matching may flip);
    * ``update_err``: the largest difference of a parameter after the first
      step, beyond two f32 roundings of it, in units of the lr, on the
      entries that the two gradients pin (:func:`pinned_mask`, eps taken
      before the clip);
    * ``pinned``: the share of entries kept; after the last step every
      entry stays within Adam's bound, steps x 2 lr (1 + wd |p|)
      (``in_bound``);
    * the parameters without gradients and the buffers bit for bit
      (``frozen_equal``), every rank's parameters equal to rank 0's after
      every step (``ranks_equal``);
    * ``ok``: all of them, ``loss_rel`` <= ``loss_rtol``, ``later_rel`` <=
      ``later_rtol``, ``update_err`` <= ``update_tol``, ``pinned`` >
      ``min_pinned`` and ``grad_err`` <= ``grad_tol``.
    """
    g0 = got[0]
    steps = len(ref["loss"])
    grad_err, grad_leaf = grad_error(ref["grads"], g0["grads"])
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(g0["loss"], ref["loss"])]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in ref["grads"].values()))
    eps = 1e-8 / min(1.0, 0.1 / max(norm, 1e-30))
    update_err, n_live, n_all, in_bound = 0.0, 0, 0, True
    for name, g in ref["grads"].items():
        live = pinned_mask(g.numpy(), g0["grads"][name].numpy(), eps)
        p1, w1 = g0["params1"][name].numpy(), ref["params1"][name].numpy()
        if live.any():  # beyond two f32 roundings of the parameter
            beyond = np.abs(p1 - w1) - 2.5e-7 * np.abs(w1)
            update_err = max(update_err, float(beyond[live].max()) / lr)
        p, w = g0["params"][name].numpy(), ref["params"][name].numpy()
        bound = steps * 2 * lr * (1 + wd * np.abs(before[name].numpy())) + 1e-7
        in_bound &= bool((np.abs(p - w) <= bound).all())
        n_live += int(live.sum())
        n_all += live.size
    frozen_equal = all(torch.equal(g0["params"][k], v) for k, v in ref["params"].items()
                       if k not in ref["grads"])
    ranks_equal = all(all(r["ranks_equal"]) for r in got)
    pinned = n_live / max(n_all, 1)
    out = dict(grad_err=grad_err, grad_leaf=grad_leaf, loss_rel=rel[0], later_rel=max(rel[1:], default=0.0), update_err=update_err,
               pinned=pinned, in_bound=in_bound, frozen_equal=frozen_equal,
               ranks_equal=ranks_equal, k1=[r["k1"] for r in got], k1_ref=ref["k1"])
    out["ok"] = bool(out["loss_rel"] <= loss_rtol and out["later_rel"] <= later_rtol
                     and update_err <= update_tol and pinned > min_pinned and in_bound
                     and grad_err <= grad_tol
                     and frozen_equal and ranks_equal)
    return out


# ------------------------------------------------------------------ tiny inputs


def tiny_config(**model_kw) -> SEDTConfig:
    """``SEDTConfig.tiny_test()`` without dropout, with the fine-tune
    stage's alpha 100 (its relaxed matching keeps every candidate, so no
    draw decides anything)."""
    cfg = SEDTConfig.tiny_test()
    return cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0, **model_kw),
                       loss=dataclasses.replace(cfg.loss, epsilon=1.0, alpha=100.0))


def _clips(cfg: SEDTConfig, n: int, seed: int, **kw) -> SyntheticDataset:
    m, sec = cfg.model, cfg.features.max_len_seconds
    enc = BoxEncoder(list(cfg.data.classes), sec, generate_patch=m.self_sup)
    return SyntheticDataset(n, list(cfg.data.classes), m.max_frames, m.n_mels,
                            enc.encode_strong_df, max_events=min(3, m.max_events), seconds=sec,
                            seed=seed, **kw)


def _state(cfg: SEDTConfig, seed: int) -> Dict[str, torch.Tensor]:
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


def tiny_inputs(device: str, batch: int = 8, steps: int = 2, seed: int = 0) -> Dict[str, Dict]:
    """Every leg's inputs at the tiny config, made from ``seed``: global
    batches of ``batch`` seeded clips, the weights drawn by ``build_model``.
    Keys: ``supervised`` (strong | weak, 3:1), ``semi`` (strong | weak |
    unlabeled, 1:1:2; the teacher the student moved by 1 % noise,
    thresholds 0.05), ``bank`` (6 x ``batch`` clips, ``steps`` seeded global
    batches read as two streams, 3:1), ``spsedt`` (3 patches, 6 queries,
    feature reconstruction) and ``audio_tag`` (resnet18, the clips' tags)."""
    cfg = tiny_config()
    n_weak = batch // 4
    items = ([_clips(cfg, batch - n_weak, seed + 1)[i] for i in range(batch - n_weak)]
             + [_clips(cfg, n_weak, seed + 2, weak_only=True)[i] for i in range(n_weak)])
    sup = collate(items, cfg.model.max_events, cfg.features.max_len_seconds)
    sup = sup._replace(strong=torch.arange(batch) < batch - n_weak,
                       weak=torch.arange(batch) >= batch - n_weak)
    state = _state(cfg, seed)
    common = dict(device=device, steps=steps, seed=seed)
    out = {"supervised": dict(common, leg="step", cfg=cfg, state=state, batch=sup,
                              streams=[batch - n_weak, n_weak])}

    q = batch // 4
    semi_items = ([_clips(cfg, q, seed + 3)[i] for i in range(q)]
                  + [_clips(cfg, q, seed + 4, weak_only=True)[i] for i in range(q)]
                  + [_clips(cfg, 2 * q, seed + 5, unlabel=True)[i] for i in range(2 * q)])
    sb = collate(semi_items, cfg.model.max_events, cfg.features.max_len_seconds)
    noisy = sb.feats + torch.from_numpy(
        np.random.RandomState(seed + 6).randn(*sb.feats.shape).astype(np.float32)) * 0.1
    pos = torch.arange(batch)
    noise = np.random.RandomState(seed + 7)
    params = {n for n, _ in build_model(cfg, device="cpu")[0].named_parameters()}
    teacher = {k: v + 0.01 * torch.from_numpy(noise.randn(*v.shape).astype(np.float32))
               * v.abs().mean() if k in params else v for k, v in state.items()}
    out["semi"] = dict(common, leg="semi", cfg=cfg, state=state, teacher=teacher,
                       teacher_feats=sb.feats, student_feats=noisy, pad_mask=sb.pad_mask,
                       targets=sb.targets, streams=[q, q, 2 * q],
                       flags=[pos < q, (pos >= q) & (pos < 2 * q), pos >= 2 * q],
                       thresholds=torch.full((cfg.model.num_classes,), 0.05))

    rng = np.random.RandomState(seed + 8)
    n_bank = 6 * batch
    m = cfg.model
    out["bank"] = dict(common, leg="bank", cfg=cfg, state=state, clips=n_bank,
                       clip_seed=seed + 9, streams=[batch - n_weak, n_weak],
                       indexes=[rng.permutation(n_bank)[:batch].tolist() for _ in range(steps)])

    ss = tiny_config(self_sup=True, dec_at=False, num_queries=6, num_patches=3,
                     feature_recon=True, mask_ratio=0.0)
    ss = ss.replace(train=dataclasses.replace(ss.train, lr_backbone=0.0))
    patch_ds = _clips(ss, batch, seed + 10, unlabel=True, num_patches=3,
                      rng=np.random.RandomState(seed + 11))
    pb = collate([patch_ds[i] for i in range(batch)], ss.model.max_events,
                 ss.features.max_len_seconds)
    pb = pb._replace(strong=torch.ones(batch, dtype=torch.bool))
    out["spsedt"] = dict(common, leg="step", cfg=ss, state=_state(ss, seed), batch=pb,
                         streams=[batch])

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        at = AudioTagBackbone("resnet18", True, "avg", m.num_classes, logits_out=True)
    wb = collate([_clips(cfg, batch, seed + 12)[i] for i in range(batch)], m.max_events,
                 cfg.features.max_len_seconds)
    tags = torch.nn.functional.one_hot(wb.targets.labels.long(), m.num_classes)
    x, y = wb.feats, (tags * wb.targets.label_valid[..., None]).amax(1).float()
    out["audio_tag"] = dict(common, leg="audio_tag", model=("resnet18", True, "avg",
                                                            m.num_classes),
                            state=at.state_dict(), x=x, y=y, lr=1e-4)
    return out


def lr_and_decay(inp: Dict):
    """The (lr, weight decay) of a leg's input: the train config's, or the
    audio-tag step's lr and no decay."""
    if inp["leg"] == "audio_tag":
        return inp["lr"], 0.0
    return inp["cfg"].train.lr, inp["cfg"].train.weight_decay


def run_dryrun(inputs: Dict[str, Dict], world: int, workdir: str, device: str,
               backend: str = "gloo", tolerances: Optional[Dict[str, Dict]] = None,
               mesh: Optional[MeshConfig] = None) -> Dict:
    """Every leg of ``inputs`` at world 1 in this process and at ``world``
    in a spawned group under the layout ``mesh`` (:func:`default_mesh` when
    None; one that does not fill the world raises before any process starts);
    returns each leg's :func:`compare` (with ``tolerances[name]`` where
    given) and its ``layout``, the bank leg's row checks, and the legs' step
    seconds."""
    mesh = mesh or default_mesh(world)
    layout_shape(mesh, world)  # raise before any process starts
    ref = {name: LEGS[inp["leg"]](inp) for name, inp in inputs.items()}
    path = os.path.join(workdir, "dryrun_inputs.pt")
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, path)
    out_dir = os.path.join(workdir, "dryrun_results")
    spawn(run_legs, world, (path, out_dir, list(inputs), mesh), workdir, device=device,
          backend=backend)
    report = {}
    for name, inp in inputs.items():
        got = load_results(out_dir, name, world)
        lr, wd = lr_and_decay(inp)
        report[name] = compare(ref[name], got, inp["state"], lr, wd,
                               **(tolerances or {}).get(name, {}))
        report[name]["step_s"] = got[0]["step_s"]
        report[name]["layout"] = got[0]["layout"]
        if inp["leg"] == "bank":
            bank_ok = all(all(r["bank_equal"]) for r in got) and all(ref[name]["bank_equal"])
            report[name]["bank_equal"] = bank_ok
            report[name]["sharded"] = got[0]["sharded"]
            report[name]["ok"] = report[name]["ok"] and bank_ok and got[0]["sharded"]
        if inp["leg"] == "semi":
            counts_ok = all(np.array_equal(a["pseudo_counts"], b["pseudo_counts"])
                            for a, b in zip(got[0]["metrics"], ref[name]["metrics"]))
            report[name]["counts_equal"] = counts_ok
            report[name]["ok"] = report[name]["ok"] and counts_ok
    return report
