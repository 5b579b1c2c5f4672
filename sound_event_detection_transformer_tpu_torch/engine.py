"""Training and evaluation steps of the port.

Counterpart of the JAX package's ``engine.py``:

* ``make_train_step``: the supervised step (optional frontend on waveforms,
  augmentation, the forward with dropout, the set criterion with its
  Hungarian matching on kernel K1 or K2, backward, clip, two-group AdamW),
  and with a ``self_sup`` config the SP-SEDT step (the patch crops gathered
  on the device from the target boxes, the patch-query forward, the
  criterion with the feature-reconstruction loss); on one card it replays
  the step as a CUDA graph (:class:`StepGraphs`);
* ``make_eval_step``: the deterministic forward, the set criterion (one joint
  Hungarian solve of the final and aux decoder layers) and the fusion
  post-processing, with the same result dict;
* the mean-teacher step, ``make_semi_train_step``: the EMA teacher's
  pseudo-labels on the device (``get_pseudo_labels``: class-wise
  thresholds, a duration filter, the greedy ``same_class_nms``), one
  forward over the labeled and the student views, one joint Hungarian solve
  of the labeled and pseudo-labeled problems, and the EMA update; with
  ``adjust_threshold``, the host's per-epoch threshold adaptation.

Over several processes each rank runs the step on its share of the global
batch, with its model under ``DistributedDataParallel``
(:func:`.parallel.mesh.wrap_model`).  The criterion sums its denominators
over the ranks, so each rank's loss is its partial of the global loss; the
backward runs on partial x N, so that DDP's mean of the ranks' gradients is
the gradient of the global loss, and the clip sees the global norm: the
step of the JAX package's data-parallel mesh.  The metrics come back as
partials (their sum over the ranks is the global value).  Under a (data x
model) layout (``parallel.distribute.init_layout``) the ranks of one model
group hold one batch shard and the model cut over them
(``parallel.mesh.shard_model``): N above is the data axis' rank count, the
denominators are summed over the data group, DDP runs over the data group,
and each model rank solves its shard's matching problems, as GSPMD
replicates the matcher over ``model``.

The JAX package's frozen-leaf mask (``_frozen_param_mask`` /
``_swap_in_frozen``) becomes ``requires_grad=False`` on the frozen
parameters, which :func:`.parallel.optim.make_optimizer` sets and keeps out
of the optimizer.  The teacher is a second module: a copy of the student
without gradients, whose parameters (the frozen ones too) follow the
student's by the EMA.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .config import SEDTConfig
from .models import postprocess, resolve_device, set_criterion, total_loss
from .models.criterion import DenseTargets, joint_match
from .models.resnet import FOLDS, FrozenBatchNorm
from .ops import augment, hungarian
from .ops.flash_attention import flash_attention
from .ops.matcher import MatchResult
from .ops.patches import extract_patches_device
from .parallel.distribute import all_reduce_sum, data_world
from .parallel.optim import SEDTOptimizer, ema_update, make_optimizer
from .parallel.tensor import same_bits_on_every_rank
from .utils.profiler import annotate


class Batch(NamedTuple):
    feats: torch.Tensor  # [B, T, F, 1]
    pad_mask: torch.Tensor  # [B, T] bool, True = padded
    targets: DenseTargets
    strong: torch.Tensor  # [B] bool
    weak: torch.Tensor  # [B] bool
    indexes: Optional[torch.Tensor] = None  # [B] dataset row ids (eval)


def make_eval_step(
    model: torch.nn.Module,
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    fusion_strategy: Sequence[int],
    device: Optional[torch.device | str] = None,
) -> Callable[[Batch, torch.Tensor], Dict]:
    """Returns ``step(batch, valid)``, with the device it runs on as
    ``step.device``.

    ``valid`` ([B] bool) marks real rows; padded tail rows are excluded from
    the loss masks.  The result holds ``losses`` (the criterion's dict),
    ``at`` (with ``dec_at``) and ``pp_{m}`` (a :class:`PostProcessResult`)
    for each fusion strategy ``m``.  The model's parameters live on
    ``device``; the batch is moved there.  ``weight_dict`` is not read:
    the step returns the raw losses, as the JAX package's does, and the
    caller weights them.
    """
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device != dev:
        raise ValueError(f"model is on {param.device}, eval step on {dev}")
    fusion_strategy = tuple(fusion_strategy)

    @torch.inference_mode()
    def step(batch: Batch, valid: torch.Tensor) -> Dict:
        to = lambda t: t.to(dev, non_blocking=True)
        targets = DenseTargets(*(to(t) for t in batch.targets))
        out = model(to(batch.feats), to(batch.pad_mask))
        losses, _ = set_criterion(
            out, targets, to(batch.strong) & to(valid), None, cfg.model, cfg.loss
        )
        res = {"losses": losses}
        audio_tags = None
        if "at" in out:
            audio_tags = (out["at"] > 0.5).float()
            res["at"] = out["at"]
        for at_m in fusion_strategy:
            res[f"pp_{at_m}"] = postprocess(
                out, targets.orig_size, audio_tags=audio_tags, at_m=at_m
            )
        return res

    step.device = dev
    return step


class TrainState(NamedTuple):
    """The model (parameters and FrozenBN buffers) and its optimizer, which
    counts the steps (``micro_steps``) and the updates (``updates``)."""

    model: torch.nn.Module
    optimizer: SEDTOptimizer


def init_train_state(model: torch.nn.Module, cfg: SEDTConfig, steps_per_epoch: int,
                     schedule: str = "step", fixed_lr: Optional[float] = None) -> TrainState:
    """Freeze the frozen parameters and build the optimizer over the rest."""
    return TrainState(model, make_optimizer(model, cfg.train, steps_per_epoch, schedule,
                                            fixed_lr))


def _apply_augment(cfg: SEDTConfig, feats: torch.Tensor, targets: DenseTargets,
                   strong: torch.Tensor, weak: torch.Tensor,
                   generator: Optional[torch.Generator]):
    """The augmentations ``cfg.augment`` turns on, in the JAX package's order."""
    a = cfg.augment
    if a.mix_up_ratio > 0:
        feats, targets, strong, weak = augment.mixup(
            feats, targets, strong, weak, generator, mix_up_ratio=a.mix_up_ratio,
            alpha=1.0, max_events=cfg.model.max_events)
    if a.time_mask:
        feats = augment.time_mask(feats, generator)
    if a.freq_mask:
        feats = augment.freq_mask(feats, generator)
    if a.freq_shift:
        feats = augment.freq_shift(feats, generator)
    return feats, targets, strong, weak


def _criterion_reduce(world: int) -> Dict:
    """``set_criterion``'s keywords for a group of ``world`` ranks."""
    return {"reduce": all_reduce_sum, "world": world} if world > 1 else {}


def make_loss_fn(model: torch.nn.Module, weight_dict: Dict[str, float], cfg: SEDTConfig,
                 fine_tune: bool = False, normalize: bool = False, fl: bool = False,
                 world: int = 1):
    """``loss_fn(feats, pad_mask, targets, strong, weak, generator,
    patch_boxes=None)`` -> (weighted loss, the criterion's losses): the
    training forward (dropout on; the masks, SP-SEDT's query shuffle and
    keep mask, and the relaxed matching's draws from ``generator``) and the
    set criterion, differentiable with respect to the model's parameters,
    in the spans ``train.forward`` and ``train.criterion``.  With
    ``patch_boxes`` ([B, P, 2]) the patches are cropped from ``feats`` on
    the device and go to an :class:`~.models.SPSEDT`.  With ``world`` > 1
    the losses are this rank's partials."""

    def loss_fn(feats, pad_mask, targets, strong, weak, generator, patch_boxes=None):
        with annotate("train.forward"):
            if patch_boxes is not None:
                patches = extract_patches_device(feats, patch_boxes)
                out = model(feats, pad_mask, patches, deterministic=False, generator=generator)
            else:
                out = model(feats, pad_mask, deterministic=False, generator=generator)
        with annotate("train.criterion"):
            losses, _ = set_criterion(out, targets, strong, weak, cfg.model, cfg.loss,
                                      fine_tune=fine_tune, normalize=normalize, fl=fl,
                                      generator=generator, **_criterion_reduce(world))
            return total_loss(losses, weight_dict), losses

    return loss_fn


# the kernel wrappers whose integer attributes count launches
_COUNTED = (hungarian.lsap_lane, hungarian.lsap_block, hungarian.lsap_square, flash_attention)
_SPLIT_STEP = SEDTOptimizer.step  # advance(), then update()


def _counts() -> Dict[Tuple[Optional[int], str], int]:
    """The Python counters that a step's launches move: each wrapper's
    integer attributes (``lsap_*.launches*``, ``flash_attention.*``) keyed
    (its index in ``_COUNTED``, name), and ``resnet.FOLDS`` keyed (None,
    name)."""
    out = {(i, k): v for i, fn in enumerate(_COUNTED) for k, v in vars(fn).items()
           if type(v) is int}
    out.update({(None, k): v for k, v in FOLDS.items()})
    return out


def _count_deltas(before: Dict) -> Dict:
    return {k: v - before.get(k, 0) for k, v in _counts().items() if v != before.get(k, 0)}


def _add_counts(deltas: Dict) -> None:
    for (i, k), d in deltas.items():
        if i is None:
            FOLDS[k] += d
        else:
            setattr(_COUNTED[i], k, getattr(_COUNTED[i], k) + d)


def graphs_engage(device: torch.device, optimizer) -> bool:
    """Whether a train step on ``device`` with ``optimizer`` replays a CUDA
    graph: on a CUDA device outside any process group (gloo captures
    nothing, and DDP's reducer wants its own warm-up), with a
    :class:`SEDTOptimizer` that updates on every call (``accumulate`` 1) and
    whose ``step`` is its own ``advance`` then ``update``, which the graph
    splits.  A duck-typed optimizer runs eagerly."""
    return (device.type == "cuda" and not (dist.is_available() and dist.is_initialized())
            and isinstance(optimizer, SEDTOptimizer) and optimizer.accumulate == 1
            and getattr(optimizer.step, "__func__", None) is _SPLIT_STEP)


def cuda_capture(run: Callable[[], Dict], generator: Optional[torch.Generator],
                 stream) -> Tuple[object, Dict]:
    """``run()`` captured into a new ``torch.cuda.CUDAGraph`` on ``stream``,
    with ``generator`` registered so that each replay draws on from its
    state, as an eager call would; the capture is thread-local, since the
    prefetch thread pins host memory meanwhile.  Returns (the graph, what
    ``run`` returned: tensors of the graph's pool)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = run()
    return graph, out


class GraphCounts(NamedTuple):
    """A train step's calls: ``captures`` (each replayed once at once),
    ``replays`` (those included) and ``eager`` ones."""

    captures: int
    replays: int
    eager: int

    def since(self, before: "GraphCounts") -> "GraphCounts":
        return GraphCounts(*(a - b for a, b in zip(self, before)))

    def line(self) -> str:
        """The epoch line's part; a replay's launch and fold counts are its
        capture's (:class:`StepGraphs`)."""
        return (f"graph: {self.replays} replays (counted as their capture), {self.captures} "
                f"captures, {self.eager} eager")


class _Graph(NamedTuple):
    graph: object  # a torch.cuda.CUDAGraph
    static: List[torch.Tensor]  # the inputs' buffers, which each replay refills
    outputs: Dict[str, torch.Tensor]
    deltas: Dict  # what one call moved the launch counters by


class StepGraphs:
    """The CUDA graph of one train step, for one input signature (the batch
    tensors' shapes and dtypes, and the generator), and the step's counts of
    its calls (:class:`GraphCounts`).

    ``run(inputs, generator, update)`` is the step's work on device tensors,
    ending in ``update()``.  Engaged (:func:`graphs_engage`), the first call
    of a signature runs eagerly on a side stream: the warm-up, in which
    cuDNN's plans, K1's library, the gradients, AdamW's state and the
    FrozenBN folds come to be.  The second runs ``optimizer.advance`` on the
    host, copies the batch into new static buffers, captures ``run`` with
    ``optimizer.update`` on that stream (:func:`cuda_capture`), and replays
    it.  Every later call runs ``advance``, copies the batch into the
    buffers (nothing inside the graph copies from the host: a pinned batch
    is freed by the prefetcher) and replays; the launch counters then move
    by what the capture moved them, and the span ``train.replay`` stands for
    the inner ``train.*`` spans.  A call of another signature drops the
    graph and warms up again.  The graph holds the gradients, AdamW's state
    and the FrozenBN folds by address: where the gradients, that state or a
    fold are other tensors (a fold rebuilt in another dtype), or a parameter
    or buffer was written outside the step (a load, another step's update),
    since the step's last eager or captured call, the graph is dropped and
    the signature warms up again.  A replay writes the trained parameters
    without moving their version counters, so it drops the folded weights
    of the trained convolutions, which an evaluation may have cached in
    between.  Not engaged, every call runs eagerly on the current stream.

    A replay's outputs are the graph's tensors: the next call overwrites
    them.
    """

    def __init__(self, run: Callable, model: torch.nn.Module, optimizer, device: torch.device,
                 engaged: bool):
        self.run, self.optimizer, self.device, self.engaged = run, optimizer, device, engaged
        self.watched = list(model.parameters()) + list(model.buffers())
        self.folds = [m._fold for m in model.modules() if isinstance(m, FrozenBatchNorm)]
        self.graph: Optional[_Graph] = None
        self.key: Optional[tuple] = None  # the signature of the graph, or of its warm-up
        self.held: Optional[tuple] = None  # what the graph reads and writes outside its pool
        self.trained: List = []  # the folds of the convolutions that the step trains
        self.captures = self.replays = self.eager = 0
        self.stream = None

    def counts(self) -> GraphCounts:
        return GraphCounts(self.captures, self.replays, self.eager)

    def __call__(self, inputs: List[torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        if not self.engaged:
            return self._eager(inputs, generator)
        key = (generator, tuple((tuple(t.shape), t.dtype) for t in inputs))
        if self.graph is not None and key == self.key and self._same(self.held, self._holds()):
            return self._replay(self.graph, inputs)
        if self.graph is None and key == self.key:
            out = self._capture(inputs, generator)
        else:
            self.graph, self.key = None, key
            with self._side_stream():
                out = self._eager(inputs, generator)
        self.held = self._holds()
        # under grad mode the step folds a trained convolution's weight
        # afresh and drops the cached one (``resnet.conv_bn``)
        self.trained = [f for f in self.folds if f.weight is None]
        return out

    def _holds(self) -> tuple:
        opt = self.optimizer
        folds = [t for f in self.folds for t in (f.w, f.b, f.weight)]
        return ([p.grad for p in opt.params] + folds, opt.adamw.state,
                [t._version for t in self.watched])

    @staticmethod
    def _same(a: tuple, b: tuple) -> bool:
        # a tensor that was None at the last eager or captured call is none
        # the graph reads: a trained convolution's fold weight, which the step
        # drops and an evaluation caches
        return (a[1] is b[1] and a[2] == b[2] and len(a[0]) == len(b[0])
                and all(x is y for x, y in zip(a[0], b[0]) if x is not None))

    def _stream(self):
        """The side stream of the warm-ups and captures (None off CUDA)."""
        if self.stream is None and self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
        return self.stream

    @contextlib.contextmanager
    def _side_stream(self):
        side = self._stream()
        if side is None:
            yield
            return
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield
        current.wait_stream(side)

    def _eager(self, inputs, generator) -> Dict[str, torch.Tensor]:
        self.eager += 1
        moved = [t.to(self.device, non_blocking=True) for t in inputs]
        return self.run(moved, generator, self.optimizer.step)

    def _capture(self, inputs, generator) -> Dict[str, torch.Tensor]:
        self.optimizer.advance()
        static = [torch.empty_like(t, device=self.device).copy_(t, non_blocking=True)
                  for t in inputs]
        before = _counts()
        graph, out = cuda_capture(lambda: self.run(static, generator, self.optimizer.update),
                                  generator, self._stream())
        self.graph = _Graph(graph, static, out, _count_deltas(before))
        self.captures += 1
        self.replays += 1
        with annotate("train.replay"):
            graph.replay()
        return out

    def _replay(self, g: _Graph, inputs) -> Dict[str, torch.Tensor]:
        self.optimizer.advance()
        for buf, t in zip(g.static, inputs):
            buf.copy_(t, non_blocking=True)
        with annotate("train.replay"):
            g.graph.replay()
        for fold in self.trained:  # an evaluation's fold of the weights before this update
            fold.drop_weight()
        _add_counts(g.deltas)
        self.replays += 1
        return g.outputs


def make_train_step(
    model: torch.nn.Module,
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    optimizer: SEDTOptimizer,
    fine_tune: bool = False,
    normalize: bool = False,
    fl: bool = False,
    augment_on: bool = True,
    frontend_fn: Optional[Callable] = None,
    device: Optional[torch.device | str] = None,
) -> Callable[[Batch, Optional[torch.Generator]], Dict[str, torch.Tensor]]:
    """The supervised step: ``step(batch, generator) -> metrics``, with the
    device it runs on as ``step.device`` and its :class:`StepGraphs` as
    ``step.graph``.

    The batch is moved to ``device`` (the GPU when None).  With
    ``frontend_fn`` (see :func:`.ops.frontend.make_frontend_fn`),
    ``batch.feats`` carries raw waveforms [B, num_samples] and the step
    featurises them first, with an all-False pad mask.  ``generator`` (on
    ``device``) draws the augmentations, the dropout masks and the relaxed
    matching, in that order (SP-SEDT: the query shuffle and keep mask before
    the dropout masks).  With a ``self_sup`` config the step crops the
    patches on the device from the first ``num_patches`` target boxes of the (augmented) features.  The
    metrics are ``{"loss", **losses}`` as tensors on the device; the step
    makes no host sync.  Its parts run in the spans ``train.augment``,
    ``train.forward``, ``train.criterion``, ``train.backward`` and
    ``train.optimizer`` (:mod:`.utils.profiler`), or ``train.replay``.

    On a CUDA device, with no process group and an optimizer that updates
    on every call (:func:`graphs_engage`), the step from the second call of
    an input signature on is one replayed CUDA graph (:class:`StepGraphs`):
    the same kernels in the same order, the draws following the eager
    sequence; the waveform frontend, which copies its scaler from the host
    on every call, keeps the step eager.  A replayed step's metrics are the
    graph's tensors, good until the next call: use them at once (add them
    up, clone them or read them).

    In a process group, ``model`` is the DDP-wrapped model, the batch is
    this rank's share and the metrics are its partials (module docstring).
    """
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device != dev:
        raise ValueError(f"model is on {param.device}, train step on {dev}")
    world = data_world()
    loss_fn = make_loss_fn(model, weight_dict, cfg, fine_tune, normalize, fl, world)

    def run(inputs: List[torch.Tensor], generator: Optional[torch.Generator],
            update: Callable[[], None]) -> Dict[str, torch.Tensor]:
        feats, pad_mask, strong, weak, *target_parts = inputs
        targets = DenseTargets(*target_parts)
        with torch.enable_grad(), same_bits_on_every_rank():
            if frontend_fn is not None:
                with torch.no_grad():
                    feats = frontend_fn(feats)
                pad_mask = torch.zeros(feats.shape[:2], dtype=torch.bool, device=dev)
            if augment_on:
                with annotate("train.augment"):
                    feats, targets, strong, weak = _apply_augment(cfg, feats, targets, strong,
                                                                  weak, generator)
            boxes = targets.boxes[:, :cfg.model.num_patches] if cfg.model.self_sup else None
            loss, losses = loss_fn(feats, pad_mask, targets, strong, weak, generator, boxes)
            with annotate("train.backward"):
                (loss * world if world > 1 else loss).backward()
        with annotate("train.optimizer"):
            update()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in losses.items()}}

    graphs = StepGraphs(run, model, optimizer, dev,
                        graphs_engage(dev, optimizer) and frontend_fn is None)

    def step(batch: Batch, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        return graphs([batch.feats, batch.pad_mask, batch.strong, batch.weak, *batch.targets],
                      generator)

    step.device = dev
    step.graph = graphs
    return step


# ---------------------------------------------------------------------------
# Semi-supervised mean teacher
# ---------------------------------------------------------------------------


def _rank(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each row's indices by descending score, the invalid entries last; a
    stable sort, so that ties keep the index order (``jnp.argsort``'s)."""
    return torch.sort(-torch.where(valid, scores, -torch.inf), dim=-1, stable=True).indices


def same_class_nms(
    scores: torch.Tensor,  # [B, Q]
    labels: torch.Tensor,  # [B, Q] int
    boxes_cl: torch.Tensor,  # [B, Q, 2] (center, length) normalized
    valid: torch.Tensor,  # [B, Q] bool
) -> torch.Tensor:
    """Greedy same-class overlap suppression by score; returns the keep mask
    [B, Q].  In rank order, a valid candidate is dropped when an earlier
    kept event of its class overlaps it by more than 0.

    The [B, Q, Q] same-class-and-overlap matrix is built once, in rank
    order; then Q sequential steps over a [B, Q] keep tensor, a few
    launches each, with no host sync."""
    order = _rank(scores, valid)
    lab = labels.gather(1, order)
    box = boxes_cl.gather(1, order[..., None].expand(-1, -1, 2))
    s = box[..., 0] - box[..., 1] / 2
    e = box[..., 0] + box[..., 1] / 2
    ov = torch.minimum(e[:, :, None], e[:, None, :]) - torch.maximum(s[:, :, None], s[:, None, :])
    clash = (lab[:, :, None] == lab[:, None, :]) & (ov > 0)  # [B, Q, Q] in rank order
    valid_r = valid.gather(1, order)
    keep_r = torch.zeros_like(valid_r)
    for i in range(scores.shape[1]):
        # only candidates ranked before i can be kept yet
        keep_r[:, i] = valid_r[:, i] & ~(keep_r & clash[:, i]).any(-1)
    return torch.zeros_like(keep_r).scatter_(1, order, keep_r)


def get_pseudo_labels(
    tea_outputs: Dict[str, torch.Tensor],
    classwise_threshold: torch.Tensor,  # [C] f32
    orig_sizes: torch.Tensor,  # [B] seconds
    max_events: int,
) -> Tuple[DenseTargets, torch.Tensor]:
    """The teacher's predictions as dense pseudo targets.

    Audio tags ``at >= threshold`` gate the class scores (fusion strategy
    1); an event is kept when its score reaches its class's threshold, it
    lasts more than 0.2 s and ``same_class_nms`` keeps it.  The kept events
    fill ``max_events`` slots, the highest scores first.  Returns (targets
    with ``ratio`` 1, the kept events per class [C] f32)."""
    at = tea_outputs.get("at")
    audio_tags = (at >= classwise_threshold[None, :]).float() if at is not None else None
    pp = postprocess(tea_outputs, orig_sizes, audio_tags=audio_tags, at_m=1, is_semi=True,
                     threshold=None)
    q = pp.scores.shape[1]
    thr = classwise_threshold[pp.labels.long()]  # [B, Q]
    keep = (pp.scores >= thr) & (pp.boxes[..., 1] > 0.2 / orig_sizes[:, None])
    keep = keep & same_class_nms(pp.scores, pp.labels, pp.boxes, keep)

    m = max_events
    rank = _rank(pp.scores, keep)[:, :min(q, m)]
    pad = m - rank.shape[1]
    labels = F.pad(pp.labels.gather(1, rank), (0, pad))
    boxes = F.pad(pp.boxes.gather(1, rank[..., None].expand(-1, -1, 2)), (0, 0, 0, pad))
    valid = F.pad(keep.gather(1, rank), (0, pad))
    counts = (F.one_hot(labels.long(), classwise_threshold.shape[0]).float()
              * valid[..., None]).sum(dim=(0, 1))
    targets = DenseTargets(
        labels=torch.where(valid, labels, 0),
        boxes=torch.where(valid[..., None], boxes, 0.0),
        box_valid=valid,
        label_valid=valid,
        ratio=torch.ones(valid.shape, dtype=torch.float32, device=valid.device),
        orig_size=orig_sizes,
    )
    return targets, counts


def adjust_threshold(pseudo_counts: np.ndarray, origin_threshold: np.ndarray,
                     true_distribution: np.ndarray) -> np.ndarray:
    """Class-wise thresholds adapted toward the class prior from an epoch's
    pseudo counts, in float64 on the host: clip((share / prior) ** 0.7 *
    origin, 0.45, 0.7); the origin thresholds when nothing was counted."""
    total = pseudo_counts.sum()
    if total <= 0:
        return origin_threshold
    ratio = pseudo_counts / total
    adjust = (ratio / true_distribution) ** 0.7
    return np.clip(adjust * origin_threshold, 0.45, 0.7)


def _rows(out: Dict[str, torch.Tensor], rows: slice) -> Dict[str, torch.Tensor]:
    """The forward's outputs for the clips ``rows``; ``aux_*`` stack the
    decoder layers in front, so their clips are axis 1."""
    return {k: (v[:, rows] if k.startswith("aux_") else v[rows]) for k, v in out.items()}


def _cut(m: MatchResult, rows: slice, axis: int = 0) -> MatchResult:
    return MatchResult(*(x[(slice(None),) * axis + (rows,)] for x in m))


def make_semi_train_step(
    weight_dict: Dict[str, float],
    cfg: SEDTConfig,
    fine_tune: bool = False,
    normalize: bool = False,
    fl: bool = False,
    n_labeled: Optional[int] = None,
    device: Optional[torch.device | str] = None,
) -> Callable:
    """The mean-teacher step: ``step(state, teacher, teacher_feats,
    student_feats, pad_mask, targets, strong, weak, unlabel,
    classwise_threshold, generator, do_ema) -> (metrics, counts)``, with the
    device it runs on as ``step.device``.

    ``state`` is the student's :class:`TrainState`; ``teacher`` the EMA
    model (no gradients, always deterministic).  ``teacher_feats`` are the
    clean views, ``student_feats`` the noisy ones; the batch is labeled
    rows first: with ``n_labeled`` the supervised branch runs on rows
    ``[:n_labeled]`` and the teacher and student on the rest, without it
    every branch runs on the whole batch.  ``classwise_threshold`` ([C] f32
    on the device) sets the pseudo-labels; ``generator`` draws the mixups
    (labeled, then labeled into unlabeled), the dropout masks and the
    relaxed matching, in that order; ``do_ema`` (a host bool) applies
    ``teacher = d * teacher + (1 - d) * student`` to every parameter after
    the update.  One forward runs over the labeled and student views
    together; under plain matching their labeled and pseudo-labeled
    problems share one Hungarian solve, and the two criteria each normalise
    by their own strong rows.  Returns ``{"loss", "sup_*", "unsup_*"}`` and
    the pseudo events per class (zero when no row is unlabeled), as tensors
    on the device; no host sync.

    In a process group the model in ``state`` is the DDP-wrapped student,
    the batch is this rank's share with ``n_labeled`` its local labeled
    rows, the metrics are partials and the counts this rank's (summed over
    the ranks, they are the global counts).  The EMA needs no collective:
    the parameters are the same on every rank.
    """
    dev = resolve_device(device)
    world = data_world()
    red = _criterion_reduce(world)
    a = cfg.augment
    me = cfg.model.max_events
    lab = slice(0, n_labeled) if n_labeled else slice(None)
    unl = slice(n_labeled, None) if n_labeled else slice(None)
    crit_kw = dict(fine_tune=fine_tune, normalize=normalize, fl=fl, **red)

    def step(state: TrainState, teacher: torch.nn.Module, teacher_feats, student_feats,
             pad_mask, targets: DenseTargets, strong, weak, unlabel,
             classwise_threshold: torch.Tensor, generator: Optional[torch.Generator],
             do_ema: bool):
        model, optimizer = state
        to = lambda t: t.to(dev, non_blocking=True)
        teacher_feats, student_feats, pad_mask = map(to, (teacher_feats, student_feats, pad_mask))
        targets = DenseTargets(*(to(t) for t in targets))
        strong, weak, unlabel = map(to, (strong, weak, unlabel))
        pad_lab, pad_unl = pad_mask[lab], pad_mask[unl]

        # the supervised branch's inputs: the clean labeled views, mixed
        feats_l = teacher_feats[lab]
        targets_l = DenseTargets(*(t[lab] for t in targets))
        strong_l, weak_l = strong[lab], weak[lab]
        if a.mix_up_ratio > 0:
            labeled_l = strong_l | weak_l
            feats_l, targets_l, strong_l, weak_l = augment.mixup(
                feats_l, targets_l, strong_l, weak_l, generator, mix_up_ratio=a.mix_up_ratio,
                alpha=1.0, max_events=me)
            # mixup never promotes an unlabeled row into the loss
            strong_l, weak_l = strong_l & labeled_l, weak_l & labeled_l

        # the teacher's pseudo-labels on the clean unlabeled views
        with torch.no_grad():
            tea_out = teacher(teacher_feats[unl], pad_unl, deterministic=True)
            pseudo, counts = get_pseudo_labels(tea_out, classwise_threshold,
                                               targets.orig_size[unl], me)
        unlabel_u = unlabel[unl]
        counts = torch.where(unlabel_u.any(), counts, 0.0)
        student_in = student_feats[unl]
        if a.mix_up_ratio > 0:
            student_in, pseudo = augment.mixup_label_unlabel(
                feats_l, student_in, targets_l, pseudo, generator,
                mix_up_ratio=a.mix_up_ratio, alpha=1.0, max_events=me)

        with torch.enable_grad(), same_bits_on_every_rank():
            n_l = feats_l.shape[0]
            both = model(torch.cat([feats_l, student_in]), torch.cat([pad_lab, pad_unl]),
                         deterministic=False, generator=generator)
            sup_out, st_out = _rows(both, slice(0, n_l)), _rows(both, slice(n_l, None))
            pre_sup = pre_un = None
            if not fine_tune and not normalize:
                # the labeled and pseudo-labeled problems of every decoder
                # layer in one solve, then cut at n_l
                m_all, aux_all = joint_match(
                    both, DenseTargets(*(torch.cat([x, y]) for x, y in zip(targets_l, pseudo))),
                    cfg.loss, fl)
                cut = lambda rows: (_cut(m_all, rows),
                                    None if aux_all is None else _cut(aux_all, rows, axis=1))
                pre_sup, pre_un = cut(slice(0, n_l)), cut(slice(n_l, None))
            sup_losses, _ = set_criterion(sup_out, targets_l, strong_l, weak_l, cfg.model,
                                          cfg.loss, generator=generator, precomputed=pre_sup,
                                          **crit_kw)
            # every unlabeled row is strong against its pseudo boxes
            un_losses, _ = set_criterion(st_out, pseudo, unlabel_u, None, cfg.model, cfg.loss,
                                         generator=generator, precomputed=pre_un, **crit_kw)
            loss = total_loss(sup_losses, weight_dict) + total_loss(un_losses, weight_dict)
            (loss * world if world > 1 else loss).backward()
        optimizer.step()
        if do_ema:
            ema_update(teacher.parameters(), model.parameters(), cfg.train.ema_decay)
        metrics = {"loss": loss.detach()}
        metrics.update({f"sup_{k}": v.detach() for k, v in sup_losses.items()})
        metrics.update({f"unsup_{k}": v.detach() for k, v in un_losses.items()})
        return metrics, counts

    step.device = dev
    return step


def make_teacher(model: torch.nn.Module) -> torch.nn.Module:
    """The EMA teacher: a copy of the student (parameters and FrozenBN
    buffers, on the student's device) without gradients."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher
