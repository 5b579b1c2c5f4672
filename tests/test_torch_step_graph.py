"""The train step's CUDA graphs (``engine.StepGraphs``) and the optimizer's
two parts (``SEDTOptimizer.advance`` on the host, ``update`` on the device),
on the CPU.

* The split step, its lr a one-element f64 tensor, leaves the parameters,
  AdamW's moments and the groups' host lr bit for bit where a step with the
  lr a host float leaves them: 12 steps through an lr cut at update 6, for
  the supervised and the audio-tag optimizers.
* The rule of ``engine.graphs_engage``: CPU tensors, ``accumulate`` 2, a
  duck-typed optimizer, an optimizer whose ``step`` was replaced and an
  initialised gloo group each keep the step eager, and its counter says so.
* What a graph's replay does besides the kernels, on stand-ins for the
  graph (this machine has no CUDA): the launch counters move by what the
  capture moved them on every replay; a stand-in that replays by running
  the captured call again gives the eager step's losses and parameters bit
  for bit through an lr cut, with 1 eager call, 1 capture and 7 replays; a
  write outside the step (a load, gradients set to None, AdamW's state
  loaded, a FrozenBN fold rebuilt in another dtype) drops the graph, an
  evaluation between steps keeps it; an evaluation after replays that
  wrote the trained weights (without moving their version counters, as a
  real replay writes them) folds the weights as they are then; another
  input signature drops the graph and warms up again.
"""
import copy
import dataclasses
import socket

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from sound_event_detection_transformer_tpu_torch import engine
from sound_event_detection_transformer_tpu_torch.engine import (
    GraphCounts,
    StepGraphs,
    graphs_engage,
    init_train_state,
    make_train_step,
)
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.models.resnet import FOLDS, FrozenBatchNorm, conv_bn
from sound_event_detection_transformer_tpu_torch.ops import hungarian
from sound_event_detection_transformer_tpu_torch.ops.flash_attention import flash_attention
from sound_event_detection_transformer_tpu_torch.config import TrainConfig
from sound_event_detection_transformer_tpu_torch.parallel.optim import (
    SEDTOptimizer,
    clip_by_global_norm_,
    make_audio_tag_optimizer,
    make_optimizer,
)
from sound_event_detection_transformer_tpu_torch.utils.profiler import SPANS

torch.set_num_threads(2)
CUDA = torch.device("cuda")  # a device object only: the rule reads its type


def _named_model(seed: int) -> torch.nn.Module:
    """Leaves named as the flagship's groups: trained backbone, frozen
    backbone, main (one of which never gets a gradient)."""
    gen = torch.Generator().manual_seed(seed)
    root = torch.nn.Module()
    root.backbone = torch.nn.Module()
    for name, (n_in, n_out) in (("conv0", (1, 3)), ("conv1", (3, 4)), ("layer2_0", (4, 8))):
        setattr(root.backbone, name, torch.nn.Linear(n_in, n_out))
    root.class_embed = torch.nn.Linear(8, 5)
    root.unused = torch.nn.Linear(2, 2)
    with torch.no_grad():
        for p in root.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return root


def float_lr_step(opt: SEDTOptimizer) -> None:
    """The step with each group's lr a host float: the update as one call,
    the reference the split step must reproduce bit for bit."""
    opt.micro_steps += 1
    for p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in opt.params]
    if opt.clip_max_norm is not None:
        clip_by_global_norm_(grads, opt.clip_max_norm, opt.sharded)
    for group, sched in zip(opt.adamw.param_groups, opt.schedules):
        group["lr"] = sched(opt.updates)
    opt.adamw.step()
    opt.adamw.zero_grad(set_to_none=False)
    opt.updates += 1


def _optimizer(kind: str, model: torch.nn.Module) -> SEDTOptimizer:
    """The lr is cut tenfold at update 6 (3 updates an epoch)."""
    if kind == "supervised":
        tcfg = TrainConfig(lr=1e-3, lr_backbone=1e-4, lr_drop=2, clip_max_norm=0.5)
        return make_optimizer(model, tcfg, steps_per_epoch=3)
    return make_audio_tag_optimizer(model, 1e-3, lr_drop=2, steps_per_epoch=3, clip_max_norm=0.5)


@pytest.mark.parametrize("kind", ["supervised", "audio_tag"])
def test_split_step_keeps_the_float_lr_bits(kind):
    models = [_named_model(0), _named_model(0)]
    split, ref = (_optimizer(kind, m) for m in models)
    assert all(lr.dtype == torch.float64 and lr.numel() == 1 for lr in split.lr)
    gen = torch.Generator().manual_seed(1)
    lrs = []
    for _ in range(12):
        seed = int(torch.randint(1 << 30, (), generator=gen))
        for model in models:  # the same gradients, large enough that the clip acts
            gen_k = torch.Generator().manual_seed(seed)
            for name, p in model.named_parameters():
                if p.requires_grad and not name.startswith("unused"):
                    p.grad = torch.randn(p.shape, generator=gen_k) * 3.0
        assert split.advance()
        split.update()
        float_lr_step(ref)
        lrs.append([float(lr) for lr in split.lr])
        assert [g["lr"] for g in split.adamw.param_groups] == [
            g["lr"] for g in ref.adamw.param_groups] == lrs[-1]
    assert lrs[5] != lrs[6] and lrs[6] == [x * 0.1 for x in lrs[0]], lrs
    assert (split.updates, split.micro_steps) == (ref.updates, ref.micro_steps) == (12, 12)
    for p, q in zip(split.params, ref.params):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(split.adamw.state[p][key], ref.adamw.state[q][key])
    frozen = [p for n, p in models[0].named_parameters() if n.startswith("backbone.conv1")]
    assert kind == "audio_tag" or (frozen and not frozen[0].requires_grad)


# ------------------------------------------------------------ the rule


class _Duck:
    """An optimizer that is not a ``SEDTOptimizer``."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def step(self) -> None:
        self.optimizer.step()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_step(optimizer_of):
    cfg = chip_smoke.tiny_train_config()
    model, wd = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    state = init_train_state(model, cfg, steps_per_epoch=10)
    return model, make_train_step(model, wd, cfg, optimizer_of(state.optimizer), device="cpu"), cfg


@pytest.mark.parametrize("case", ["cpu", "accumulate", "duck", "replaced_step", "gloo"])
def test_graphs_engage_only_where_a_graph_can_replay(case):
    model = _named_model(0)
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=3)
    assert graphs_engage(CUDA, opt)  # the rule's one yes: all its conditions met
    device = torch.device("cpu") if case == "cpu" else CUDA
    optimizer_of = lambda o: o  # noqa: E731
    if case == "accumulate":
        optimizer_of = lambda o: SEDTOptimizer(  # noqa: E731
            {"main": o.params, "backbone": []}, {"main": o.schedules[0]}, 1e-4, 0.1, accumulate=2)
    elif case == "duck":
        optimizer_of = _Duck
    elif case == "replaced_step":
        def optimizer_of(o):
            o.step = lambda: SEDTOptimizer.step(o)
            return o
    if case == "gloo":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    try:
        assert not graphs_engage(device, optimizer_of(make_optimizer(
            _named_model(0), TrainConfig(), steps_per_epoch=3)))
        _, step, cfg = _tiny_step(optimizer_of)
        _, batches = chip_smoke.make_batches(cfg, 4, 2, seed=3)
        gen = torch.Generator().manual_seed(3)
        for b in batches:
            assert torch.isfinite(step(b, gen)["loss"])
        assert not step.graph.engaged
        assert step.graph.counts() == GraphCounts(captures=0, replays=0, eager=2)
    finally:
        if case == "gloo":
            dist.destroy_process_group()


# ------------------------------------------------------------ stand-ins


class _Idle:
    """A stand-in for a captured graph whose replay runs no step: it calls
    ``on_replay`` (where given) and counts."""

    def __init__(self, on_replay=None):
        self.replays, self.on_replay = 0, on_replay

    def replay(self) -> None:
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay()


def _forward(model, x):
    """The folded convolution of ``x`` [B, 4] to [B, 1, 1, 1]."""
    return conv_bn(model[0], model[1], x[:, :, None, None])


def _linear_graphs(monkeypatch, moves=None, on_replay=None):
    """A ``StepGraphs`` over a linear model's loss with a real
    ``SEDTOptimizer``, engaged on the CPU, its graphs idle stand-ins whose
    capture runs the step's Python once.  ``moves`` is called inside the
    step: it moves the launch counters as kernel launches would;
    ``on_replay(model)`` is called on each replay."""
    model = torch.nn.Sequential(torch.nn.Conv2d(4, 1, 1, bias=False), FrozenBatchNorm(1))
    opt = SEDTOptimizer({"main": list(model.parameters()), "backbone": []}, {"main": lambda _: 0.1},
                        0.0, None)
    graphs = []

    def run(inputs, generator, update):
        if moves is not None:
            moves()
        loss = _forward(model, inputs[0]).square().mean()
        loss.backward()
        update()
        return {"loss": loss.detach()}

    def capture(run_, generator, stream):  # the Python runs, as in a real capture
        graphs.append(_Idle(on_replay and (lambda: on_replay(model))))
        return graphs[-1], run_()

    monkeypatch.setattr(engine, "cuda_capture", capture)
    return StepGraphs(run, model, opt, torch.device("cpu"), engaged=True), model, opt, graphs


def test_replays_move_the_launch_counters_by_the_capture(monkeypatch):
    def moves():
        hungarian.lsap_lane.launches += 1
        flash_attention.backward_launches += 2
        FOLDS["weight_reused"] += 3

    step, _, _, graphs = _linear_graphs(monkeypatch, moves)
    x = [torch.ones(2, 4)]
    k1, k4, folds = (hungarian.lsap_lane.launches, flash_attention.backward_launches,
                     FOLDS["weight_reused"])
    for calls in range(1, 6):
        step(x, None)
        # each call moves the counters once: the eager call and the capture
        # by running, a replay by the capture's moves
        assert hungarian.lsap_lane.launches - k1 == calls
        assert flash_attention.backward_launches - k4 == 2 * calls
        assert FOLDS["weight_reused"] - folds == 3 * calls
    assert len(graphs) == 1 and graphs[0].replays == 4
    assert step.counts() == GraphCounts(captures=1, replays=4, eager=1)
    assert step.counts().since(GraphCounts(0, 1, 0)).line() == (
        "graph: 3 replays (counted as their capture), 1 captures, 1 eager")


@pytest.mark.parametrize("write", ["load_weights", "grads_to_none", "load_adamw", "fold_rebuilt"])
def test_a_write_outside_the_step_drops_the_graphs(monkeypatch, write):
    step, model, opt, graphs = _linear_graphs(monkeypatch)
    x = [torch.ones(2, 4)]
    for _ in range(3):
        step(x, None)
    assert step.counts() == (1, 2, 1)
    if write == "load_weights":
        model.load_state_dict(model.state_dict())
    elif write == "grads_to_none":
        model.zero_grad(set_to_none=True)
    elif write == "fold_rebuilt":  # another dtype's fold replaces the step's
        model[1].affine(torch.float64)
    else:
        opt.load_state_dict(opt.state_dict())
    step(x, None)  # the graph is gone: this call warms up again
    assert step.graph is None and step.counts() == (1, 2, 2)
    step(x, None)
    step(x, None)
    assert step.counts() == (2, 4, 2) and len(graphs) == 2


def test_an_evaluation_between_steps_keeps_the_graphs(monkeypatch):
    step, model, _, graphs = _linear_graphs(monkeypatch)
    x = [torch.ones(2, 4)]
    for _ in range(3):
        step(x, None)
    with torch.inference_mode():  # caches the trained convolution's fold, which no graph reads
        _forward(model, x[0])
    assert model[1]._fold.weight is not None
    step(x, None)
    assert step.counts() == (1, 3, 1) and graphs[0].replays == 3


def _adamw_writes(model) -> None:
    """What a replay's AdamW does to the trained weight: an in-place write
    that leaves the version counter as it was."""
    model[0].weight.data.sub_(0.25)


def test_evaluations_between_replays_fold_the_updated_weights(monkeypatch):
    step, model, _, graphs = _linear_graphs(monkeypatch, on_replay=_adamw_writes)
    x = [torch.ones(2, 4)]

    def evaluate():
        """The evaluation's output, and a fresh fold's (a deep copy starts
        with no cached fold)."""
        twin = copy.deepcopy(model)
        with torch.inference_mode():
            return _forward(model, x[0]), _forward(twin, x[0])

    for _ in range(3):
        step(x, None)
    first, fresh = evaluate()
    assert torch.equal(first, fresh)
    for _ in range(2):  # replays: the weight moves and its version counter stays
        step(x, None)
    second, fresh = evaluate()
    assert torch.equal(second, fresh) and not torch.equal(second, first)
    assert step.counts() == (1, 4, 1) and graphs[0].replays == 4


def test_a_new_signature_warms_up_and_captures_again(monkeypatch):
    step, _, _, graphs = _linear_graphs(monkeypatch)
    for _ in range(3):
        step([torch.ones(2, 4)], None)
    assert step.counts() == (1, 2, 1)
    step([torch.ones(3, 4)], None)  # drops the graph: a warm-up
    assert step.graph is None and step.counts() == (1, 2, 2)
    for _ in range(2):
        step([torch.ones(3, 4)], None)
    assert step.counts() == (2, 4, 2) and len(graphs) == 2
    step([torch.ones(2, 4)], None)
    assert step.counts() == (2, 4, 3) and graphs[0].replays == 2 and graphs[1].replays == 2


class _Rerun:
    """A stand-in for a captured graph: its replay runs the captured call
    again on the same static inputs, writes the results into the capture's
    outputs, and holds the launch counters still (a replay runs no
    Python)."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs

    def replay(self) -> None:
        before = engine._counts()
        out = self.run()
        engine._add_counts({k: before.get(k, 0) - v for k, v in engine._counts().items()})
        for k, v in out.items():
            self.outputs[k].copy_(v)


def _rerun_capture(model, opt, gen):
    """A capture that records what it runs and executes nothing: the
    state the call changes (parameters, gradients, AdamW's state, the
    generator) is put back after it, in place."""

    def capture(run, generator, stream):
        state = [t for st in opt.adamw.state.values() for t in st.values() if torch.is_tensor(t)]
        tensors = list(model.parameters()) + [p.grad for p in opt.params] + state
        saved, gen_state = [t.detach().clone() for t in tensors], gen.get_state()
        out = run()
        out = {k: v.clone() for k, v in out.items()}
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        gen.set_state(gen_state)
        return _Rerun(run, out), out

    return capture


def test_a_stand_in_graph_follows_the_eager_step(monkeypatch):
    cfg = chip_smoke.tiny_train_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1),
                      train=dataclasses.replace(cfg.train, lr_drop=1))
    _, batches = chip_smoke.make_batches(cfg, 4, 8, seed=5)
    runs = {}
    for graphed in (False, True):
        model, wd = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        state = init_train_state(model, cfg, steps_per_epoch=4)  # the lr cut at update 4
        step = make_train_step(model, wd, cfg, state.optimizer, device="cpu")
        gen = torch.Generator().manual_seed(5)
        if graphed:
            step.graph.engaged = True
            monkeypatch.setattr(engine, "cuda_capture", _rerun_capture(model, state.optimizer, gen))
            # the stand-in's replays run Python, which moves the version
            # counters that a real replay leaves as they are
            holds = StepGraphs._holds
            monkeypatch.setattr(StepGraphs, "_holds", lambda self: (*holds(self)[:2], []))
        spans = SPANS.totals()
        losses = [float(step(b, gen)["loss"]) for b in batches]
        runs[graphed] = {"losses": losses, "lr": [float(t) for t in state.optimizer.lr],
                         "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                         "counts": step.graph.counts(), "spans": SPANS.since(spans)}
    eager, graphed = runs[False], runs[True]
    assert eager["counts"] == (0, 0, 8) and graphed["counts"] == (1, 7, 1)
    assert graphed["spans"]["train.replay"].count == 7 and "train.replay" not in eager["spans"]
    assert graphed["lr"] == eager["lr"] == [cfg.train.lr * 0.1, cfg.train.lr_backbone * 0.1]
    assert graphed["losses"] == eager["losses"] and len(set(eager["losses"])) == 8
    for n, p in eager["params"].items():
        assert torch.equal(graphed["params"][n], p), n
