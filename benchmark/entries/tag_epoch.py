"""Entry ``tag_epoch``: the port's audio-tag trainer loop,
``train_lib.train_audio_tag_epoch`` over ``train_lib.make_audio_tag_step``,
driven as ``run_audio_tag`` drives it between epochs, on AST.

Set-up builds the configuration through the port's own parser
(``cli.at_args``) and ``train_lib.audio_tag_ast`` from the configuration
file's flags (the traffic's batch in place of the recipe's), checked against
the file's widths; the clips (:mod:`benchmark.traffic_tag`); the model
(``train_lib.init_audio_tag_model``) with the benchmark's seeded weights
(:mod:`benchmark.reference.ast`), AST's optimizer
(``parallel.optim.make_ast_optimizer``) and the step at the trainer's
autocast dtype.  It then runs the first ``check_steps`` steps through the
same call the window uses, one batch a call, and reads what the reference
is held against: each step's loss, the first step's logits (a hook on the
model), each leaf's first gradient as Adam got it (its first moment after
one step over 1 - beta1) and each leaf's change after the last check step.

The window runs epoch after epoch (a permutation a epoch, batches built and
pinned on the prefetch thread, the loss summed on the device and fetched at
each epoch's end) until ``seconds`` have passed.  A CUDA event after each
step gives the step intervals.  With ``trace`` a profiled stretch follows (a
warm-up cycle, then at least 3 steps and 50 ms); the device-side ranges of
the stretch's ``attention.backward`` spans, which the benchmark's trace
reader leaves out, are read from the same trace file into the window
(``gpu_ranges_ms_per_step``).
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from sound_event_detection_transformer_tpu_torch import cli, train_lib
from sound_event_detection_transformer_tpu_torch.parallel.mesh import wrap_model
from sound_event_detection_transformer_tpu_torch.parallel.optim import make_ast_optimizer

from .. import trace as tr
from .. import traffic as T
from .. import traffic_tag as TT
from ..reference import ast as RA
from ..reference.params import make_weights
from .train_epoch import LEAST_STRETCH_S, LEAST_STRETCH_STEPS, Stamps, Until, _sync

DEVICE_RANGES = ("attention.backward",)


class TimedStep:
    """The port's audio-tag step with a mark after it and its first losses
    kept."""

    def __init__(self, step):
        self.step = step
        self.stamps = None
        self.losses: List[torch.Tensor] = []
        self.keep = 0
        self.count = 0

    def __call__(self, x, y):
        loss = self.step(x, y)
        self.count += 1
        if len(self.losses) < self.keep:
            self.losses.append(loss.detach().clone())
        if self.stamps is not None:
            self.stamps.mark()
        return loss


def program_config(config: Dict, traffic: Dict, seeds: Dict[str, int]):
    """(args, cfg, AST's settings) from the configuration's flags at the
    traffic's batch, checked against the file's widths."""
    flags = list(config["flags"]) + ["--batch_size", str(traffic["batch"]),
                                     "--seed", str(seeds["sampler"])]
    args = cli.at_args(flags)
    cfg, ast = train_lib.audio_tag_ast(args, train_lib.args_to_config(args))
    got = dataclasses.asdict(ast)
    wrong = {k: (v, config["model"][k]) for k, v in got.items() if config["model"][k] != v}
    if wrong or ast.tokens != config["model"]["tokens"]:
        raise ValueError(f"the port's AST departs from {config['name']}: {wrong}")
    return args, cfg, ast


def device_ranges(path: str, names, steps: int) -> Dict[str, float]:
    """The summed device-side spans (``gpu_user_annotation``) of the ranges
    ``names`` inside the trace's last ``STRETCH`` span, ms a step; a name
    without a range is left out."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    raw = data["traceEvents"] if isinstance(data, dict) else data
    xs = [e for e in raw if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e["name"] == tr.STRETCH and e.get("cat") in tr.HOST_CATEGORIES]
    if not spans:
        return {}
    span = max(spans, key=lambda e: float(e["ts"]))
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    out: Dict[str, float] = {}
    for e in xs:
        if (e.get("cat") == "gpu_user_annotation" and e["name"] in names
                and lo <= float(e["ts"]) < hi):
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["dur"]) / 1e3 / steps
    return out


class Cell:
    """Set-up, check steps, window and traced stretch of one run."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device):
        self.config, self.traffic, self.dev = config, traffic, device
        self.phases: List = [("enter", time.perf_counter())]
        self.seeds = seeds = T.sub_seeds(seed)
        self.args, self.cfg, self.ast = program_config(config, traffic, seeds)
        self.batch = traffic["batch"]
        n = config["train_clips"]
        a = self.ast
        self.clips = TT.make_tag_clips(n, a.frames, a.n_mels, a.num_classes, traffic, seeds,
                                       device)
        self.data = TT.TagDataset(self.clips)
        self.phases.append(("clips", time.perf_counter()))
        self.steps_per_epoch = n // self.batch
        model = train_lib.init_audio_tag_model(self.cfg, "avg", device, a)
        self.spec = RA.param_spec(RA.settings(config))
        model.load_state_dict(make_weights(self.spec, seeds["weights"], device), strict=True)
        self.model = model
        self.phases.append(("model and weights", time.perf_counter()))
        self.optimizer = make_ast_optimizer(model, self.args.lr, self.steps_per_epoch)
        step = train_lib.make_audio_tag_step(wrap_model(model, device), self.optimizer,
                                             compute_dtype=train_lib.audio_tag_dtype(self.cfg, a))
        self.step = TimedStep(step)
        self.rng = np.random.RandomState(seeds["sampler"])
        self.phases.append(("optimizer and step", time.perf_counter()))
        self.data_wait: List = []
        self.losses_finite = True

    def epoch_batches(self) -> List[List[int]]:
        return TT.epoch_batches(len(self.data), self.batch, self.rng)

    def epoch(self, batches) -> int:
        """One call of the trainer's loop; returns its steps."""
        acc, timer = train_lib.train_audio_tag_epoch(self.step, self.data, batches, self.dev)
        means, n_steps = acc.means()  # the epoch's one fetch
        self.losses_finite = self.losses_finite and math.isfinite(
            float(means.get("loss", float("nan"))))
        self.data_wait.append((timer.data_time.sum, timer.data_time.count))
        return n_steps

    def check_steps(self) -> Dict:
        self.check_rows = T.check_batches(len(self.data), self.traffic, self.seeds)
        self.step.keep = len(self.check_rows)
        opt = self.optimizer
        names = {id(p): n for n, p in self.model.named_parameters()}
        beta1 = opt.adamw.param_groups[0]["betas"][0]
        grad, first = {}, []

        def keep(_module, _args, out):
            if not first:
                first.append(out.detach().float().cpu())

        for k, rows in enumerate(self.check_rows):
            hook = self.model.register_forward_hook(keep) if k == 0 else None
            self.epoch([rows])
            if hook is not None:
                hook.remove()
            if k == 0:  # no moment where the optimizer never stepped
                moments = {id(p): opt.adamw.state[p].get("exp_avg") for p in opt.params}
                grad = {names[i]: (float(torch.linalg.vector_norm(m)) / (1 - beta1)
                                   if m is not None else 0.0) for i, m in moments.items()}
        w0 = make_weights(self.spec, self.seeds["weights"], self.dev)
        change = {names[id(p)]: float(torch.linalg.vector_norm(p.detach() - w0[names[id(p)]]))
                  for p in opt.params}
        del w0
        self.data_wait.clear()
        self.phases.append(("check steps", time.perf_counter()))
        return {"losses": [float(x) for x in self.step.losses], "outputs": {"logits": first[0]},
                "grad": grad, "change": change}

    def window(self, seconds: float) -> Dict:
        dev = self.dev
        self.step.stamps = stamps = Stamps(dev)
        before = self.step.count
        _sync(dev)
        t0 = time.perf_counter()
        stamps.mark()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            self.epoch(Until(self.epoch_batches(), deadline))
        _sync(dev)
        window_s = time.perf_counter() - t0
        self.step.stamps = None
        steps = self.step.count - before
        wait_s, waits = map(sum, zip(*self.data_wait)) if self.data_wait else (0.0, 0)
        return {"t0": t0, "window_s": window_s, "steps": steps, "clips": steps * self.batch,
                "intervals_ms": stamps.intervals_ms(), "data_wait_s": wait_s,
                "data_waits": waits}

    def stretch(self, step_s: float):
        """A warm-up cycle, then at least 3 steps and 50 ms, profiled: the
        trace, and the device ranges of :data:`DEVICE_RANGES`, ms a step."""
        k = max(LEAST_STRETCH_STEPS, math.ceil(LEAST_STRETCH_S / max(step_s, 1e-6)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                batches = self.epoch_batches()
                _sync(self.dev)
                with torch.profiler.record_function(tr.STRETCH):
                    self.epoch(batches[:k])
                    _sync(self.dev)
                prof.step()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return tr.load(path, k), device_ranges(path, DEVICE_RANGES, k)
        finally:
            os.remove(path)

    def release(self) -> None:
        for name in ("model", "optimizer", "step", "data"):
            if hasattr(self, name):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(config: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device) -> Dict:
    cell = Cell(config, traffic, seed, device)
    readings = cell.check_steps()
    window = cell.window(seconds)
    stretch = None
    if trace:
        stretch, ranges = cell.stretch(window["window_s"] / max(window["steps"], 1))
        window["gpu_ranges_ms_per_step"] = ranges
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    marks = cell.phases
    parts = [(name, b - a) for (_, a), (name, b) in zip(marks, marks[1:])]
    out = {"window": window, "trace": stretch, "readings": readings, "memory_peak_bytes": peak,
           "setup_parts": [("imports and CUDA", marks[0][1])] + parts,
           "clips": cell.clips, "rows": cell.check_rows, "attempted": window["steps"],
           "failed": 0 if cell.losses_finite else window["steps"]}
    cell.release()
    return out


def check(config: Dict, traffic: Dict, seed: int, device: torch.device, out: Dict) -> Dict:
    """The program's check steps against the reference's in f32."""
    from ..reference import check as ref_check

    ref = RA.readings(config, out["clips"], out["rows"], T.sub_seeds(seed)["weights"], device)
    return ref_check.compare(out["readings"], ref)
