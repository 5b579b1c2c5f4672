"""Entry ``train_epoch``: the port's trainer loop, ``train_lib.train_one_epoch``
over ``engine.make_train_step``, driven as ``run_supervised`` and
``run_spsedt`` drive it between epochs.

Set-up builds the configuration through the port's own parser and config
builders from the configuration file's flags (the traffic's batch in place
of the recipe's), the clips (:mod:`benchmark.traffic`), the model with the
benchmark's seeded weights, the optimizer, the step, the device-resident
``FeatureBank`` and the sampler.  It then runs the first ``check_steps``
steps through the same call and feed the window uses, one batch a call, and
reads what the reference is held against: each step's loss, the first
step's forward outputs (a hook on the model keeps its output dict), the
first gradient of every trained leaf as AdamW got it (its first moment after
one step over 1 - beta1) and each leaf's change after the last check step.

The window then runs epoch after epoch (batches from ``batch_iterator`` on
its prefetch thread, features from ``FeatureBank.gather``, the device-side
meter fetched at each epoch's end) until ``seconds`` have passed: no
evaluation, checkpoint or log inside it.  A CUDA event after each step
gives the step intervals.  With ``trace`` a profiled stretch follows: a
warm-up cycle, then at least 3 steps and 50 ms under the profiler.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sound_event_detection_transformer_tpu_torch import engine, train_lib
from sound_event_detection_transformer_tpu_torch.data.dataset import (
    ConcatDataset, MultiStreamBatchSampler)
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.feature_bank import maybe_bank
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.parallel.mesh import wrap_model

from .. import trace as tr
from .. import traffic as T
from ..reference import model as RM
from ..reference import params as RP

LEAST_STRETCH_STEPS, LEAST_STRETCH_S = 3, 0.05


class _Quiet:
    """A logger for ``train_one_epoch`` that keeps the window free of output."""

    @staticmethod
    def info(*_args, **_kw) -> None:
        return None


class Stamps:
    """Marks after each step: CUDA events on the card, the host clock on the
    CPU (where every operation has ended when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class TimedStep:
    """The port's step with a mark after it and its first losses kept."""

    def __init__(self, step):
        self.step, self.device = step, step.device
        self.stamps: Optional[Stamps] = None
        self.losses: List[torch.Tensor] = []
        self.keep = 0
        self.count = 0

    def __call__(self, batch, generator):
        m = self.step(batch, generator)
        self.count += 1
        if len(self.losses) < self.keep:
            self.losses.append(m["loss"].detach().clone())
        if self.stamps is not None:
            self.stamps.mark()
        return m


class Until:
    """``batches`` until the host clock passes ``deadline``: the window ends
    at the first step boundary after it (the prefetch thread may hold a few
    batches more, which run)."""

    def __init__(self, batches, deadline: float):
        self.batches, self.deadline = batches, deadline
        self.batch_sizes = getattr(batches, "batch_sizes", None)

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            if time.perf_counter() >= self.deadline:
                return
            yield b


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_config(config: Dict, traffic: Dict, seeds: Dict[str, int]):
    """The port's config from the configuration's flags, at the traffic's
    batch, checked against the file's widths."""
    flags = list(config["flags"]) + ["--batch_size", str(traffic["batch"]),
                                     "--seed", str(seeds["sampler"])]
    args = train_lib.get_parser().parse_args(flags)
    cfg = (train_lib.spsedt_config(args) if config["trainer"] == "self_sup"
           else train_lib.args_to_config(args))
    m, pm = config["model"], cfg.model
    got = {"hidden_dim": pm.hidden_dim, "nheads": pm.nheads, "dim_feedforward": pm.dim_feedforward,
           "enc_layers": pm.enc_layers, "dec_layers": pm.dec_layers, "num_queries": pm.num_queries,
           "dec_at": pm.dec_at, "self_sup": pm.self_sup, "feature_recon": pm.feature_recon,
           "dropout": pm.dropout, "max_events": pm.max_events, "frames": pm.max_frames,
           "n_mels": pm.n_mels}
    wrong = {k: (v, m[k]) for k, v in got.items() if m[k] != v}
    if wrong:
        raise ValueError(f"the port's config departs from {config['name']}: {wrong}")
    return args, cfg


class Cell:
    """Set-up, check steps, window and traced stretch of one run."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device):
        self.config, self.traffic, self.dev = config, traffic, device
        self.phases: List = [("enter", time.perf_counter())]  # set-up's parts, for stderr
        self.seeds = seeds = T.sub_seeds(seed)
        self.args, self.cfg = program_config(config, traffic, seeds)
        cfg, dev = self.cfg, device
        self.self_sup = config["trainer"] == "self_sup"
        self.batch = traffic["batch"]
        n = config["train_clips"]
        classes = list(cfg.data.classes)
        self.clips = T.make_clips(n, cfg.model.max_frames, cfg.model.n_mels, len(classes),
                                  traffic, seeds, dev)
        self.phases.append(("clips", time.perf_counter()))
        seconds = cfg.features.max_len_seconds
        if self.self_sup:
            self.rng = np.random.RandomState(seeds["patches"])  # orders, then patch boxes
            enc = BoxEncoder(1, seconds=seconds, generate_patch=True)
            self.data = T.PatchClips(self.clips, enc.encode_unlabel, cfg.model.num_patches,
                                     traffic["patch_length"], self.rng)
        else:
            enc = BoxEncoder(classes, seconds=seconds)
            self.data = ConcatDataset([T.StrongClips(self.clips, enc.encode_strong_df, classes,
                                                     seconds)])
            self.sampler = MultiStreamBatchSampler(self.data, [self.batch], seed=cfg.train.seed)
        self.steps_per_epoch = n // self.batch

        with torch.device(dev):
            model, weight_dict = build_model(cfg, device=dev)
        self.spec = RP.param_spec(RM.model_settings(config))
        model.load_state_dict(RP.make_weights(self.spec, seeds["weights"], dev), strict=True)
        self.model = model
        self.phases.append(("model and weights", time.perf_counter()))
        self.state = engine.init_train_state(model, cfg, self.steps_per_epoch)
        net = wrap_model(model, dev)
        step = engine.make_train_step(net, weight_dict, cfg, self.state.optimizer,
                                      normalize=cfg.train.normalize, fl=cfg.train.focal_loss,
                                      augment_on=not self.self_sup, device=dev)
        self.step = TimedStep(step)
        self.gen = torch.Generator(device=dev).manual_seed(seeds["dropout"])
        self.phases.append(("optimizer and step", time.perf_counter()))
        self.bank = maybe_bank(self.args, self.data, cfg, dev)
        if self.bank is None:
            raise RuntimeError("the feature bank did not fit: the cell measures the bank path")
        self.phases.append(("bank", time.perf_counter()))
        self.log = _Quiet()
        self.data_wait: List = []  # (seconds waited, steps) of each call

    # ------------------------------------------------------------- batches

    def epoch_batches(self):
        """One epoch's batches as the trainer draws them."""
        if self.self_sup:
            order = self.rng.permutation(len(self.data))
            bs = self.batch
            return [order[b * bs:(b + 1) * bs].tolist() for b in range(len(order) // bs)]
        return self.sampler

    def epoch(self, batches) -> int:
        """One call of the trainer's loop; returns its steps."""
        acc, timer = train_lib.train_one_epoch(self.step, self.data, batches, self.cfg, self.bank,
                                               self.gen, self.log)
        means, n_steps = acc.means()  # the epoch's one fetch
        self.losses_finite = getattr(self, "losses_finite", True) and math.isfinite(
            float(means.get("loss", float("nan"))))
        self.data_wait.append((timer.data_time.sum, timer.data_time.count))
        return n_steps

    # ------------------------------------------------------------- phases

    def check_steps(self) -> Dict:
        """The first steps, one batch a call; the readings the reference is
        held against."""
        self.check_rows = T.check_batches(len(self.data), self.traffic, self.seeds,
                                          self.rng if self.self_sup else None)
        self.step.keep = len(self.check_rows)
        opt = self.state.optimizer
        names = {id(p): n for n, p in self.model.named_parameters()}
        beta1 = opt.adamw.param_groups[0]["betas"][0]
        grad, first = {}, {}

        def keep(_module, _args, out):  # the first forward's outputs, as they are
            if not first:
                first.update({k: v.detach().float().clone() for k, v in out.items()
                              if k in RM.OUTPUTS})

        for k, rows in enumerate(self.check_rows):
            hook = self.model.register_forward_hook(keep) if k == 0 else None
            self.epoch([rows])
            if hook is not None:
                hook.remove()
            if k == 0:
                moments = {id(p): opt.adamw.state[p].get("exp_avg") for p in opt.params}
                grad = {names[i]: (torch.linalg.vector_norm(m) / (1 - beta1) if m is not None
                                   else torch.zeros(())) for i, m in moments.items()}
        w0 = RP.make_weights(self.spec, self.seeds["weights"], self.dev)
        change = {names[id(p)]: torch.linalg.vector_norm(p.detach() - w0[names[id(p)]])
                  for p in opt.params}
        del w0
        self.data_wait.clear()
        self.phases.append(("check steps", time.perf_counter()))
        return {"losses": [float(x) for x in self.step.losses],
                "outputs": {k: v.cpu() for k, v in first.items()},
                "grad": {k: float(v) for k, v in grad.items()},
                "change": {k: float(v) for k, v in change.items()}}

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

    def stretch(self, step_s: float) -> tr.Trace:
        """A warm-up cycle, then at least 3 steps and 50 ms, profiled."""
        k = max(LEAST_STRETCH_STEPS, math.ceil(LEAST_STRETCH_S / max(step_s, 1e-6)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                batches = list(self.epoch_batches())
                _sync(self.dev)
                with torch.profiler.record_function(tr.STRETCH):
                    self.epoch(batches[:k])
                    _sync(self.dev)
                prof.step()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return tr.load(path, k)
        finally:
            os.remove(path)

    def release(self) -> None:
        """Drop the program's state so that the reference has the card."""
        for name in ("model", "state", "step", "bank", "data", "sampler"):
            if hasattr(self, name):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(config: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device) -> Dict:
    """Set-up and check steps, the window, the traced stretch (with
    ``trace``), the peak memory; then the program's state is dropped."""
    cell = Cell(config, traffic, seed, device)
    readings = cell.check_steps()
    window = cell.window(seconds)
    stretch = None
    if trace:
        stretch = cell.stretch(window["window_s"] / max(window["steps"], 1))
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

    ref = ref_check.readings(config, traffic, out["clips"], seed, device)
    if ref["rows"] != out["rows"]:
        raise RuntimeError("the reference rebuilt other check batches than the program ran")
    return ref_check.compare(out["readings"], ref)
