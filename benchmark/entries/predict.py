"""Entry ``predict``: the port's bulk inference, ``predict_cli.make_infer``
run by ``predict_cli.predict_batches`` over batches of in-memory waveforms,
as ``predict_torch.py`` runs it over wav files.

Set-up builds the configuration through the port's own parser and
``args_to_config`` from the configuration file's flags (the traffic's batch in place
of the recipe's), the waveforms (:mod:`benchmark.traffic_wave`, one
pageable host array), the model with the benchmark's seeded weights (the
training cells' :mod:`benchmark.reference.params`) and ``infer`` (the
frontend, the forward under ``inference_mode``, the post-processing) on the
device.  It then runs the first ``check_steps`` batches through
``predict_batches`` as the window does, reading what the reference is held
against from hooks on the model: the first batch's log-mel features (the
model's input) and its raw outputs (the last decoder layer's logits and
boxes and the audio tags).

The window runs batch after batch, cycling over the clips, until
``seconds`` have passed: each batch copied from pageable memory to the card,
featurised, run, post-processed, fetched and decoded at threshold 0.5, all
inside ``predict_batches``.  A mark after each batch's decode gives the
batch intervals.  With ``trace`` a profiled stretch follows (a warm-up
cycle, then at least 3 batches and 50 ms).
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from sound_event_detection_transformer_tpu_torch import predict_cli
from sound_event_detection_transformer_tpu_torch.models import build_model

from .. import trace as tr
from .. import traffic as T
from .. import traffic_wave as TW
from ..reference import model as RM
from ..reference import params as RP
from .train_epoch import LEAST_STRETCH_S, LEAST_STRETCH_STEPS, Stamps, _sync, program_config

THRESHOLD, AT_M = 0.5, 1  # predict_torch.py's defaults: decode threshold, --at_m


def frontend_settings(cfg) -> Dict:
    fc = cfg.features
    return {"sample_rate": fc.sample_rate, "n_fft": fc.n_fft, "n_window": fc.n_window,
            "hop": fc.hop_size, "n_mels": fc.n_mels}


class Cell:
    """Set-up, check batches, window and traced stretch of one run."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device):
        self.config, self.traffic, self.dev = config, traffic, device
        self.phases: List = [("enter", time.perf_counter())]
        self.seeds = seeds = T.sub_seeds(seed)
        self.args, self.cfg = program_config(config, traffic, seeds)
        cfg = self.cfg
        self.batch, self.n = traffic["batch"], traffic["clips"]
        if self.n % self.batch:
            raise ValueError(f"{self.n} clips do not cycle in batches of {self.batch}")
        fc = cfg.features
        self.waves = TW.make_waves(self.n, fc.sample_rate, fc.max_len_seconds,
                                   len(cfg.data.classes), traffic, seeds, device)
        self.phases.append(("waves", time.perf_counter()))
        with torch.device(device):
            model, _ = build_model(cfg, device=device)
        spec = RP.param_spec(RM.model_settings(config))
        model.load_state_dict(RP.make_weights(spec, seeds["weights"], device), strict=True)
        self.model = model
        self.infer = predict_cli.make_infer(cfg, model, None, AT_M, device=device)
        self.phases.append(("model and weights", time.perf_counter()))
        self.done = 0  # batches decoded
        self.stamps = None
        self.finite = True

    def batches(self, count=None, deadline=None):
        """The batches from the first, cycling over the clips, until ``count``
        were handed out or the clock passes ``deadline``; each resumption
        marks the end of the batch before it."""
        k = 0
        while True:
            if k:
                self.done += 1
                if self.stamps is not None:
                    self.stamps.mark()
            if (count is not None and k >= count) or (deadline is not None
                                                      and time.perf_counter() >= deadline):
                return
            rows = TW.batch_rows(k, self.n, self.batch)
            yield TW.names(rows), self.waves.waves[rows]
            k += 1

    def predict(self, batches) -> None:
        rows = predict_cli.predict_batches(self.cfg, self.infer, batches, THRESHOLD)
        self.finite = self.finite and all(math.isfinite(r[1]) and math.isfinite(r[2])
                                          and math.isfinite(r[4]) for r in rows)

    def check_steps(self) -> Dict:
        kept = {}

        def inputs(_module, args):
            if "feats" not in kept:
                kept["feats"] = args[0][..., 0].detach().float().cpu()

        def outputs(_module, _args, out):
            if "outputs" not in kept:
                kept["outputs"] = {k: v.detach().float().cpu() for k, v in out.items()
                                   if k in RM.OUTPUTS}

        hooks = [self.model.register_forward_pre_hook(inputs),
                 self.model.register_forward_hook(outputs)]
        try:
            self.predict(self.batches(count=self.traffic["check_steps"]))
        finally:
            for h in hooks:
                h.remove()
        self.phases.append(("check batches", time.perf_counter()))
        return kept

    def window(self, seconds: float) -> Dict:
        self.stamps = stamps = Stamps(self.dev)
        before = self.done
        _sync(self.dev)
        t0 = time.perf_counter()
        stamps.mark()
        self.predict(self.batches(deadline=t0 + seconds))
        _sync(self.dev)
        window_s = time.perf_counter() - t0
        self.stamps = None
        steps = self.done - before
        return {"t0": t0, "window_s": window_s, "steps": steps, "clips": steps * self.batch,
                "intervals_ms": stamps.intervals_ms(), "data_wait_s": 0.0, "data_waits": 0}

    def stretch(self, step_s: float) -> tr.Trace:
        k = max(LEAST_STRETCH_STEPS, math.ceil(LEAST_STRETCH_S / max(step_s, 1e-6)))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                _sync(self.dev)
                with torch.profiler.record_function(tr.STRETCH):
                    self.predict(self.batches(count=k))
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
        for name in ("model", "infer"):
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
        stretch = cell.stretch(window["window_s"] / max(window["steps"], 1))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    marks = cell.phases
    parts = [(name, b - a) for (_, a), (name, b) in zip(marks, marks[1:])]
    first = TW.batch_rows(0, cell.n, cell.batch)
    out = {"window": window, "trace": stretch, "readings": readings, "memory_peak_bytes": peak,
           "setup_parts": [("imports and CUDA", marks[0][1])] + parts,
           "check_waves": cell.waves.waves[first], "frontend": frontend_settings(cell.cfg),
           "frames": cell.cfg.model.max_frames, "attempted": window["clips"],
           "failed": 0 if cell.finite else window["clips"]}
    cell.release()
    return out


def rows_gap(prog: torch.Tensor, ref: torch.Tensor) -> Dict:
    """The largest, over rows, of |program - reference| over |reference|
    (norms over the row); infinite where the shapes differ."""
    if prog.shape != ref.shape:
        return {"value": float("inf"), "at": f"{tuple(prog.shape)} against {tuple(ref.shape)}"}
    gaps = (torch.linalg.vector_norm((prog - ref).flatten(1), dim=1)
            / torch.linalg.vector_norm(ref.flatten(1), dim=1))
    gaps = torch.where(torch.isnan(gaps), torch.inf, gaps)
    i = int(torch.argmax(gaps))
    return {"value": float(gaps[i]), "at": f"row {i} of {len(gaps)}"}


def reference(config: Dict, out: Dict, seed: int, device: torch.device, mode: str = "f32",
              net_mode: str = "f32", block: int = 32) -> Dict:
    """The reference's features of the first batch (its frontend in ``mode``)
    and its network's outputs on them (in ``net_mode``), TF32 off."""
    from ..reference import check as ref_check
    from ..reference import frontend as RF

    with ref_check.tf32_off(), torch.no_grad():
        waves = torch.as_tensor(np.asarray(out["check_waves"]), device=device)
        feats = RF.logmel(waves, out["frontend"], out["frames"], mode)
        del waves
        m = RM.model_settings(config)
        params = RP.make_weights(RP.param_spec(m), T.sub_seeds(seed)["weights"], device)
        blocks = [RM.outputs(RM.sedt_forward(params, feats[lo:lo + block, ..., None], m, None,
                                             net_mode))
                  for lo in range(0, feats.shape[0], block)]
    outputs = {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}
    return {"feats": feats.cpu(), "outputs": outputs}


def compare(prog: Dict, ref: Dict) -> Dict:
    from ..reference import check as ref_check

    feat = rows_gap(prog["feats"], ref["feats"])
    return {"feat_gap": feat, "out_gap": ref_check.out_gap(prog["outputs"], ref["outputs"])}


def check(config: Dict, traffic: Dict, seed: int, device: torch.device, out: Dict) -> Dict:
    """The program's first batch against the reference's frontend and
    network in f32."""
    return compare(out["readings"], reference(config, out, seed, device))
