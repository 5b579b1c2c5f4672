#!/usr/bin/env python3
"""Timing of the mean-teacher semi step (DCASE recipe) on the PyTorch port.

The port's counterpart of ``tools/profile_semi.py``, with its flags,
defaults and geometry: ResNet-50 DC5, ``--enc_layers`` 6 + ``--dec_layers``
6 (not the README's semi command's 3+3, so these are not ``chip_smoke.py``
phase 4g's numbers), 20 queries, 10 DCASE classes, ``dec_at``, 496 x 64
clips, ``--batch`` 64 = a quarter strong, a quarter weak and half unlabeled,
no augmentation, class-wise thresholds 0.5, the student's view the clean one
plus 0.01, the cosine schedule; through the port's ``make_semi_train_step``
(the teacher's pseudo-labels, one forward of the labeled and student views,
one joint Hungarian solve on kernel K1, backward, AdamW, the EMA).

It prints the step's ms per step by CUDA events around back-to-back steps
and its device ms per step under the profiler (``utils.profiler.busy_ms``),
and with ``--components`` the device time of the teacher's forward, the
pseudo-labels and the remainder (and the finer parts of
``semi_step_parts``), each with the card's name and power
limit.

    python3 tools/profile_semi_torch.py [--batch 64] [--iters 10] [--components]

Runs on ``cuda:0``; without a GPU it raises unless given ``--device cpu``
(host clock only, no device time: the tests' mode).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, NamedTuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch import synthetic_batch  # noqa: E402
from sound_event_detection_transformer_tpu_torch import config as C  # noqa: E402
from sound_event_detection_transformer_tpu_torch.engine import (  # noqa: E402
    Batch,
    TrainState,
    get_pseudo_labels,
    init_train_state,
    make_semi_train_step,
    make_teacher,
)
from sound_event_detection_transformer_tpu_torch.models import (  # noqa: E402
    build_model,
    resolve_device,
    set_criterion,
    total_loss,
)
from sound_event_detection_transformer_tpu_torch.models.criterion import (  # noqa: E402
    DenseTargets,
    joint_match,
)
from sound_event_detection_transformer_tpu_torch.parallel.optim import ema_update  # noqa: E402
from sound_event_detection_transformer_tpu_torch.utils.profiler import (  # noqa: E402
    Reading,
    busy_ms,
    card_of,
    host_ms,
    measure,
)

THRESHOLD = 0.5


def semi_config(batch: int = 64, enc_layers: int = 6, dec_layers: int = 6,
                compute_dtype: str = "bfloat16") -> C.SEDTConfig:
    """The JAX tool's DCASE geometry (see the module docstring)."""
    feats = C.FeatureConfig.dcase()
    model = C.ModelConfig(backbone="resnet50", enc_layers=enc_layers, dec_layers=dec_layers,
                          num_queries=20, num_classes=10, dec_at=True,
                          max_frames=feats.max_frames, n_mels=feats.n_mels,
                          compute_dtype=compute_dtype)
    return C.SEDTConfig(features=feats, model=model,
                        data=C.DataConfig(classes=C.DCASE_CLASSES, batch_size=batch))


class SemiSetup(NamedTuple):
    """A semi step ready to run: ``run()`` takes one step with the EMA."""

    state: TrainState
    teacher: torch.nn.Module
    wd: Dict[str, float]
    cfg: C.SEDTConfig
    batch: Batch
    views: tuple
    flags: tuple
    thr: torch.Tensor
    gen: torch.Generator
    n_lab: int
    step: object

    def run(self):
        return self.step(self.state, self.teacher, *self.views, self.batch.pad_mask,
                         self.batch.targets, *self.flags, self.thr, self.gen, True)


def semi_setup(cfg: C.SEDTConfig, device: torch.device) -> SemiSetup:
    """The JAX tool's step and batch: ``bench_torch``'s synthetic batch with
    no valid target in the unlabeled half, weights from seed 0, the step's
    generator from seed 1."""
    bs = cfg.data.batch_size
    n_lab = bs // 2
    model, wd = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, cfg, steps_per_epoch=100, schedule="cosine")
    teacher = make_teacher(model)
    step = make_semi_train_step(wd, cfg, n_labeled=n_lab, device=device)
    batch = synthetic_batch(cfg, bs, device)
    valid = batch.targets.box_valid.clone()
    valid[n_lab:] = False
    batch = batch._replace(targets=batch.targets._replace(box_valid=valid, label_valid=valid))
    pos = torch.arange(bs, device=device)
    flags = (pos < bs // 4, (pos >= bs // 4) & (pos < n_lab), pos >= n_lab)
    views = (batch.feats, batch.feats + 0.01)
    thr = torch.full((cfg.model.num_classes,), THRESHOLD, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    return SemiSetup(state, teacher, wd, cfg, batch, views, flags, thr, gen, n_lab, step)


def semi_step_parts(model, teacher, weight_dict: Dict[str, float], cfg, optimizer, views,
                    batch, flags, thr: torch.Tensor, gen, n_lab: int,
                    timer: Callable[[Callable], float]) -> Dict[str, float]:
    """The mean-teacher step's time by part, each part timed on its own by
    ``timer(fn)`` (``busy_ms`` on the card), without the mixups: the
    teacher's forward, the pseudo-labels, the merged forward and the
    criterion (one joint solve), the backward (the forward, criterion and
    backward less the forward and criterion), the optimizer and the EMA.
    ``views`` are the step's (teacher, student) inputs; ``flags`` the
    batch's (strong, weak, unlabel) rows, labeled ones first."""
    m = cfg.model
    lab, unl = slice(0, n_lab), slice(n_lab, None)
    tf, sf = views
    teacher_forward = lambda: teacher(tf[unl], batch.pad_mask[unl], deterministic=True)
    with torch.no_grad():
        tea_out = teacher_forward()
    pseudo = lambda: get_pseudo_labels(tea_out, thr, batch.targets.orig_size[unl], m.max_events)
    targets_l = DenseTargets(*(t[lab] for t in batch.targets))
    targets = DenseTargets(*(torch.cat([x, y]) for x, y in zip(targets_l, pseudo()[0])))
    strong, weak, unlabel = flags

    def forward_criterion():
        out = model(torch.cat([tf[lab], sf[unl]]), torch.cat([batch.pad_mask[lab],
                                                             batch.pad_mask[unl]]),
                    deterministic=False, generator=gen)
        mres, aux = joint_match(out, targets, cfg.loss, cfg.train.focal_loss)
        rows = lambda r: {k: (v[:, r] if k.startswith("aux_") else v[r]) for k, v in out.items()}
        cut = lambda r: (type(mres)(*(x[r] for x in mres)), type(aux)(*(x[:, r] for x in aux)))
        loss = 0.0
        for r, t, s, w in ((lab, targets_l, strong[lab], weak[lab]),
                           (unl, DenseTargets(*(x[n_lab:] for x in targets)), unlabel[unl],
                            None)):
            losses, _ = set_criterion(rows(r), t, s, w, m, cfg.loss, fl=cfg.train.focal_loss,
                                      precomputed=cut(r))
            loss = loss + total_loss(losses, weight_dict)
        return loss

    with torch.no_grad():
        parts = {"teacher forward": timer(teacher_forward), "pseudo-labels": timer(pseudo)}
    with torch.enable_grad():
        parts["merged forward and criterion"] = timer(forward_criterion)
        parts["backward"] = (timer(lambda: forward_criterion().backward())
                             - parts["merged forward and criterion"])
    parts["clip and AdamW"] = timer(optimizer.step)
    parts["EMA"] = timer(lambda: ema_update(teacher.parameters(), model.parameters(),
                                            cfg.train.ema_decay))
    return parts


def components(s: SemiSetup, step: Reading) -> Dict[str, float]:
    """The JAX tool's split, by device time on the card (host ms on the
    CPU): the teacher's forward, the pseudo-labels and the remainder of
    ``step``, then ``semi_step_parts``' finer parts."""
    dev = s.step.device
    timer = busy_ms if dev.type == "cuda" else (lambda fn: host_ms(fn, 1, warmup=1))
    parts = semi_step_parts(s.state.model, s.teacher, s.wd, s.cfg, s.state.optimizer, s.views,
                            s.batch, s.flags, s.thr, s.gen, s.n_lab, timer)
    whole = step.device_ms if step.device_ms is not None else step.ms
    out = {"teacher fwd (unlabeled half, deterministic)": parts["teacher forward"],
           "pseudo-labels (postprocess + same-class NMS)": parts["pseudo-labels"],
           "remainder (sup fwd + student fwd + bwd + opt + EMA)":
               whole - parts["teacher forward"] - parts["pseudo-labels"]}
    out.update({f"part {k}": v for k, v in parts.items()})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", default=64, type=int)
    ap.add_argument("--iters", default=10, type=int)
    ap.add_argument("--enc_layers", default=6, type=int)
    ap.add_argument("--dec_layers", default=6, type=int)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--components", action="store_true",
                    help="also time the teacher's forward, the pseudo-labels and the rest")
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda:0")
    card = card_of(dev)
    cfg = semi_config(args.batch, args.enc_layers, args.dec_layers, args.compute_dtype)
    s = semi_setup(cfg, dev)
    step = measure(s.run, args.iters, dev)
    dev_text = ("device not measured" if step.device_ms is None
                else f"device {step.device_ms:.3f} ms ({args.batch / step.device_ms * 1e3:.0f} "
                     f"clips/s)")
    print(f"semi step batch={args.batch} enc/dec={args.enc_layers}/{args.dec_layers} "
          f"dtype={args.compute_dtype}: {step.ms:.3f} ms ({args.batch / step.ms * 1e3:.0f} "
          f"clips/s); {dev_text} ({card})")
    out = {"step": step}
    if args.components:
        unit = "ms of device time" if dev.type == "cuda" else "ms on the host clock"
        out["components"] = components(s, step)
        for name, ms in out["components"].items():
            print(f"  {name}: {ms:.3f} {unit} ({card})")
    return out


if __name__ == "__main__":
    main()
