"""The reference's run of a training cell's check steps, and the comparison
that decides ``correct``.

The reference starts from the benchmark's seeded weights, made again from
the seed, and runs the first steps on the same clips, batches, patch boxes
and generator draws as the program (:mod:`.model`), each rebuilt here from
the seed and the traffic: the targets from the clips' events, SP-SEDT's
patch boxes by replaying the dataset's draws.

The numbers, each compared against its limit where the workload sets one:

* ``grad_gap``: over the trained leaves, the largest gap between the
  program's and the reference's norm of the first (clipped) gradient, over
  the larger of the reference's norm of that leaf and of the median leaf;
* ``grad_median``: the median leaf's gap of the same: steady from seed to
  seed where the largest is set by a few small, noisy leaves;
* ``change_gap``: the largest such gap of each leaf's change over the check
  steps, leaving out the leaves whose reference gradient is below a
  thousandth of the median leaf's (round-off alone moves those under Adam,
  as a key projection's bias under softmax).

* ``out_gap``: the first step's forward, row by row, before any update:
  for each row of the batch, each output's (the last decoder layer's
  logits and boxes; SEDT's audio tag; SP-SEDT's reconstructed and pooled
  patch features) distance from the reference's over the reference's
  norm, both over the row; the largest over outputs and rows.  A row that
  the program did not compute reads infinite, so a step that leaves part of
  its batch out fails it on every seed, where the gradients' norms, summed
  over the batch, see that only as far as the rows differ.

* ``grad_median_ratio``: ``grad_median`` over the same median gap of the
  reference computed in the configuration's own precision (products
  rounded to bf16) against the f32 reference, on the same seed.  At a
  seeded start the matching is nearly degenerate (rounding the products to
  bf16 changes about a quarter of the first step's assignments), so how far
  round-off moves the gradients varies with the seed; the ratio holds the
  program to the round-off of its own precision on that seed.  Only
  :mod:`benchmark.control`'s readings make the bf16 run and report it.

``loss_gap``, the largest relative gap of a check step's loss, is reported
beside them and not compared: its readings after the first step are set by
Adam's first update, which is nearly a sign a weight and takes the sign of
a near-zero gradient from round-off, and no fault or control reads far above
them.  A workload's limits name the numbers compared; the others are
reported.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import traffic as T
from . import model as M
from .params import make_weights, param_spec

SMALL_GRAD = 1e-3  # of the median leaf's gradient: a leaf Adam moves by round-off


def targets(config: Dict, clips: T.Clips, rows: Sequence[int], device: torch.device,
            boxes: List[np.ndarray] = None) -> M.Targets:
    """Dense targets of ``rows``: the clips' events, or ``boxes`` (patch
    boxes, class 0) for patch pretraining."""
    slots = config["model"]["max_events"]
    b = len(rows)
    labels = np.zeros((b, slots), np.int64)
    cl = np.zeros((b, slots, 2), np.float64)
    valid = np.zeros((b, slots), bool)
    for j, i in enumerate(rows):
        if boxes is not None:
            n = len(boxes[j])
            cl[j, :n] = boxes[j]
        else:
            n = int(clips.count[i])
            start = clips.start[i, :n].astype(np.float64)
            length = clips.length[i, :n].astype(np.float64)
            cl[j, :n, 0], cl[j, :n, 1] = start + length / 2, length
            labels[j, :n] = clips.classes[i, :n]
        valid[j, :n] = True
    dev = lambda a: torch.as_tensor(a, device=device)
    return M.Targets(dev(labels), dev(cl.astype(np.float32)), dev(valid))


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN, then as
    they were."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def readings(config: Dict, traffic: Dict, clips: T.Clips, seed: int, device: torch.device,
             mode: str = "f32") -> Dict:
    """The reference's check steps, TF32 off: each step's loss, each trained
    leaf's first clipped gradient norm, and its change after the last step."""
    with tf32_off():
        return _readings(config, traffic, clips, seed, device, mode)


def _readings(config, traffic, clips, seed, device, mode):
    seeds = T.sub_seeds(seed)
    m = M.model_settings(config)
    spec = param_spec(m)
    params = make_weights(spec, seeds["weights"], device)
    opt = M.AdamW(params, [leaf.name for leaf in spec if not leaf.buffer], config["optimizer"])
    gen = torch.Generator(device=device).manual_seed(seeds["dropout"])
    n = len(clips.feats)
    rng = np.random.RandomState(seeds["patches"]) if m["self_sup"] else None
    batches = T.check_batches(n, traffic, seeds, rng)
    losses, grad, kept = [], {}, []
    for k, rows in enumerate(batches):
        boxes = None
        if m["self_sup"]:
            boxes = [T.patch_boxes(m["frames"], m["num_patches"], traffic["patch_length"], rng)
                     for _ in rows]
        feats = torch.as_tensor(clips.feats[rows], device=device)
        t = targets(config, clips, rows, device, boxes)
        patch_boxes = t.boxes[:, :m["num_patches"]] if m["self_sup"] else None
        loss, g = M.train_step(params, opt, feats, t, config, gen, mode, patch_boxes,
                               keep=kept if k == 0 else None)
        losses.append(float(loss))
        if k == 0:
            grad = {name: float(torch.linalg.vector_norm(x)) for name, x in g.items()}
        del feats, g
    w0 = make_weights(spec, seeds["weights"], device)
    change = {name: float(torch.linalg.vector_norm(params[name] - w0[name])) for name in opt.names}
    outputs = {name: torch.cat([block[name] for block in kept]) for name in kept[0]}
    return {"losses": losses, "grad": grad, "change": change, "rows": batches,
            "outputs": outputs}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> Dict:
    """Each leaf's |program norm - reference norm| over the larger of the
    leaf's and the median leaf's reference norm: the largest (and its leaf)
    and the median."""
    moved = [ref[n] for n in names if ref[n] > 0]
    median = float(np.median(moved)) if moved else 0.0
    gaps = []
    for n in names:
        den = max(ref[n], median)
        gap = abs(prog[n] - ref[n]) / den if den > 0 else (0.0 if prog[n] == 0 else float("inf"))
        gaps.append(gap if gap == gap else float("inf"))  # a NaN is the worst
    i = int(np.argmax(gaps))
    return {"value": gaps[i], "at": names[i], "median": float(np.median(gaps))}


def out_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict:
    """The largest, over rows and outputs, of |program - reference| over
    |reference| (norms over the row); infinite where the program lacks an
    output or a row."""
    worst = {"value": 0.0, "at": "no output"}
    for name, r in ref.items():
        p = prog.get(name)
        if p is None or p.shape != r.shape:
            got = "none" if p is None else f"{tuple(p.shape)}"
            return {"value": float("inf"), "at": f"{name}: {got} against {tuple(r.shape)}"}
        gaps = (torch.linalg.vector_norm((p - r).flatten(1), dim=1)
                / torch.linalg.vector_norm(r.flatten(1), dim=1))
        gaps = torch.where(torch.isnan(gaps), torch.inf, gaps)  # a NaN is the worst
        i = int(torch.argmax(gaps))
        if float(gaps[i]) >= worst["value"]:
            worst = {"value": float(gaps[i]), "at": f"{name}, row {i} of {len(gaps)}"}
    return worst


def compare(prog: Dict, ref: Dict, witness: Optional[Dict] = None) -> Dict[str, Dict]:
    """The numbers (see the module docstring), each with the leaf, step or
    row that set it; ``witness``, the reference's run in bf16, gives
    ``grad_median_ratio`` (left out without it; the readings of
    :mod:`benchmark.control` report it)."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    steps = np.abs(lp - lr) / np.abs(lr)
    steps = np.where(np.isfinite(steps), steps, np.inf)
    loss = {"value": float(np.max(steps)), "at": f"step {int(np.argmax(steps)) + 1}",
            "steps": steps.tolist()}
    names = sorted(ref["grad"])
    if set(prog["grad"]) != set(names) or set(prog["change"]) != set(names):
        odd = sorted(set(prog["grad"]) ^ set(names))[:3]
        bad = {"value": float("inf"), "at": f"trained leaves differ: {odd}"}
        return {"loss_gap": loss, "out_gap": out_gap(prog["outputs"], ref["outputs"]),
                "grad_gap": bad, "grad_median": bad, "grad_median_ratio": bad, "change_gap": bad}
    grad = leaf_gaps(prog["grad"], ref["grad"], names)
    median = float(np.median([ref["grad"][n] for n in names]))
    counted = [n for n in names if ref["grad"][n] >= SMALL_GRAD * median]
    change = leaf_gaps(prog["change"], ref["change"], counted)
    change["at"] += f", {len(names) - len(counted)} leaves left out"
    got = {"loss_gap": loss, "out_gap": out_gap(prog["outputs"], ref["outputs"]),
           "grad_gap": grad, "grad_median": {"value": grad["median"], "at": "the median leaf"},
           "change_gap": change}
    if witness is not None:
        round_off = leaf_gaps(witness["grad"], ref["grad"], names)["median"]
        got["grad_median_ratio"] = {"value": grad["median"] / round_off,
                                    "at": f"over bf16's {round_off:.3g}"}
    return got
