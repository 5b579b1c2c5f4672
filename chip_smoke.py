#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

It builds every kernel of the evaluation path from the sources in the
repository (kernel K1, ``csrc/hungarian_jv.cu``, with nvcc for sm_90a), then:

1. prints the card's name and power limit and the build time;
2. holds K1 against its plain PyTorch version on the card and against scipy
   on the host, at [192, 10, 20], [192, 20, 20] and [1200, 20, 20] with
   random, tie-heavy and BIG-padded costs;
3. runs the evaluation step at the tiny f32 geometry on the CPU and on the
   card from the same weights, and compares the two (TF32 off, to 1e-3);
4. drives the flagship URBAN-SED evaluation step through ``build_model`` and
   ``make_eval_step``: ResNet-50 DC5, 3+3 layers, d 256, 8 heads, FFN 2048,
   10 queries plus the ``dec_at`` query, 20 target slots, 500x64 input,
   batch 64, f32 parameters from a seeded generator, bf16 autocast.  One
   warm-up step, whose Hungarian cost is re-solved by the plain version,
   then 20 timed steps with the launch counters set to 0 before and read
   after;
5. times K1 and its plain version on the step's own cost with CUDA events;
6. splits a step into forward, criterion and post-processing, profiles
   three steps and writes the profiler's table to ``chiprun_out/``.

It ends with a ``{"kernels": [...]}`` line, the card line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sound_event_detection_transformer_tpu_torch.config import SEDTConfig
from sound_event_detection_transformer_tpu_torch.data.dataset import collate
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset
from sound_event_detection_transformer_tpu_torch.engine import make_eval_step
from sound_event_detection_transformer_tpu_torch.models import (
    build_model,
    postprocess,
    set_criterion,
    total_loss,
)
from sound_event_detection_transformer_tpu_torch.ops import hungarian, matcher

# One H100 SXM at its 700 W limit (NVIDIA data sheet): device memory rate and
# the f32 rate outside the tensor cores, the type K1 computes in.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per live column in one Dijkstra expansion of K1: two
# subtractions, a compare and two selects to relax, a compare-select for the
# minimum, two updates of the potentials.
K1_OPS_PER_COLUMN = 8
K1_SHAPES = [(192, 10, 20), (192, 20, 20), (1200, 20, 20)]
K1_COST_KINDS = ("random", "ties", "big")
SECONDS = 10.0
FUSION = (1, 2, 3)
STEPS = 20  # timed evaluation steps
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_kernels() -> float:
    """Start every kernel's nvcc build together; returns the wall seconds."""
    builders = [lambda: hungarian.build_library(verbose=True)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(builders)) as pool:
        for fut in [pool.submit(b) for b in builders]:
            fut.result()
    return time.perf_counter() - t0


# --------------------------------------------------------------------- K1


def k1_costs(rng: np.random.RandomState, shape, kind: str) -> np.ndarray:
    if kind == "random":
        return (rng.randn(*shape) * rng.uniform(0.1, 10)).astype(np.float32)
    if kind == "ties":  # small integers: many optimal assignments
        return rng.randint(0, 3, shape).astype(np.float32)
    costs = rng.randn(*shape).astype(np.float32)  # BIG-padded target slots
    costs[:, :, rng.randint(0, shape[2] + 1):] = matcher.BIG
    return costs


def assignment_cost(costs: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Per-problem cost of a row-for-column assignment, after checking that
    every row is used once and exactly the nc - nr free columns hold -1."""
    b, nr, nc = costs.shape
    assert out.shape == (b, nc), out.shape
    total = np.zeros(b)
    for i in range(b):
        cols = np.nonzero(out[i] >= 0)[0]
        rows = out[i][cols]
        assert sorted(rows.tolist()) == list(range(nr)), (i, out[i])
        assert len(cols) == nr and (out[i] == -1).sum() == nc - nr, (i, out[i])
        total[i] = costs[i][rows, cols].astype(np.float64).sum()
    return total


def k1_against_references(costs: np.ndarray, dev: torch.device, label: str) -> float:
    """K1 and its plain version against scipy on one batch of problems; returns
    the largest |cost(K1) - optimum|.  Raises past 1e-2 * max(1, |optimum|)."""
    cost_dev = torch.from_numpy(costs).to(dev)
    kernel = hungarian.lsap(cost_dev).cpu().numpy()
    plain = hungarian.lsap_plain(cost_dev).cpu().numpy()
    best = np.array([costs[i][linear_sum_assignment(costs[i])].astype(np.float64).sum()
                     for i in range(costs.shape[0])])
    tol = 1e-2 * np.maximum(1.0, np.abs(best))
    err_k = np.abs(assignment_cost(costs, kernel) - best)
    err_p = np.abs(assignment_cost(costs, plain) - best)
    if not (err_k <= tol).all() or not (err_p <= tol).all():
        raise AssertionError(f"K1 parity failed at {label}: kernel {err_k.max()}, "
                             f"plain {err_p.max()}")
    return float(err_k.max())


def jv_expansions(costs: np.ndarray) -> int:
    """Dijkstra expansions that JV makes on these problems: the data-dependent
    part of K1's work (the same insertion order and tie-break)."""
    total = 0
    for a in costs.astype(np.float32):
        nr, nc = a.shape
        u = np.zeros(nr + 1, np.float32)
        v = np.zeros(nc + 1, np.float32)
        p = np.zeros(nc + 1, np.int64)
        for i in range(1, nr + 1):
            p[0] = i
            j0 = 0
            minv = np.full(nc + 1, np.inf, np.float32)
            used = np.zeros(nc + 1, bool)
            way = np.zeros(nc + 1, np.int64)
            while True:
                total += 1
                used[j0] = True
                i0 = p[j0]
                live = ~used
                live[0] = False
                cur = np.zeros(nc + 1, np.float32)
                cur[1:] = a[i0 - 1] - u[i0] - v[1:]
                better = live & (cur < minv)
                minv[better] = cur[better]
                way[better] = j0
                j1 = int(np.argmin(np.where(live, minv, np.inf)))
                delta = minv[j1]
                u[p[used]] += delta
                v[used] -= delta
                minv[~used] -= delta
                j0 = j1
                if p[j0] == 0:
                    break
            while j0:
                j1 = way[j0]
                p[j0] = p[j1]
                j0 = j1
    return total


def k1_bound(cost: torch.Tensor) -> dict:
    """The least time K1 could take on ``cost``: the bytes it must move (the
    cost read once, the int32 answer written once) over the memory rate,
    against its f32 operations over the f32 rate."""
    b, nr, nc = cost.shape
    nbytes = cost.numel() * 4 + b * nc * 4
    expansions = jv_expansions(cost.cpu().numpy())
    ops = expansions * (nc + 1) * K1_OPS_PER_COLUMN
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"ms": max(bytes_ms, ops_ms), "by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "expansions": expansions, "ops": ops,
            "ops_ms": ops_ms}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls, with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


# ------------------------------------------------------------ evaluation


def make_batches(cfg: SEDTConfig, batch: int, n_batches: int, seed: int):
    m = cfg.model
    enc = BoxEncoder(cfg.data.classes, SECONDS)
    ds = SyntheticDataset(batch * n_batches, cfg.data.classes, m.max_frames, m.n_mels,
                          enc.encode_strong_df, max_events=5, seconds=SECONDS, seed=seed)
    batches = [collate([ds[i] for i in range(k * batch, (k + 1) * batch)], m.max_events,
                       SECONDS, indexes=range(k * batch, (k + 1) * batch))
               for k in range(n_batches)]
    return enc, batches


def check_eval_result(res: dict, wd: dict, cfg: SEDTConfig, batch: int) -> None:
    """Finite values of the expected shapes, and the weight dict's losses: every
    final-layer loss, and the aux layers' set losses (the weight dict also
    names aux copies of the audio-tag losses, which no layer computes)."""
    m = cfg.model
    losses = res["losses"]
    weighted = {k for k in wd if not k[-1].isdigit()} | {
        f"{k}_{i}" for k in ("loss_ce", "loss_bbox", "loss_giou") for i in range(m.dec_layers - 1)}
    logged = {"class_error", "cardinality_error"} | {
        f"cardinality_error_{i}" for i in range(m.dec_layers - 1)}
    assert weighted <= set(wd) and set(losses) == weighted | logged, sorted(losses)
    for k, v in losses.items():
        assert v.dim() == 0 and torch.isfinite(v).item(), (k, v)
    assert torch.isfinite(total_loss(losses, wd)).item()
    if m.dec_at:
        at = res["at"]
        assert at.shape == (batch, m.num_classes) and ((at >= 0) & (at <= 1)).all().item()
    for at_m in FUSION:
        pp = res[f"pp_{at_m}"]
        assert pp.scores.shape == (batch, m.num_queries) and torch.isfinite(pp.scores).all().item()
        assert ((pp.labels >= 0) & (pp.labels < m.num_classes)).all().item()
        assert pp.boxes.shape == (batch, m.num_queries, 2) and torch.isfinite(pp.boxes).all().item()


def small_reference(dev: torch.device, seed: int) -> float:
    """The tiny f32 evaluation step on the card against the same step on the
    CPU (where K1 is its plain version); returns the largest loss difference."""
    cfg = SEDTConfig.tiny_test()
    _, batches = make_batches(cfg, 4, 1, seed)
    valid = torch.tensor([True, True, True, False])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for d in (torch.device("cpu"), dev):
        model, wd = build_model(cfg, device=d, generator=torch.Generator().manual_seed(seed))
        res[d.type] = make_eval_step(model, wd, cfg, FUSION, device=d)(batches[0], valid)
    torch.backends.cudnn.allow_tf32 = tf32
    ref, got = res["cpu"], res["cuda"]
    check_eval_result(got, wd, cfg, 4)
    worst = 0.0
    for k, r in ref["losses"].items():
        g = got["losses"][k].cpu()
        assert torch.allclose(g, r, rtol=1e-3, atol=1e-3), (k, g, r)
        worst = max(worst, float((g - r).abs()))
    for at_m in FUSION:
        for g, r in zip(got[f"pp_{at_m}"], ref[f"pp_{at_m}"]):
            assert torch.allclose(g.cpu().float(), r.float(), rtol=1e-3, atol=1e-3), at_m
    return worst


def profile_step(model, step, cfg, batch_cpu, valid, card: str) -> None:
    """Forward / criterion / post-processing split of one step (CUDA events)
    and a torch.profiler table of three steps, written to chiprun_out/."""
    dev = next(model.parameters()).device
    feats, pad = batch_cpu.feats.to(dev), batch_cpu.pad_mask.to(dev)
    targets = type(batch_cpu.targets)(*(t.to(dev) for t in batch_cpu.targets))
    strong = batch_cpu.strong.to(dev) & valid.to(dev)
    with torch.inference_mode():
        out = model(feats, pad)
        at = (out["at"] > 0.5).float()
        parts = {
            "forward": lambda: model(feats, pad),
            "criterion": lambda: set_criterion(out, targets, strong, None, cfg.model, cfg.loss),
            "postprocess": lambda: [postprocess(out, targets.orig_size, at, at_m=m)
                                    for m in FUSION],
        }
        for name, fn in parts.items():
            print(f"eval step part {name}: {cuda_ms(fn, 10):.4f} ms/batch ({card})")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch_cpu, valid)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    print(f"profiled 3 steps: device busy {busy_us / 3e3:.3f} ms/step in "
          f"{sum(r[2] for r in rows) // 3} kernels and copies, {wall_us / 3e3:.3f} ms/step wall "
          f"under the profiler, idle share {1 - busy_us / wall_us:.4f} ({card})")
    lines = [f"{t / 3e3:10.4f} ms/step {c // 3:6d}/step  {k[:140]}" for k, t, c in rows]
    for line in lines[:12]:
        print("  " + line)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "eval_step_profile.txt").write_text(
        f"{card}\n" + "\n".join(lines) + "\n\n"
        + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke run needs one GPU")
    dev = torch.device("cuda", 0)

    # 1. environment and build
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}")
    build_s = build_kernels()
    print(f"kernel build: {build_s:.2f} s ({card})")

    # 2. K1 on the card against its plain version and scipy
    rng = np.random.RandomState(SEED)
    k1_err = 0.0
    for shape in K1_SHAPES:
        for kind in K1_COST_KINDS:
            err = k1_against_references(k1_costs(rng, shape, kind), dev, f"{shape} {kind}")
            k1_err = max(k1_err, err)
            print(f"K1 parity {list(shape)} {kind}: ok, max |cost - optimum| {err:.3g}")
    torch.cuda.synchronize()

    # 3. the evaluation step on the card against the CPU, small and f32
    worst = small_reference(dev, SEED)
    print(f"tiny f32 eval step, card vs CPU: ok, max |loss difference| {worst:.3g}")

    # 4. the flagship evaluation step
    cfg = SEDTConfig.urbansed_supervised()
    m = cfg.model
    batch = cfg.data.batch_size
    model, wd = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    enc, batches = make_batches(cfg, batch, 2, SEED)
    valid = torch.ones(batch, dtype=torch.bool)
    step = make_eval_step(model, wd, cfg, FUSION, device=dev)
    print(f"flagship: {m.backbone} dilation={m.dilation} enc/dec {m.enc_layers}/{m.dec_layers} "
          f"d {m.hidden_dim} heads {m.nheads} ffn {m.dim_feedforward} queries {m.num_queries}"
          f"+dec_at slots {m.max_events} input {m.max_frames}x{m.n_mels} batch {batch} "
          f"compute {m.compute_dtype}, {n_params} parameters")

    seen = []  # the warm-up step's Hungarian cost, as the step hands it to K1
    matcher.lsap = lambda cost: (seen.append(cost.clone()), hungarian.lsap(cost))[1]
    res = step(batches[0], valid)
    matcher.lsap = hungarian.lsap
    torch.cuda.synchronize()
    check_eval_result(res, wd, cfg, batch)
    (cost,) = seen
    assert cost.shape == (m.dec_layers * batch, m.num_queries, m.max_events), cost.shape
    step_err = k1_against_references(cost.cpu().numpy(), dev, "the step's own cost")
    k1_err = max(k1_err, step_err)
    print(f"K1 on the step's own cost {list(cost.shape)}: ok vs plain and scipy, "
          f"max |cost - optimum| {step_err:.3g}")
    pp = res["pp_1"]
    decoded = enc.decode_strong_batch(pp.scores.cpu().numpy(), pp.labels.cpu().numpy(),
                                      pp.boxes.cpu().numpy(), threshold=0.0)
    n_events = sum(len(v) for v in decoded.values())
    assert n_events > 0
    print(f"decoded {n_events} events over {len(decoded)} clips at threshold 0 "
          f"(random weights); losses: "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in sorted(res['losses'].items())
                      if not k[-1].isdigit()))

    hungarian.lsap.launches = 0  # the main path: counts from here ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        res = step(batches[i % len(batches)], valid)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS
    launches = {"K1": hungarian.lsap.launches}  # ... to here
    check_eval_result(res, wd, cfg, batch)
    for name, n in launches.items():
        assert n == STEPS, f"{name} launched {n} times in {STEPS} steps"
    print(f"eval step: {step_s * 1e3:.3f} ms/batch, {batch / step_s:.1f} clips/s, "
          f"{STEPS} steps, batch {batch} ({card})")

    # 5. K1 timings on the step's own cost
    k1_ms = cuda_ms(lambda: hungarian.lsap(cost), 200)
    plain_ms = cuda_ms(lambda: hungarian.lsap_plain(cost), 5, warmup=1)
    bound = k1_bound(cost)
    print(f"K1 {list(cost.shape)}: {k1_ms:.5f} ms, plain version {plain_ms:.3f} ms, "
          f"bound {bound['ms']:.7f} ms by {bound['by']} ({card})")
    print(f"K1 bound: {bound['bytes']} B in {bound['bytes_ms']:.7f} ms; {bound['expansions']} "
          f"expansions, {bound['ops']} f32 operations in {bound['ops_ms']:.7f} ms")

    profile_step(model, step, cfg, batches[0], valid, card)

    kernels = [{
        "name": "K1 hungarian_jv",
        "route": "cuda",
        "source": "sound_event_detection_transformer_tpu_torch/csrc/hungarian_jv.cu",
        "replaces": "sound_event_detection_transformer_tpu/ops/pallas/hungarian.py:302",
        "tpu_kernel": "_jv_lane_kernel",
        "shape": list(cost.shape),
        "launches": launches["K1"],
        "parity": "ok",
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["ms"],
        "bound_by": bound["by"],
        "library_ms": None,  # no PyTorch call computes a linear sum assignment
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
