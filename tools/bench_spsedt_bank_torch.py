#!/usr/bin/env python3
"""A/B the SP-SEDT data loop on the PyTorch port: batches collated on the
host and copied, against features gathered from a device-resident bank.

The port's counterpart of ``tools/bench_spsedt_bank.py``, with its constants:
``profile_spsedt_torch``'s geometry (ResNet-50 DC5, 6+6 layers, 20 queries
from ``P`` = 10 patches, feature reconstruction, bf16) at batch ``B`` = 200,
``STEPS`` = 8 steps a loop over ``4 * B`` unlabeled synthetic clips at
496 x 64 (each batch draws fresh patch boxes).  It times the whole loop,
the host's target work, the transfer or gather and the step, both ways:

* ``inline``: the loop collates every clip's features and targets
  (``data/dataset.collate``) on its own critical path, with no prefetch
  thread, as the JAX tool's loop does, and the step copies them;
* ``bank``: the features live in a ``data/feature_bank.FeatureBank`` on the
  card; ``data/dataset.batch_iterator`` builds only the targets, on its
  prefetch thread (the port's iterator always prefetches), and the loop
  gathers the rows.

The two loops draw the same batches, so from the same weights, optimizer
state and generator they must return the same losses: the tool checks that
(cuDNN's deterministic algorithms on, so that a repeat gives the same bits)
before it times them, then prints clips/s of each loop, best of 3, with
the card's name and power limit.

    python3 tools/bench_spsedt_bank_torch.py

Runs on ``cuda:0``; without a GPU it raises unless given ``--device cpu``
(the tests' mode, where both loops run on the host).
"""
from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from profile_spsedt_torch import spsedt_config  # noqa: E402
from profile_step_torch import TrainSetup, train_setup  # noqa: E402
from sound_event_detection_transformer_tpu_torch.data.dataset import (  # noqa: E402
    batch_iterator,
    collate,
)
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder  # noqa: E402
from sound_event_detection_transformer_tpu_torch.data.feature_bank import (  # noqa: E402
    FeatureBank,
)
from sound_event_detection_transformer_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDataset,
)
from sound_event_detection_transformer_tpu_torch.models import resolve_device  # noqa: E402
from sound_event_detection_transformer_tpu_torch.utils.profiler import card_of  # noqa: E402

B, P, STEPS = 200, 10, 8
SEED = 0


def make_dataset(cfg, n_clips: int) -> SyntheticDataset:
    """``n_clips`` unlabeled synthetic clips at the config's geometry, each
    read drawing ``num_patches`` patch boxes from the dataset's stream."""
    m = cfg.model
    enc = BoxEncoder(1, seconds=cfg.features.max_len_seconds, generate_patch=True)
    return SyntheticDataset(n_clips, list(cfg.data.classes), m.max_frames, m.n_mels,
                            enc.encode_strong_df, max_events=2, seed=SEED, unlabel=True,
                            num_patches=m.num_patches, rng=np.random.RandomState(SEED))


def index_batches(n_clips: int, batch: int, steps: int) -> list:
    """The JAX tool's batches: consecutive runs of the clips, wrapping."""
    order = np.arange(n_clips)
    return [order[(b * batch) % n_clips:(b * batch) % n_clips + batch].tolist()
            for b in range(steps)]


def run_loop(s: TrainSetup, ds, batches: list, bank=None) -> tuple:
    """One pass of the loop, the patch boxes drawn afresh from the dataset's
    seed: (seconds to the last loss on the host, the losses).  Without
    ``bank`` each batch is collated in the loop; with it the iterator's
    thread builds the targets and the loop gathers the features."""
    cfg = s.cfg
    m, secs = cfg.model.max_events, cfg.features.max_len_seconds
    ds.patch_rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    if bank is None:
        loop = (collate([ds[i] for i in idxs], m, secs) for idxs in batches)
    else:
        loop = (b._replace(feats=bank.gather(b.indexes), indexes=None)
                for b in batch_iterator(ds, batches, m, secs, bank=bank,
                                        pin_memory=s.step.device.type == "cuda"))
    losses = []
    for batch in loop:
        losses.append(s.step(batch, s.gen)["loss"].clone())  # a replay overwrites it
    losses = torch.stack(losses).cpu()  # the barrier
    return time.perf_counter() - t0, losses


def same_losses(s: TrainSetup, ds, bank, batches: list) -> tuple:
    """Both loops from the same weights, optimizer state and generator, under
    cuDNN's deterministic algorithms; the state is restored after each.
    Returns (inline losses, bank losses)."""
    model = copy.deepcopy(s.model.state_dict())
    opt = copy.deepcopy(s.optimizer.state_dict())
    gen = s.gen.get_state()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for b in (None, bank):
            out.append(run_loop(s, ds, batches, b)[1])
            s.model.load_state_dict(model)
            s.optimizer.load_state_dict(opt)
            s.gen.set_state(gen)
    finally:
        torch.backends.cudnn.deterministic = saved
    return tuple(out)


def bench(s: TrainSetup, ds, steps: int = STEPS, repeats: int = 3) -> dict:
    """The check, then each loop warmed once and timed ``repeats`` times:
    ``{"losses": (inline, bank), "seconds": {loop: [s, ...]}, "steps": n}``,
    ``steps`` the train steps taken in all.  Raises when the losses differ."""
    bank = FeatureBank(ds, s.step.device)
    batches = index_batches(len(ds), s.cfg.data.batch_size, steps)
    inline, banked = same_losses(s, ds, bank, batches)
    if not torch.equal(inline, banked):
        raise AssertionError(f"the loops' losses differ: inline {inline.tolist()}, bank "
                             f"{banked.tolist()}")
    seconds = {"inline": [], "bank": []}
    for name, b in (("inline", None), ("bank", bank)):
        run_loop(s, ds, batches, b)  # warm-up
        seconds[name] = [run_loop(s, ds, batches, b)[0] for _ in range(repeats)]
    return {"losses": (inline, banked), "seconds": seconds,
            "steps": steps * (2 + 2 * (1 + repeats))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default cuda:0; cpu for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or "cuda:0")
    card = card_of(dev)
    cfg = spsedt_config(B, P)
    s = train_setup(cfg, dev, augment_on=False)
    res = bench(s, make_dataset(cfg, 4 * B))
    clips = STEPS * B
    print(f"losses equal over {STEPS} steps: {res['losses'][0].tolist()} ({card})")
    for name, ts in res["seconds"].items():
        print(f"{name + ':':7s} {min(ts):.3f}s best of {['%.3f' % t for t in ts]} -> "
              f"{clips / min(ts):.0f} clips/s ({card})")
    return res


if __name__ == "__main__":
    main()
