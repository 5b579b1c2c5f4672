"""The analytic FLOP count against ``torch.utils.flop_counter`` on the port's
own train step, at each configuration's published widths, batch 1.

Exact: both count two FLOPs a multiply-add of every convolution and matrix
product, the forward and, in the backward, the input gradient where the
input needs one and the weight gradient where the weight trains.  Scaled to
the cells' batches they give 27.372 GFLOP a clip (SEDT, 3+3) and 17,690.6
GFLOP a step (SP-SEDT at batch 200), the figures chip_smoke's counter gave
on the card."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.entries.train_epoch import program_config
from benchmark.traffic import sub_seeds
from sound_event_detection_transformer_tpu_torch import engine
from sound_event_detection_transformer_tpu_torch.models import build_model
from sound_event_detection_transformer_tpu_torch.models.criterion import empty_targets


def counted(config) -> int:
    _, cfg = program_config(config, {"batch": 1}, sub_seeds(0))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    model, wd = build_model(cfg, device="cpu")
    state = engine.init_train_state(model, cfg, 10)
    step = engine.make_train_step(model, wd, cfg, state.optimizer, augment_on=False,
                                  device="cpu")
    n = cfg.model.num_patches if cfg.model.self_sup else 3
    t = empty_targets(1, cfg.model.max_events)
    boxes = t.boxes.clone()
    boxes[:, :n, 0], boxes[:, :n, 1] = torch.linspace(0.2, 0.8, n), 0.1
    valid = torch.arange(cfg.model.max_events)[None] < n
    t = t._replace(boxes=boxes, box_valid=valid, label_valid=valid)
    t_frames = cfg.model.max_frames
    batch = engine.Batch(feats=torch.randn(1, t_frames, cfg.model.n_mels, 1),
                         pad_mask=torch.zeros(1, t_frames, dtype=torch.bool), targets=t,
                         strong=torch.ones(1, dtype=torch.bool), weak=torch.zeros(1, dtype=torch.bool))
    with FlopCounterMode(display=False) as counter:
        step(batch, torch.Generator().manual_seed(0))
    return counter.get_total_flops()


@pytest.mark.parametrize("name, per_clip", [("sedt-urbansed", 27.372290048e9),
                                            ("spsedt-dcase", 88.453214208e9)])
def test_bench_flops_match_the_counter(name, per_clip):
    config = harness.load("configs", name)
    assert flops.step_flops(config, 1) == counted(config) == pytest.approx(per_clip, rel=1e-9)


def test_bench_flops_at_the_cells_batches():
    sp = harness.load("configs", "spsedt-dcase")
    assert flops.step_flops(sp, 200) / 1e9 == pytest.approx(17690.6, abs=0.05)
    sedt = harness.load("configs", "sedt-urbansed")
    assert flops.step_flops(sedt, 256) / 256 / 1e9 == pytest.approx(27.37, abs=0.005)
    assert flops.k1_shape(sp, 200) == (600, 20, 20)
    assert flops.k1_shape(sedt, 256) == (768, 10, 20)
