"""A run with the timed path broken underneath comes out not correct, and
the control (the reference in float8 in the program's place) fails the
cell's limits.  Tiny sizes on the CPU, the port in float32 and tiny limits:
the faults read far above round-off."""
import pytest
import torch

from benchmark import control, harness
from benchmark.reference import check as ref_check
from benchmark.tests import tiny

CELLS = ["sedt-urbansed.train-b256", "spsedt-dcase.pretrain-b200"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_bench_fault_makes_the_run_not_correct(cell, fault):
    with control.FAULTS[fault]():
        result, lines = tiny.run(cell, f32=True)
    assert result["correct"] is False, lines
    worst = max(float(c["value"]) / c["limit"] for c in result["checks"].values())
    assert worst > 10, lines


@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_fails_the_cells_limits(cell):
    from benchmark import traffic as T

    w = harness.load("workloads", cell)
    config, traffic = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    seed = 7
    seeds = T.sub_seeds(seed)
    clips = T.make_clips(config["train_clips"], 128, 64, config["model"]["num_classes"],
                         traffic, seeds, torch.device("cpu"))
    cpu = torch.device("cpu")
    low = ref_check.readings(config, traffic, clips, seed, cpu, mode="fp8")
    ref = ref_check.readings(config, traffic, clips, seed, cpu)
    got = ref_check.compare(low, ref, ref_check.readings(config, traffic, clips, seed, cpu,
                                                         mode="bf16"))
    assert any(got[k]["value"] > limit for k, limit in w["limits"].items()), got
