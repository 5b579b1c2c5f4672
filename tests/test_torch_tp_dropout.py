"""Dropout under tensor parallel: the tiny supervised step with dropout 0.1
over a (data x model) layout of 1 x 2 ranks (gloo on the CPU, one
``parallel.dryrun.spawn`` whose children import only the port) against the
same step in one process from the same seed.

Both model ranks seed their step generator by data rank, so they draw in
lockstep: the residual branches' masks are the same on both, and the masks
of the attention probabilities and the FFN hidden units are drawn at the
whole tensor's shape and sliced to the rank's heads or units
(``ops.dropout.dropout(shard=...)``), which at one data rank are the masks
the single process draws.  Held: the first step's gradients leaf by leaf to
1e-2 of the leaf's largest entry (f32, the ranks' partial products summed
in another order); the loss of both steps to 1e-5 relative; the parameters
after each step to 1e-3 of the lr beyond two f32 roundings, on the entries
the first step's gradients pin (``dryrun.pinned_mask``), more than 90 % of
them; both ranks' replicated parameters bit for bit.  The mean-teacher step
with dropout is held the same way, its parameters after the first step.

Then the fault the lockstep prevents: a generator seeded per global rank
(``seed_by="rank"``) gives the two model ranks different masks on the
replicated residual stream, so the ranks' parameters part and the step
leaves world 1's; the check sees it.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu_torch.config import MeshConfig
from sound_event_detection_transformer_tpu_torch.parallel import dryrun

torch.set_num_threads(2)
WORLD = 2


def _with_dropout(inp, rate=0.1, **extra):
    cfg = inp["cfg"]
    return dict(inp, cfg=cfg.replace(model=dataclasses.replace(cfg.model, dropout=rate)),
                **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_dropout")
    tiny = dryrun.tiny_inputs("cpu", batch=8, steps=2)
    inputs = {"supervised": _with_dropout(tiny["supervised"]),
              "per_rank": _with_dropout(tiny["supervised"], seed_by="rank"),
              "semi": _with_dropout(tiny["semi"])}
    path = str(work / "inputs.pt")
    torch.save(inputs, path)
    dryrun.spawn(dryrun.run_legs, WORLD, (path, str(work / "out"), list(inputs),
                                          MeshConfig(n_model=2)), str(work), "cpu")
    ref = {name: dryrun.LEGS[inp["leg"]](inp) for name, inp in inputs.items()
           if name != "per_rank"}
    ref["per_rank"] = ref["supervised"]  # at world 1 both seeds are the seed itself
    out = {name: (ref[name], dryrun.load_results(str(work / "out"), name, WORLD), inp)
           for name, inp in inputs.items()}
    shutil.rmtree(work)
    return out


def _params_err(one, got, lr, keys=("params1", "params")):
    """The parameters after each step (``keys``) against world 1's, beyond
    two f32 roundings, in units of the lr, on the entries the first step's
    gradients pin; and the share pinned."""
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in one["grads"].values()))
    eps = 1e-8 / min(1.0, 0.1 / norm)
    worst, n_live, n_all = 0.0, 0, 0
    for name, g in one["grads"].items():
        live = dryrun.pinned_mask(g.numpy(), got["grads"][name].numpy(), eps)
        n_live, n_all = n_live + int(live.sum()), n_all + live.size
        for key in keys:
            p, w = got[key][name].numpy(), one[key][name].numpy()
            if live.any():
                beyond = np.abs(p - w) - 2.5e-7 * np.abs(w)
                worst = max(worst, float(beyond[live].max()) / lr)
    return worst, n_live / n_all


@pytest.mark.parametrize("name", ["supervised", "semi"])
def test_dropout_step_at_1x2_equals_world_1(runs, name):
    one, got, inp = runs[name]
    assert [r["layout"] for r in got] == [[1, 2]] * WORLD and got[0]["n_cut"] == 44
    lr, wd = dryrun.lr_and_decay(inp)
    res = dryrun.compare(one, got, inp["state"], lr, wd)
    assert res["grad_err"] <= 1e-2, res
    assert res["loss_rel"] <= 1e-5 and res["later_rel"] <= 1e-5, res
    # the semi step's second update, through the EMA teacher's pseudo
    # labels, is held by its loss and Adam's bound (compare's in_bound)
    err, pinned = _params_err(one, got[0], lr, ("params1", "params") if name == "supervised"
                              else ("params1",))
    assert err <= 1e-3 and pinned > 0.9, (err, pinned)
    assert res["ok"] and res["ranks_equal"], res


def test_dropout_masks_differ_from_a_step_without_dropout(runs):
    """The dropout draws decide something: the step at rate 0.1 moves the
    loss away from the step at rate 0."""
    one, _, inp = runs["supervised"]
    plain = dryrun.leg_step(_with_dropout(inp, rate=0.0))
    assert abs(plain["loss"][0] - one["loss"][0]) > 1e-3 * abs(one["loss"][0])


def test_a_generator_seeded_per_rank_breaks_the_lockstep(runs):
    """Seeded by global rank, model rank 1 draws other masks than rank 0:
    the replicated parameters part and the loss leaves world 1's."""
    one, got, inp = runs["per_rank"]
    lr, wd = dryrun.lr_and_decay(inp)
    res = dryrun.compare(one, got, inp["state"], lr, wd)
    assert not res["ok"]
    assert not res["ranks_equal"]
    assert not all(got[1]["replicated_equal"])
    assert res["loss_rel"] > 1e-3, res
