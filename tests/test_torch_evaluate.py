"""``train_lib.evaluate`` of the PyTorch port against the JAX package's, on
the same weights (``weights.from_flax`` of one JAX init) and the same
``SyntheticDataset`` seed, f32 at the tiny test geometry, fusion strategies
1, 2 and 3, with the loss weights, the segment and clip metrics and PSDS
over the decode thresholds 0.1-0.9.  The port runs through its feature bank
(the trainer's default), the JAX package through its host batch stream.

Random weights give near-identical boxes for every query and class scores
far below 0.5, so nothing would be detected.  The test moves three biases
of the JAX init: the no-object logit down by 3 (the class scores rise),
the audio-tag logits up by 2 (tags fire) and the box-length logit down by 1
(shorter boxes); on 48 clips that gives event F1 > 0 for strategies 2 and 3
and PSDS > 0 for all three, which the test requires.

Tolerances:

* the event-based F1 per strategy and the three PSDS values to 1e-9: both
  count the same events, provided no score sits at a decode threshold.  The
  test asserts that no score (of either side) lies within 1e-4 of 0.5 or of
  a PSDS threshold, nor an audio-tag probability within 1e-4 of 0.5, unless
  it is that threshold exactly on both sides (strategies 2 and 3 clamp a
  class's best query to 0.5 itself);
* the validation loss means rtol 1e-4 (f32 sums in another order).

Also the ragged tail of ``tests/test_eval_exact.py`` for the port: 6 clips
at batch size 2 (no padding) and 4 (two −1 rows) give the same loss means.
"""
import contextlib
import io

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sound_event_detection_transformer_tpu import metrics as jmetrics
from sound_event_detection_transformer_tpu import train_lib as jtrain_lib
from sound_event_detection_transformer_tpu.config import SEDTConfig as JConfig
from sound_event_detection_transformer_tpu.data.encoder import BoxEncoder as JEncoder
from sound_event_detection_transformer_tpu.data.synthetic import SyntheticDataset as JSynthetic
from sound_event_detection_transformer_tpu.engine import TrainState as JTrainState
from sound_event_detection_transformer_tpu.engine import make_eval_step as jmake_eval_step
from sound_event_detection_transformer_tpu.models import build_model as jbuild
from sound_event_detection_transformer_tpu_torch import train_lib
from sound_event_detection_transformer_tpu_torch.config import SEDTConfig as TConfig
from sound_event_detection_transformer_tpu_torch.data.encoder import BoxEncoder as TEncoder
from sound_event_detection_transformer_tpu_torch.data.feature_bank import FeatureBank
from sound_event_detection_transformer_tpu_torch.data.synthetic import SyntheticDataset as TSynthetic
from sound_event_detection_transformer_tpu_torch.engine import make_eval_step
from sound_event_detection_transformer_tpu_torch.models import build_model as tbuild
from sound_event_detection_transformer_tpu_torch.weights import from_flax

torch.set_num_threads(2)
FUSION = (1, 2, 3)
N_CLIPS, BS, DATA_SEED, WEIGHT_SEED = 48, 4, 1, 0
THRESHOLDS = tuple(np.arange(0.1, 1.0, 0.1))
MARGIN = 1e-4


def _recorded(step, calls, scores_of):
    """``step`` that also keeps what ``scores_of(result)`` reads."""
    def rec(*args):
        res = step(*args)
        calls.append(scores_of(res))
        return res
    rec.device = getattr(step, "device", None)
    return rec


def _scores(res, to_np):
    out = {m: to_np(res[f"pp_{m}"].scores) for m in FUSION}
    out["at"] = to_np(res["at"])
    return out


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = JConfig.tiny_test(), TConfig.tiny_test()
    m = jcfg.model
    classes = list(jcfg.data.classes)
    seconds = jcfg.features.max_len_seconds
    jenc, tenc = JEncoder(classes, seconds), TEncoder(classes, seconds)
    jds = JSynthetic(N_CLIPS, classes, m.max_frames, m.n_mels, jenc.encode_strong_df,
                     max_events=3, seconds=seconds, seed=DATA_SEED)
    tds = TSynthetic(N_CLIPS, classes, m.max_frames, m.n_mels, tenc.encode_strong_df,
                     max_events=3, seconds=seconds, seed=DATA_SEED)

    jmodel, jwd = jbuild(jcfg)
    v = jax.jit(lambda r: jmodel.init({"params": r}, jnp.zeros((1, m.max_frames, m.n_mels, 1)),
                                      jnp.zeros((1, m.max_frames), bool), True))(
        jax.random.PRNGKey(WEIGHT_SEED))
    params = jax.tree.map(np.array, flax.core.unfreeze(v["params"]))
    frozen = jax.tree.map(np.asarray, flax.core.unfreeze(v["frozen"]))
    params["class_embed"]["bias"][-1] -= 3.0
    params["weak_class_embed"]["bias"] += 2.0
    params["bbox_embed"]["layer2"]["bias"][1] -= 1.0

    want = {"loss": {}, "psds": {}, "calls": []}
    real_psds_score = jmetrics.psds_score

    def psds_score(psds, filename_roc_curves=None):
        want["psds"][len(want["psds"]) + 1] = [
            psds.psds(alpha_ct=a, alpha_st=s, max_efpr=100).value
            for a, s in ((0, 0), (1, 0), (0, 1))]
        return real_psds_score(psds, filename_roc_curves)

    jstep = _recorded(jmake_eval_step(jmodel, jwd, jcfg, FUSION), want["calls"],
                      lambda r: _scores(r, np.asarray))
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jmetrics, "psds_score", psds_score)
        want["f1"] = jtrain_lib.evaluate(
            jstep, JTrainState(params, frozen, None, 0), jds, jcfg, jenc, jds.ref_df(), FUSION,
            at=True, cal_seg=True, cal_clip=True, batch_size=BS, psds_thresholds=THRESHOLDS,
            weight_dict=jwd, loss_means_out=want["loss"])

    tmodel, twd = tbuild(tcfg, device="cpu")
    tmodel.load_state_dict(from_flax(params, frozen), strict=True)
    calls = []
    tstep = _recorded(make_eval_step(tmodel, twd, tcfg, FUSION, device="cpu"), calls,
                      lambda r: _scores(r, lambda t: t.numpy()))
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_lib.evaluate(
            tstep, tds, tcfg, tenc, tds.ref_rows(), FUSION, at=True, cal_seg=True,
            cal_clip=True, batch_size=BS, psds_thresholds=THRESHOLDS, weight_dict=twd,
            bank=FeatureBank(tds, torch.device("cpu")))
    got = {"f1": res.f1, "loss": res.loss_means, "psds": res.psds, "timings": res.timings,
           "calls": calls}
    return want, got


def test_no_score_sits_at_a_threshold(both):
    """The precondition of the exact comparisons below."""
    want, got = both
    assert len(want["calls"]) == len(got["calls"]) == N_CLIPS // BS
    for side in (want, got):
        for call in side["calls"]:
            for key, scores in call.items():
                for t in ((0.5,) if key == "at" else (0.5,) + THRESHOLDS):
                    near = (np.abs(scores - t) < MARGIN) & (scores != np.float32(t))
                    assert not near.any(), (key, t, scores[near])
    for w, g in zip(want["calls"], got["calls"]):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=1e-5, rtol=1e-5)


def test_f1_per_strategy_matches_jax(both):
    want, got = both
    assert set(got["f1"]) == set(want["f1"]) == set(FUSION)
    for m in FUSION:
        np.testing.assert_allclose(got["f1"][m], want["f1"][m], rtol=0, atol=1e-9)
    assert max(want["f1"].values()) > 0, "all F1 zero: the comparison would prove nothing"


def test_psds_matches_jax(both):
    want, got = both
    assert set(got["psds"]) == set(want["psds"]) == set(FUSION)
    for m in FUSION:
        np.testing.assert_allclose(got["psds"][m], want["psds"][m], rtol=0, atol=1e-9)
    assert max(max(v) for v in want["psds"].values()) > 0, "every PSDS is zero"


def test_loss_means_match_jax(both):
    want, got = both
    assert set(got["loss"]) == set(want["loss"]) and want["loss"]
    for k, w in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], w, rtol=1e-4, atol=1e-7, err_msg=k)


def test_timings_are_reported(both):
    _, got = both
    t = got["timings"]
    assert t["batches"] == N_CLIPS // BS
    assert all(t[k] >= 0 for k in ("eval_steps_s", "decode_s", "metrics_s", "psds_s"))
    assert t["psds_s"] > 0


@pytest.fixture(scope="module")
def ragged():
    """The port's eval loss means over 6 one-event clips at two batch sizes."""
    cfg = TConfig.tiny_test()
    m = cfg.model
    classes = list(cfg.data.classes)
    enc = TEncoder(classes, seconds=cfg.features.max_len_seconds)
    ds = TSynthetic(6, classes, m.max_frames, m.n_mels, enc.encode_strong_df, max_events=1,
                    seconds=cfg.features.max_len_seconds, seed=3)
    model, wd = tbuild(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    step = make_eval_step(model, wd, cfg, (1,), device="cpu")
    out = {}
    for bs in (2, 4):
        with contextlib.redirect_stdout(io.StringIO()):
            out[bs] = train_lib.evaluate(step, ds, cfg, enc, ds.ref_rows(), [1],
                                         at=cfg.model.dec_at, batch_size=bs,
                                         weight_dict=wd).loss_means
    return out


@pytest.mark.parametrize("bank", [False, True], ids=["host", "bank"])
def test_ragged_tail_means_match_unpadded(ragged, bank):
    """Batch size 4 pads the last batch with two −1 rows; the means equal
    those at batch size 2, which pads nothing (as ``test_eval_exact.py``
    pins for the JAX package, the logging-only cardinality error apart)."""
    m2, m4 = ragged[2], ragged[4]
    assert m2 and m4
    for k in m2:
        if k == "cardinality_error":
            continue
        np.testing.assert_allclose(m4[k], m2[k], rtol=2e-5, atol=1e-6, err_msg=k)
    if bank:  # and through the bank, whose gather reads row 0 for a -1 row
        cfg = TConfig.tiny_test()
        m = cfg.model
        classes = list(cfg.data.classes)
        enc = TEncoder(classes, seconds=cfg.features.max_len_seconds)
        ds = TSynthetic(6, classes, m.max_frames, m.n_mels, enc.encode_strong_df,
                        max_events=1, seconds=cfg.features.max_len_seconds, seed=3)
        model, wd = tbuild(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        with contextlib.redirect_stdout(io.StringIO()):
            out = train_lib.evaluate(make_eval_step(model, wd, cfg, (1,), device="cpu"), ds,
                                     cfg, enc, ds.ref_rows(), [1], batch_size=4, weight_dict=wd,
                                     bank=FeatureBank(ds, torch.device("cpu"))).loss_means
        for k in m4:
            np.testing.assert_allclose(out[k], m4[k], rtol=1e-6, atol=1e-7, err_msg=k)
