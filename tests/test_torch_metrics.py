"""The port's metrics on rows against the JAX package's on DataFrames built
from the same rows: event-based and segment-based class-wise and average
F/P/R, the audio-tagging table, the event-based F1 that ``compute_metrics``
returns, and PSDS at (alpha_ct, alpha_st) = (0, 0), (1, 0) and (0, 1) over
several operating points.

The event lists are drawn from seeds: files with no events (a row whose
label is None), estimates on files the reference lacks, a class only in the
reference and one only in the estimates, and estimates jittered from the
reference so that some match.  Tolerance 1e-9 absolute: both sides count the
same matches and sum the same float64 durations.
"""
import contextlib
import io

import numpy as np
import pandas as pd
import pytest

from sound_event_detection_transformer_tpu import metrics as jm
from sound_event_detection_transformer_tpu_torch import metrics as tm

COLS = ["filename", "onset", "offset", "event_label"]
REF_CLASSES = ["a", "b", "c", "d"]  # "d" only in the reference
EST_CLASSES = ["a", "b", "c", "e"]  # "e" only in the estimates
TOL = dict(rtol=0, atol=1e-9)


def _rows(seed):
    """(reference rows, estimated rows with a score, metadata rows)."""
    rng = np.random.RandomState(seed)
    ref, est = [], []
    files = [f"clip_{seed}_{i}.wav" for i in range(14)]
    for f in files:
        n = rng.randint(0, 4)
        if n == 0:
            ref.append((f, None, None, None))
        for _ in range(n):
            on = float(rng.uniform(0, 8.5))
            ref.append((f, on, min(10.0, on + float(rng.uniform(0.3, 3.0))),
                        REF_CLASSES[rng.randint(len(REF_CLASSES))]))
    for f, on, off, lbl in ref:
        if lbl is not None and lbl != "d" and rng.rand() < 0.7:
            j = rng.uniform(-0.3, 0.3, 2)
            est.append((f, max(0.0, on + j[0]), min(10.0, off + j[1]), lbl,
                        float(rng.rand())))
    for f in files + [f"extra_{seed}_{i}.wav" for i in range(3)]:  # false alarms
        for _ in range(rng.randint(0, 2)):
            on = float(rng.uniform(0, 9))
            est.append((f, on, min(10.0, on + float(rng.uniform(0.2, 2.0))),
                        EST_CLASSES[rng.randint(len(EST_CLASSES))], float(rng.rand())))
    ref.append((files[0], 4.0, 6.0, "d"))  # each side's own class, at least once
    est.append((f"extra_{seed}_0.wav", 1.0, 2.5, "e", 0.9))
    meta = [(f, 10.0) for f in dict.fromkeys(r[0] for r in ref)]
    return ref, est, meta


def _df(rows, extra=()):
    return pd.DataFrame(rows, columns=COLS + list(extra))


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_event_and_segment_based_match_jax(seed):
    ref, est, _ = _rows(seed)
    for kind, tfun, jfun in (("event", tm.event_based_evaluation, jm.event_based_evaluation_df),
                             ("segment", tm.segment_based_evaluation,
                              jm.segment_based_evaluation_df)):
        got, want = tfun(ref, est), jfun(_df(ref), _df(est, ["score"]))
        assert got.classes == want.classes == sorted(set(REF_CLASSES) | set(EST_CLASSES))
        gcw, wcw = got.class_wise(), want.class_wise()
        assert gcw.keys() == wcw.keys()
        for c in wcw:
            for k, w in wcw[c].items():
                np.testing.assert_allclose(gcw[c][k], w, err_msg=f"{kind} {c} {k}", **TOL)
        gavg = got.results_class_wise_average_metrics()["f_measure"]
        wavg = want.results_class_wise_average_metrics()["f_measure"]
        for k, w in wavg.items():
            np.testing.assert_allclose(gavg[k], w, err_msg=f"{kind} average {k}", **TOL)
        assert str(got) == str(want)
    assert sum(v["Ntp"] for v in tm.event_based_evaluation(ref, est).class_wise().values()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_audio_tagging_matches_jax(seed):
    ref, est, _ = _rows(seed)
    want = jm.audio_tagging_results(_df(ref), _df(est, ["score"]))
    got = tm.audio_tagging_results(ref, est)
    assert list(got) == list(want.index)
    for c in want.index:
        np.testing.assert_allclose(got[c], want.loc[c, ["f", "p", "r"]].to_numpy(float),
                                   err_msg=c, **TOL)
    assert got["avg"][0] > 0


def test_audio_tagging_without_estimates_is_zero():
    ref, _, _ = _rows(0)
    want = jm.audio_tagging_results(_df(ref), _df([(ref[0][0], None, None, None)]))
    got = tm.audio_tagging_results(ref, [(ref[0][0], None, None, None)])
    for c in want.index:
        np.testing.assert_allclose(got[c], want.loc[c, ["f", "p", "r"]].to_numpy(float), **TOL)
    assert got["avg"] == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_compute_metrics_matches_jax(seed):
    ref, est, _ = _rows(seed)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        want = jm.compute_metrics(_df(est, ["score"]), _df(ref), cal_seg=True, cal_clip=True)
        got = tm.compute_metrics(est, ref, cal_seg=True, cal_clip=True)
    np.testing.assert_allclose(got, want, **TOL)
    assert got > 0 and "All Metrics" in out.getvalue()
    assert tm.compute_metrics([], ref) == jm.compute_metrics(_df([], ["score"]), _df(ref)) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_meta", [True, False], ids=["metadata", "no_metadata"])
def test_psds_matches_jax(seed, with_meta):
    """Operating points: the estimates above each of five score thresholds."""
    ref, est, meta = _rows(seed)
    ops = [[r[:4] for r in est if r[4] >= t] for t in (0.0, 0.2, 0.4, 0.6, 0.8)]
    want = jm.compute_psds_from_operating_points(
        [_df(op) for op in ops], _df(ref),
        pd.DataFrame(meta, columns=["filename", "duration"]) if with_meta else None)
    got = tm.compute_psds_from_operating_points(ops, ref, meta if with_meta else None)
    np.testing.assert_allclose(got.total_hours, want.total_hours, **TOL)
    for a_ct, a_st in ((0, 0), (1, 0), (0, 1)):
        w = want.psds(alpha_ct=a_ct, alpha_st=a_st, max_efpr=100)
        g = got.psds(alpha_ct=a_ct, alpha_st=a_st, max_efpr=100)
        np.testing.assert_allclose(g.value, w.value, **TOL)
        np.testing.assert_allclose(g.efpr_grid, w.efpr_grid, **TOL)
        np.testing.assert_allclose(g.etpr_curve, w.etpr_curve, **TOL)
    assert max(got.psds(alpha_ct=0, alpha_st=0, max_efpr=100).value,
               got.psds(alpha_ct=0, alpha_st=0, max_efpr=1e4).value) > 0
    wf, wpc = want.compute_macro_f_score(_df(ops[2]))
    gf, gpc = got.compute_macro_f_score(ops[2])
    np.testing.assert_allclose(gf, wf, **TOL)
    assert gpc.keys() == wpc.keys()


def test_psds_score_returns_its_scores_and_writes_roc_curves(tmp_path):
    ref, est, meta = _rows(1)
    psds = tm.compute_psds_from_operating_points([[r[:4] for r in est]], ref, meta)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        values = tm.psds_score(psds, filename_roc_curves=str(tmp_path) + "/")
    assert values == [psds.psds(a, s, 100).value for a, s in ((0, 0), (1, 0), (0, 1))]
    assert out.getvalue().count("PSD-Score") == 3
    for tag in ("ct0_st0", "ct1_st0", "ct0_st1"):
        text = (tmp_path / f"psds_roc_{tag}.csv").read_text().splitlines()
        assert text[0] == "curve,efpr_per_hour,tpr" and len(text) > 1


def test_psds_score_lets_errors_through():
    """An error in the scoring propagates (the JAX package prints and
    carries on)."""
    ref, _, meta = _rows(0)
    with pytest.raises(ValueError, match="no operating points"):
        tm.psds_score(tm.PSDSEval(ground_truth=ref, metadata=meta))
