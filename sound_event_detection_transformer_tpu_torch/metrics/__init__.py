"""Evaluation metrics: event- and segment-based F1, audio tagging, PSDS.

Counterpart of the JAX package's ``metrics/__init__.py``, on rows in place of
DataFrames: events are ``(filename, onset, offset, event_label, ...)``, and a
file without events is one row whose label is None.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.encoder import missing_label
from .event_based import EventBasedMetrics, SegmentBasedMetrics
from .psds import PSDSEval, PSDSResult, psds_score, write_roc_curves

__all__ = [
    "EventBasedMetrics",
    "SegmentBasedMetrics",
    "PSDSEval",
    "PSDSResult",
    "psds_score",
    "write_roc_curves",
    "event_based_evaluation",
    "segment_based_evaluation",
    "compute_sed_eval_metrics",
    "intermediate_at_measures",
    "macro_f_measure",
    "audio_tagging_results",
    "format_audio_tagging",
    "compute_metrics",
    "compute_psds_from_operating_points",
]


def _event_lists_by_file(rows) -> Dict[str, List[Dict]]:
    """{filename: [{filename, onset, offset, event_label}, ...]} in the rows'
    order (a missing time is NaN, as in a table); a file whose only row has
    no label gets ``[{"filename": f}]``."""
    nan = lambda t: float("nan") if t is None else t
    out: Dict[str, List[Dict]] = {}
    for r in rows:
        fname, on, off, label = r[:4]
        out.setdefault(fname, []).append(
            {"filename": fname, "onset": nan(on), "offset": nan(off), "event_label": label})
    for fname, recs in out.items():
        if len(recs) == 1 and missing_label(recs[0]["event_label"]):
            out[fname] = [{"filename": fname}]
    return out


def _filenames(rows) -> List[str]:
    """Each file once, in the order of its first row."""
    return list(dict.fromkeys(r[0] for r in rows))


def _classes_union(reference, estimated) -> List[str]:
    return sorted({r[3] for r in list(reference) + list(estimated) if not missing_label(r[3])})


def event_based_evaluation(reference, estimated, t_collar: float = 0.200,
                           percentage_of_length: float = 0.2) -> EventBasedMetrics:
    """Event-based scores of ``estimated`` against ``reference`` over the
    reference's files."""
    metric = EventBasedMetrics(_classes_union(reference, estimated), t_collar,
                               percentage_of_length)
    ref_lists, est_lists = _event_lists_by_file(reference), _event_lists_by_file(estimated)
    for fname in _filenames(reference):
        metric.evaluate(ref_lists[fname], est_lists.get(fname, []))
    return metric


def segment_based_evaluation(reference, estimated,
                             time_resolution: float = 1.0) -> SegmentBasedMetrics:
    metric = SegmentBasedMetrics(_classes_union(reference, estimated), time_resolution)
    ref_lists, est_lists = _event_lists_by_file(reference), _event_lists_by_file(estimated)
    for fname in _filenames(reference):
        metric.evaluate(ref_lists[fname], est_lists.get(fname, []))
    return metric


def compute_sed_eval_metrics(predictions, groundtruth, report: bool = True,
                             cal_seg: bool = False):
    """(event-based metric, segment-based metric or None), printed."""
    metric_event = event_based_evaluation(groundtruth, predictions, t_collar=0.200,
                                          percentage_of_length=0.2)
    if report:
        print(metric_event)
    metric_segment = None
    if cal_seg:
        metric_segment = segment_based_evaluation(groundtruth, predictions, time_resolution=1.0)
        print(metric_segment)
    return metric_event, metric_segment


def intermediate_at_measures(encoded_ref: np.ndarray, encoded_est: np.ndarray):
    tp = ((encoded_est + encoded_ref) == 2).sum(axis=0)
    fp = ((encoded_est - encoded_ref) == 1).sum(axis=0)
    fn = ((encoded_ref - encoded_est) == 1).sum(axis=0)
    tn = ((encoded_est + encoded_ref) == 0).sum(axis=0)
    return tp, fp, fn, tn


def macro_f_measure(tp, fp, fn) -> np.ndarray:
    f = np.zeros(tp.shape[-1])
    mask = (2 * tp + fp + fn) != 0
    f[mask] = 2 * tp[mask] / (2 * tp + fp + fn)[mask]
    return f


def _many_hot_by_file(rows, classes: Sequence[str]) -> Dict[str, np.ndarray]:
    """{filename: [C] 0/1} over the files with at least one labelled row."""
    col = {c: i for i, c in enumerate(classes)}
    out: Dict[str, np.ndarray] = {}
    for r in rows:
        if not missing_label(r[3]):
            out.setdefault(r[0], np.zeros(len(classes)))[col[r[3]]] = 1.0
    return out


def audio_tagging_results(reference, estimated) -> Dict[str, Tuple[float, float, float]]:
    """Class-wise clip-level (f, p, r), and their means under ``"avg"``.

    Each side becomes a many-hot vector per file; a file on one side only
    counts as all zeros on the other (the outer merge of the JAX package's
    tables)."""
    classes = _classes_union(reference, estimated)
    ref, est = _many_hot_by_file(reference, classes), _many_hot_by_file(estimated, classes)
    if est:
        files = list(dict.fromkeys(list(ref) + list(est)))
        zeros = np.zeros(len(classes))
        tp, fp, fn, _ = intermediate_at_measures(np.array([ref.get(f, zeros) for f in files]),
                                                 np.array([est.get(f, zeros) for f in files]))
        f = macro_f_measure(tp, fp, fn)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
            r = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    else:
        f = p = r = np.zeros(len(classes))
    data = np.asarray([f, p, r]).T.reshape(len(classes), 3)
    out = {c: tuple(float(v) for v in row) for c, row in zip(classes, data)}
    out["avg"] = tuple(float(v) for v in data.mean(0)) if len(classes) else (0.0, 0.0, 0.0)
    return out


def format_audio_tagging(results: Dict[str, Tuple[float, float, float]]) -> str:
    """The (f, p, r) table, one class a line and ``avg`` last."""
    width = max([len(c) for c in results] + [3])
    lines = [f"{'':<{width}}  {'f':>8}  {'p':>8}  {'r':>8}"]
    lines += [f"{c:<{width}}  {f:8.6f}  {p:8.6f}  {r:8.6f}" for c, (f, p, r) in results.items()]
    return "\n".join(lines)


def compute_metrics(predictions, gtruth, meta=None, cal_seg: bool = True,
                    cal_clip: bool = True) -> float:
    """Event-based macro F1 of ``predictions`` against ``gtruth``, with the
    event-based report printed (and the segment-based and clip-level ones
    with ``cal_seg`` and ``cal_clip``)."""
    predictions = list(predictions)
    if not predictions:
        return 0.0
    events_metric, segments_metric = compute_sed_eval_metrics(
        predictions, gtruth, report=True, cal_seg=cal_seg)
    em = events_metric.results_class_wise_average_metrics()["f_measure"]
    clip_macro_f1 = None
    if cal_clip:
        clip_metric = audio_tagging_results(gtruth, predictions)
        clip_macro_f1 = clip_metric["avg"][0]
        print("Class-wise clip metrics")
        print("=" * 50)
        print(format_audio_tagging(clip_metric))
    if segments_metric is not None:
        sm = segments_metric.results_class_wise_average_metrics()["f_measure"]
        names = ["Eb_F1", "Eb_P", "Eb_R", "Sb_F", "Sb_P", "Sb_R", "At_F1"]
        vals = [em["f_measure"], em["precision"], em["recall"], sm["f_measure"],
                sm["precision"], sm["recall"], clip_macro_f1 or 0]
        print("\nAll Metrics")
        print("=" * 55)
        print("  ".join(f"{n:>7}" for n in names))
        print("  ".join(f"{v * 100:6.2f}%" for v in vals))
        print("=" * 55)
    return em["f_measure"]


def compute_psds_from_operating_points(list_predictions, groundtruth, meta,
                                       dtc_threshold=0.5, gtc_threshold=0.5,
                                       cttc_threshold=0.3) -> PSDSEval:
    psds = PSDSEval(dtc_threshold, gtc_threshold, cttc_threshold, ground_truth=groundtruth,
                    metadata=meta)
    for pred in list_predictions:
        psds.add_operating_point(pred)
    return psds
