"""Event-based and segment-based detection metrics (sed_eval's rules).

Counterpart of the JAX package's ``metrics/event_based.py``, the same
scorer:

  * an estimated event matches a reference event of the same class when
      |onset_est - onset_ref| <= t_collar  AND
      |offset_est - offset_ref| <= max(t_collar, percentage_of_length *
                                        (offset_ref - onset_ref));
  * per file and class, matches are made unique by maximum bipartite
    matching (scipy's assignment solver gives the maximum cardinality);
  * class-wise totals (Nref, Nsys, Ntp) accumulate across files;
    per-class F1 = 2*Ntp / (Nref + Nsys); the macro average is the mean over
    the evaluated class list.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _group_by_class(event_list) -> Dict:
    """{class: [(onset, offset), ...]} in one pass (label-less rows skipped)."""
    out: Dict = {}
    for e in event_list:
        lbl = e.get("event_label")
        if lbl is None or lbl != lbl:  # None or NaN
            continue
        out.setdefault(lbl, []).append((e["onset"], e["offset"]))
    return out


def _match_events(
    ref: np.ndarray,  # [Nr, 2] (onset, offset)
    est: np.ndarray,  # [Ns, 2]
    t_collar: float,
    percentage_of_length: float,
) -> int:
    """Maximum number of uniquely matched (ref, est) pairs."""
    if len(ref) == 0 or len(est) == 0:
        return 0
    onset_ok = np.abs(est[None, :, 0] - ref[:, None, 0]) <= t_collar
    off_collar = np.maximum(
        t_collar, percentage_of_length * (ref[:, 1] - ref[:, 0])
    )
    offset_ok = np.abs(est[None, :, 1] - ref[:, None, 1]) <= off_collar[:, None]
    hit = onset_ok & offset_ok
    if not hit.any():
        return 0
    from scipy.optimize import linear_sum_assignment

    # maximize matches: cost 0 for hit, 1 otherwise; pad to square implicitly
    cost = 1.0 - hit.astype(np.float64)
    r, c = linear_sum_assignment(cost)
    return int(hit[r, c].sum())


class EventBasedMetrics:
    """Accumulating scorer mirroring sed_eval's event-based metrics."""

    def __init__(
        self,
        event_label_list: Sequence[str],
        t_collar: float = 0.200,
        percentage_of_length: float = 0.2,
    ):
        self.classes = list(event_label_list)
        self.t_collar = t_collar
        self.percentage_of_length = percentage_of_length
        self.stats: Dict[str, Dict[str, float]] = {
            c: {"Nref": 0, "Nsys": 0, "Ntp": 0} for c in self.classes
        }

    def evaluate(self, reference_event_list, estimated_event_list) -> None:
        """Consume one file's (list-of-dict) events, sed_eval-style records:
        {'event_label', 'onset', 'offset'} (label-less rows are empty files).

        One grouping pass per file; classes with neither reference nor
        estimated events contribute nothing (the all-classes scan cost
        files x classes x events at eval scale)."""
        ref_by, est_by = _group_by_class(reference_event_list), _group_by_class(
            estimated_event_list
        )
        for cls in set(ref_by) | set(est_by):
            if cls not in self.stats:
                continue  # labels outside the evaluated class list
            ref = np.asarray(ref_by.get(cls, []), np.float64).reshape(-1, 2)
            est = np.asarray(est_by.get(cls, []), np.float64).reshape(-1, 2)
            ntp = _match_events(ref, est, self.t_collar, self.percentage_of_length)
            s = self.stats[cls]
            s["Nref"] += len(ref)
            s["Nsys"] += len(est)
            s["Ntp"] += ntp

    def class_wise(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for cls, s in self.stats.items():
            tp = s["Ntp"]
            fp = s["Nsys"] - tp
            fn = s["Nref"] - tp
            denom = 2 * tp + fp + fn
            f = 2 * tp / denom if denom > 0 else 0.0
            p = tp / s["Nsys"] if s["Nsys"] > 0 else 0.0
            r = tp / s["Nref"] if s["Nref"] > 0 else 0.0
            out[cls] = {"f_measure": f, "precision": p, "recall": r, **s}
        return out

    def results_class_wise_average_metrics(self) -> Dict:
        cw = self.class_wise()
        fs = [v["f_measure"] for v in cw.values()]
        ps = [v["precision"] for v in cw.values()]
        rs = [v["recall"] for v in cw.values()]
        return {
            "f_measure": {
                "f_measure": float(np.mean(fs)) if fs else 0.0,
                "precision": float(np.mean(ps)) if ps else 0.0,
                "recall": float(np.mean(rs)) if rs else 0.0,
            }
        }

    def __str__(self) -> str:
        lines = [
            "Event based metrics (onset-offset)",
            f"  t_collar: {self.t_collar:.3f} s, length collar: "
            f"{self.percentage_of_length * 100:.0f}%",
            f"  {'Class':<30}{'Nref':>6}{'Nsys':>6}{'F':>8}{'P':>8}{'R':>8}",
        ]
        for cls, v in self.class_wise().items():
            lines.append(
                f"  {cls:<30}{v['Nref']:>6.0f}{v['Nsys']:>6.0f}"
                f"{v['f_measure'] * 100:>7.1f}%{v['precision'] * 100:>7.1f}%"
                f"{v['recall'] * 100:>7.1f}%"
            )
        avg = self.results_class_wise_average_metrics()["f_measure"]
        lines.append(
            f"  {'macro-average':<30}{'':>12}{avg['f_measure'] * 100:>7.1f}%"
            f"{avg['precision'] * 100:>7.1f}%{avg['recall'] * 100:>7.1f}%"
        )
        return "\n".join(lines)


class SegmentBasedMetrics:
    """Fixed-resolution segment activity scorer
    (sed_eval.sound_event.SegmentBasedMetrics semantics, 1 s default)."""

    def __init__(self, event_label_list: Sequence[str], time_resolution: float = 1.0):
        self.classes = list(event_label_list)
        self.res = time_resolution
        self.stats = {c: {"Nref": 0, "Nsys": 0, "Ntp": 0} for c in self.classes}

    def evaluate(self, reference_event_list, estimated_event_list) -> None:
        def grid(pairs, n_seg):
            g = np.zeros(n_seg, dtype=bool)
            for on, off in pairs:
                lo = int(np.floor(on / self.res))
                hi = int(np.ceil(off / self.res))
                g[lo : max(hi, lo + 1)] = True
            return g

        max_off = 0.0
        for e in list(reference_event_list) + list(estimated_event_list):
            if "offset" in e:
                max_off = max(max_off, float(e["offset"]))
        n_seg = max(int(np.ceil(max_off / self.res)), 1)
        ref_by, est_by = _group_by_class(reference_event_list), _group_by_class(
            estimated_event_list
        )
        for cls in set(ref_by) | set(est_by):
            if cls not in self.stats:
                continue
            r = grid(ref_by.get(cls, ()), n_seg)
            s = grid(est_by.get(cls, ()), n_seg)
            st = self.stats[cls]
            st["Nref"] += int(r.sum())
            st["Nsys"] += int(s.sum())
            st["Ntp"] += int((r & s).sum())

    def class_wise(self):
        out = {}
        for cls, s in self.stats.items():
            tp = s["Ntp"]
            fp = s["Nsys"] - tp
            fn = s["Nref"] - tp
            denom = 2 * tp + fp + fn
            out[cls] = {
                "f_measure": 2 * tp / denom if denom > 0 else 0.0,
                "precision": tp / s["Nsys"] if s["Nsys"] > 0 else 0.0,
                "recall": tp / s["Nref"] if s["Nref"] > 0 else 0.0,
                **s,
            }
        return out

    def results_class_wise_average_metrics(self):
        cw = self.class_wise()
        return {
            "f_measure": {
                "f_measure": float(np.mean([v["f_measure"] for v in cw.values()]) if cw else 0.0),
                "precision": float(np.mean([v["precision"] for v in cw.values()]) if cw else 0.0),
                "recall": float(np.mean([v["recall"] for v in cw.values()]) if cw else 0.0),
            }
        }

    def __str__(self) -> str:
        avg = self.results_class_wise_average_metrics()["f_measure"]
        return (
            f"Segment based metrics ({self.res:.1f} s): "
            f"F {avg['f_measure'] * 100:.1f}% P {avg['precision'] * 100:.1f}% "
            f"R {avg['recall'] * 100:.1f}%"
        )
