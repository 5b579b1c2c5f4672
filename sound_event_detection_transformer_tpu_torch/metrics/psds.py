"""Polyphonic Sound Detection Score (PSDS).

Counterpart of the JAX package's ``metrics/psds.py``, the same definitions
(Bilen et al., ICASSP 2020):

  * DTC: a detection is valid when its total intersection with same-class
    ground truths covers >= dtc_threshold of the detection's duration;
  * GTC: a ground truth counts as TP when DTC-valid detections cover
    >= gtc_threshold of its duration;
  * invalid detections are FPs; a FP cross-triggers class k when it overlaps
    k's ground truth by >= cttc_threshold of its duration;
  * per class and operating point: TPR = TP / Nref,
    FPR = FPs per hour of dataset audio, CTR_{c,k} = cross-triggers per hour
    of class-k ground-truth duration;
  * PSDS(alpha_ct, alpha_st, max_efpr): monotone per-class TPR staircases over
    eFPR = FPR + alpha_ct * mean CTR, effective TPR
    mu(e) = mean_c - alpha_st * std_c, area under mu up to max_efpr divided by
    max_efpr.

Tables are rows: ground truth and detections ``(filename, onset, offset,
event_label, ...)`` (a None label marks a file without events), metadata
``(filename, duration)``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.encoder import missing_label


@dataclass
class PSDSResult:
    value: float
    alpha_ct: float
    alpha_st: float
    max_efpr: float
    efpr_grid: np.ndarray
    etpr_curve: np.ndarray
    # per-class monotone TPR envelopes over eFPR: {class: (efpr[], tpr[])}
    per_class_curves: Optional[Dict[str, tuple]] = None


def _by_file_class(rows, classes=None) -> Dict:
    """Rows -> {filename: {class: (onset[], offset[]) float arrays}}, each
    group in the rows' order.  Rows without a label are skipped, and so are
    labels outside ``classes`` when it is given."""
    lists: Dict = {}
    for r in rows:
        fname, on, off, label = r[:4]
        if missing_label(label) or (classes is not None and label not in classes):
            continue
        pair = lists.setdefault(fname, {}).setdefault(label, ([], []))
        pair[0].append(on)
        pair[1].append(off)
    return {f: {c: (np.asarray(on, float), np.asarray(off, float)) for c, (on, off) in by.items()}
            for f, by in lists.items()}


def _pair_intersections(d_on, d_off, g_on, g_off) -> np.ndarray:
    """[D, G] pairwise interval intersections."""
    return np.clip(np.minimum(d_off[:, None], g_off[None, :])
                   - np.maximum(d_on[:, None], g_on[None, :]), 0.0, None)


class PSDSEval:
    def __init__(
        self,
        dtc_threshold: float = 0.5,
        gtc_threshold: float = 0.5,
        cttc_threshold: float = 0.3,
        ground_truth: Sequence[Tuple] = (),
        metadata: Optional[Sequence[Tuple[str, float]]] = None,
    ):
        self.dtc = dtc_threshold
        self.gtc = gtc_threshold
        self.cttc = cttc_threshold
        self.gt = list(ground_truth)
        self.metadata = metadata
        labeled = [r for r in self.gt if not missing_label(r[3])]
        self.classes = sorted({r[3] for r in labeled})
        if metadata is not None:
            self.total_hours = float(np.sum([d for _, d in metadata])) / 3600.0
        else:
            # one clip = its last offset, at least 10 s; a file whose every
            # offset is missing adds nothing
            per_file: Dict[str, float] = {}
            for r in self.gt:
                off = r[2]
                if off is None or off != off:
                    continue
                per_file[r[0]] = max(per_file.get(r[0], -np.inf), float(off))
            self.total_hours = float(np.sum([max(v, 10.0) for v in per_file.values()])) / 3600.0
        self.nref = {c: sum(1 for r in labeled if r[3] == c) for c in self.classes}
        self.gt_hours_per_class = {
            c: float(np.sum(np.asarray([r[2] - r[1] for r in labeled if r[3] == c], float)))
            / 3600.0
            for c in self.classes
        }
        self.operating_points: List[Dict] = []
        self._gt_np = _by_file_class(self.gt)

    def _evaluate_op(self, detections) -> Dict:
        tpr = {}
        fpr = {}
        ctr = {c: {k: 0.0 for k in self.classes if k != c} for c in self.classes}
        det_np = _by_file_class(detections, classes=set(self.classes))
        tp_count = {c: 0 for c in self.classes}
        fp_count = {c: 0 for c in self.classes}
        empty = np.zeros(0)
        # the union of files: detections on a clip without ground truth are
        # still false positives
        for fname in set(self._gt_np) | set(det_np):
            gts = self._gt_np.get(fname, {})
            dets = det_np.get(fname, {})
            for c in set(gts) | set(dets):
                g_on, g_off = gts.get(c, (empty, empty))
                d_on, d_off = dets.get(c, (empty, empty))
                inter = _pair_intersections(d_on, d_off, g_on, g_off)
                dur = np.maximum(d_off - d_on, 1e-9)
                valid = inter.sum(axis=1) / dur >= self.dtc
                gdur = np.maximum(g_off - g_on, 1e-9)
                tp_count[c] += int((inter[valid].sum(axis=0) / gdur >= self.gtc).sum())
                inv = ~valid
                fp_count[c] += int(inv.sum())
                if not inv.any():
                    continue
                # cross-triggers: invalid detections of class c against the
                # other classes' ground truth in the same file
                ks = ([k for k in self.classes if k != c] if self.cttc <= 0
                      else [k for k in gts if k != c])
                don_i, doff_i, dur_i = d_on[inv], d_off[inv], dur[inv]
                for k in ks:
                    k_on, k_off = gts.get(k, (empty, empty))
                    inter_k = _pair_intersections(don_i, doff_i, k_on, k_off).sum(axis=1)
                    ctr[c][k] += float((inter_k / dur_i >= self.cttc).sum())
        for c in self.classes:
            tpr[c] = tp_count[c] / self.nref[c] if self.nref[c] else 0.0
            fpr[c] = fp_count[c] / max(self.total_hours, 1e-9)
            for k in ctr[c]:
                ctr[c][k] /= max(self.gt_hours_per_class.get(k, 0.0), 1e-9)
        return {"tpr": tpr, "fpr": fpr, "ctr": ctr}

    def add_operating_point(self, detections) -> None:
        self.operating_points.append(self._evaluate_op(detections))

    def psds(self, alpha_ct: float = 0.0, alpha_st: float = 0.0,
             max_efpr: float = 100.0) -> PSDSResult:
        if not self.operating_points:
            raise ValueError("no operating points added")
        curves = {}
        for c in self.classes:
            pts = [(0.0, 0.0)]
            for op in self.operating_points:
                e = op["fpr"][c]
                if alpha_ct > 0 and op["ctr"][c]:
                    e = e + alpha_ct * float(np.mean(list(op["ctr"][c].values())))
                pts.append((e, op["tpr"][c]))
            pts.sort()
            xs, ys = [], []
            best = 0.0
            for e, t in pts:  # monotone non-decreasing TPR envelope
                best = max(best, t)
                xs.append(e)
                ys.append(best)
            curves[c] = (np.array(xs), np.array(ys))

        grid = np.unique(np.concatenate([xs for xs, _ in curves.values()]
                                        + [np.array([0.0, max_efpr])]))
        grid = grid[grid <= max_efpr]
        # previous-value (staircase) interpolation of each class's envelope
        tprs = np.stack([
            ys[np.clip(np.searchsorted(xs, grid, side="right") - 1, 0, len(ys) - 1)]
            for xs, ys in curves.values()
        ])
        mu = np.clip(tprs.mean(axis=0) - alpha_st * tprs.std(axis=0), 0.0, None)
        if len(grid) < 2:
            value = 0.0
        else:
            area = float(np.sum(mu[:-1] * np.diff(grid)) + mu[-1] * (max_efpr - grid[-1]))
            value = area / max_efpr
        return PSDSResult(value, alpha_ct, alpha_st, max_efpr, grid, mu, curves)

    def compute_macro_f_score(self, detections):
        """Single-operating-point DTC/GTC-based macro F1."""
        detections = list(detections)
        op = self._evaluate_op(detections)
        fs = []
        per_class = {}
        for c in self.classes:
            nref = self.nref[c]
            tp = op["tpr"][c] * nref
            nsys = sum(1 for r in detections if r[3] == c)
            fp = nsys - tp
            denom = 2 * tp + fp + (nref - tp)
            f = 2 * tp / denom if denom > 0 else 0.0
            per_class[c] = f
            fs.append(f)
        return float(np.mean(fs)) if fs else 0.0, per_class


SCENARIOS = ((0, 0), (1, 0), (0, 1))  # (alpha_ct, alpha_st) of the three scores


def psds_score(psds: PSDSEval, filename_roc_curves: Optional[str] = None) -> List[float]:
    """Print and return the three standard PSDS scores, (alpha_ct, alpha_st)
    = (0, 0), (1, 0) and (0, 1) at max_efpr 100; with ``filename_roc_curves``
    also write each scenario's ROC curves (:func:`write_roc_curves`)."""
    values = []
    for a_ct, a_st in SCENARIOS:
        res = psds.psds(alpha_ct=a_ct, alpha_st=a_st, max_efpr=100)
        print(f"\nPSD-Score ({a_ct}, {a_st}, 100): {res.value:.5f}")
        if filename_roc_curves:
            write_roc_curves(res, filename_roc_curves)
        values.append(res.value)
    return values


def write_roc_curves(res: PSDSResult, base_path: str) -> List[str]:
    """Write one scenario's per-class TPR envelopes and effective TPR.

    ``base_path`` is a directory or a path prefix; the files are suffixed
    ``_ct<alpha_ct>_st<alpha_st>.csv``, and ``.png`` where matplotlib is
    installed.  Returns the paths written.
    """
    tag = f"ct{res.alpha_ct:g}_st{res.alpha_st:g}"
    if os.path.isdir(base_path) or base_path.endswith(os.sep):
        os.makedirs(base_path, exist_ok=True)
        prefix = os.path.join(base_path, "psds_roc")
    else:
        d = os.path.dirname(base_path)
        if d:
            os.makedirs(d, exist_ok=True)
        prefix = base_path
    written = []
    csv_path = f"{prefix}_{tag}.csv"
    with open(csv_path, "w") as f:
        f.write("curve,efpr_per_hour,tpr\n")
        for c, (xs, ys) in (res.per_class_curves or {}).items():
            for x, y in zip(xs, ys):
                f.write(f"{c},{x:.6f},{y:.6f}\n")
        for x, y in zip(res.efpr_grid, res.etpr_curve):
            f.write(f"effective_tpr,{x:.6f},{y:.6f}\n")
    written.append(csv_path)
    try:
        import matplotlib
    except ImportError:  # the plot is optional; the CSV holds the same curves
        matplotlib = None
    if matplotlib is not None:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        for c, (xs, ys) in (res.per_class_curves or {}).items():
            ax.step(xs, ys, where="post", alpha=0.5, label=str(c))
        ax.step(res.efpr_grid, res.etpr_curve, where="post", color="black", linewidth=2.0,
                label="effective TPR")
        ax.set_xlim(0, res.max_efpr)
        ax.set_ylim(0, 1.0)
        ax.set_xlabel("eFPR (per hour)")
        ax.set_ylabel("TPR")
        ax.set_title(f"PSDS ROC (alpha_ct={res.alpha_ct:g}, alpha_st={res.alpha_st:g}, "
                     f"PSDS={res.value:.4f})")
        ax.legend(fontsize=7, ncol=2)
        png_path = f"{prefix}_{tag}.png"
        fig.savefig(png_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(png_path)
    print(f"ROC curves written: {', '.join(written)}")
    return written
