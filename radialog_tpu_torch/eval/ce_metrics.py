"""Clinical-efficacy (CE) scores of CheXbert labels and the evaluation's
CSV writers, numpy only (port of radialog_tpu/eval/ce_metrics.py, copied).

  * predictions CSV: one double-quoted report per line, inner quotes
    dropped;
  * labels CSV: ``findings`` and the 14 CheXbert condition columns, the
    labeler's 4 classes mapped 0 -> blank (NaN), 1 -> 1, 2 -> 0, 3 -> -1,
    written as ``f"{v:.1f}"``;
  * scoring maps NaN -> 0 and -1 -> 0 on both sides, then takes macro
    F1/precision/recall, samples-F1 and the mean per-class accuracy
    (sklearn's definitions, zero_division=0).
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np

# CheXbert labeler output order (its heads)
CHEXBERT_CONDITIONS = [
    "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture",
    "Support Devices", "No Finding",
]

# scoring column order of the evaluation (the ground-truth label files')
CHEXPERT_COLS = [
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly",
    "Lung Opacity", "Lung Lesion", "Edema", "Consolidation", "Pneumonia",
    "Atelectasis", "Pneumothorax", "Pleural Effusion", "Pleural Other",
    "Fracture", "Support Devices",
]


def write_predictions_csv(reports: Sequence[str], path: Union[str, Path]) -> None:
    """'"' + report without its double quotes + '"' per line."""
    with open(path, "w") as f:
        for r in reports:
            f.write('"' + r.replace('"', "") + '"\n')


def class_ids_to_label_matrix(class_ids: np.ndarray) -> np.ndarray:
    """CheXbert's 4-class output (N, 14) in {0: blank, 1: pos, 2: neg,
    3: uncertain} -> floats in {NaN, 1, 0, -1}."""
    out = np.full(class_ids.shape, np.nan, np.float64)
    out[class_ids == 1] = 1.0
    out[class_ids == 2] = 0.0
    out[class_ids == 3] = -1.0
    return out


def write_labels_csv_from_raw(mat: np.ndarray, findings: Sequence[str],
                              path: Union[str, Path]) -> None:
    """Labels (N, 14) in {NaN, 1, 0, -1}, CHEXBERT_CONDITIONS order, as a
    labels CSV: columns [findings] + CHEXBERT_CONDITIONS, each value as
    f"{v:.1f}", a blank for NaN."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["findings"] + CHEXBERT_CONDITIONS)
        for text, row in zip(findings, mat):
            w.writerow([text] + ["" if np.isnan(v) else f"{v:.1f}" for v in row])


def write_labels_csv(class_ids: np.ndarray, findings: Sequence[str],
                     path: Union[str, Path]) -> None:
    """The labeler's class ids as a labels CSV."""
    write_labels_csv_from_raw(class_ids_to_label_matrix(np.asarray(class_ids)), findings, path)


def read_labels_csv(path: Union[str, Path], cols: List[str] = CHEXPERT_COLS) -> np.ndarray:
    """A labels CSV back into (N, 14) floats in ``cols`` order, blanks NaN."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = np.full((len(rows), len(cols)), np.nan, np.float64)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            v = r.get(c, "")
            if v not in ("", None):
                out[i, j] = float(v)
    return out


def map_labels_for_scoring(labels: np.ndarray) -> np.ndarray:
    """NaN -> 0, -1 -> 0: the binary presence matrix."""
    out = np.nan_to_num(np.asarray(labels, np.float64), nan=0.0)
    out[out == -1] = 0.0
    return out


def _prf(tp: np.ndarray, fp: np.ndarray, fn: np.ndarray):
    denom_p = tp + fp
    denom_r = tp + fn
    prec = np.divide(tp, denom_p, out=np.zeros_like(tp, np.float64), where=denom_p > 0)
    rec = np.divide(tp, denom_r, out=np.zeros_like(tp, np.float64), where=denom_r > 0)
    denom_f = prec + rec
    f1 = np.divide(2 * prec * rec, denom_f, out=np.zeros_like(prec), where=denom_f > 0)
    return prec, rec, f1


def ce_metrics(gt_labels: np.ndarray, pred_labels: np.ndarray) -> Dict[str, float]:
    """(N, 14) labels in {NaN, 1, 0, -1} or already binary -> macro
    F1/precision/recall, samples-F1, mean per-class accuracy, and the
    per-class F1 list."""
    y = map_labels_for_scoring(gt_labels)
    p = map_labels_for_scoring(pred_labels)
    tp = ((y == 1) & (p == 1)).sum(0).astype(np.float64)
    fp = ((y == 0) & (p == 1)).sum(0).astype(np.float64)
    fn = ((y == 1) & (p == 0)).sum(0).astype(np.float64)
    prec, rec, f1 = _prf(tp, fp, fn)
    tp_s = ((y == 1) & (p == 1)).sum(1).astype(np.float64)
    fp_s = ((y == 0) & (p == 1)).sum(1).astype(np.float64)
    fn_s = ((y == 1) & (p == 0)).sum(1).astype(np.float64)
    _, _, f1_s = _prf(tp_s, fp_s, fn_s)
    acc = (y == p).mean(0)
    return {
        "chexbert_macro_f1": float(f1.mean()),
        "chexbert_macro_precision": float(prec.mean()),
        "chexbert_macro_recall": float(rec.mean()),
        "chexbert_sample_f1": float(f1_s.mean()),
        "chexbert_mean_accuracy": float(acc.mean()),
        "per_class_f1": f1.tolist(),
    }
