"""Evaluation metrics (counterpart of convnets_tpu/train/metrics.py,
copied) — self-contained equivalents of the sklearn calls in
the reference (basemodel.py:498-576): accuracy, confusion matrix, and a
classification report (per-class precision/recall/F1/support plus macro and
weighted averages)."""

from __future__ import annotations

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """rows = true class, cols = predicted class (sklearn convention)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def classification_report(y_true, y_pred, num_classes: int, class_names=None):
    """Returns (report_dict, report_str)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.sum(axis=1)
    tp = np.diag(cm).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    names = class_names or [str(i) for i in range(num_classes)]
    report = {}
    for i, name in enumerate(names):
        report[name] = {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": int(support[i]),
        }
    total = int(support.sum())
    acc = float(tp.sum() / total) if total else 0.0
    weights = support / max(total, 1)
    report["accuracy"] = acc
    report["macro avg"] = {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1-score": float(f1.mean()),
        "support": total,
    }
    report["weighted avg"] = {
        "precision": float((precision * weights).sum()),
        "recall": float((recall * weights).sum()),
        "f1-score": float((f1 * weights).sum()),
        "support": total,
    }

    width = max(len(n) for n in names + ["weighted avg"])
    lines = [f"{'':<{width}}  precision  recall  f1-score  support"]
    for name in names:
        r = report[name]
        lines.append(
            f"{name:<{width}}  {r['precision']:9.4f}  {r['recall']:6.4f}"
            f"  {r['f1-score']:8.4f}  {r['support']:7d}"
        )
    lines.append("")
    lines.append(f"{'accuracy':<{width}}  {'':9}  {'':6}  {acc:8.4f}  {total:7d}")
    for name in ("macro avg", "weighted avg"):
        r = report[name]
        lines.append(
            f"{name:<{width}}  {r['precision']:9.4f}  {r['recall']:6.4f}"
            f"  {r['f1-score']:8.4f}  {r['support']:7d}"
        )
    return report, "\n".join(lines)
