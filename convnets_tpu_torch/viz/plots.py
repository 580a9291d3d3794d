"""Offline plotting (counterpart of convnets_tpu/viz/plots.py, copied; the
reference's PlotMngr, mngrplot.py:32-440): training curves with best-epoch
annotations, the confusion-matrix heatmap, hyper-parameter-vs-score
scatter grids, per-model score box/violin plots, and the benchmark
metrics-analysis suite (correlation heatmap + accuracy-vs-metric
scatters).

Everything renders to files, headless. This module imports matplotlib
when it is imported; the drivers import it only when they plot, and skip
the plots where matplotlib is not installed.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


class PlotMngr:
    def __init__(self, output_dir: str = "data/output/plots"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def _save(self, fig, name: str) -> str:
        path = os.path.join(self.output_dir, name)
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return path

    # -- training curves (mngrplot.py:32-182) ---------------------------

    def performance(self, epoch_results: Dict, name: str = "performance.png") -> str:
        r = epoch_results
        epochs = np.arange(1, len(r["train_loss"]) + 1)
        best = int(r.get("train_epochs", len(epochs)))
        fig, axes = plt.subplots(1, 3, figsize=(16, 4))

        axes[0].plot(epochs, r["train_loss"], label="train")
        axes[0].plot(epochs, r["valid_loss"], label="valid")
        if 0 < best <= len(epochs):
            axes[0].axvline(best, ls="--", c="gray")
            axes[0].annotate(f"best @ {best}", (best, r["valid_loss"][best - 1]))
        axes[0].set_title("Loss")
        axes[0].set_xlabel("epoch")
        axes[0].legend()

        axes[1].plot(epochs, np.asarray(r["train_score"]) * 100, label="train")
        axes[1].plot(epochs, np.asarray(r["valid_score"]) * 100, label="valid")
        if 0 < best <= len(epochs):
            axes[1].axvline(best, ls="--", c="gray")
        axes[1].set_title("Accuracy (%)")
        axes[1].set_xlabel("epoch")
        axes[1].legend()

        axes[2].plot(epochs, r["learning_rate"])
        axes[2].set_yscale("log")
        axes[2].set_title("Learning rate")
        axes[2].set_xlabel("epoch")
        return self._save(fig, name)

    # -- confusion matrix (mngrplot.py:185-204) --------------------------

    def confusion_matrix(self, cm: np.ndarray, class_names: Optional[Sequence[str]] = None,
                         name: str = "confusion_matrix.png") -> str:
        cm = np.asarray(cm)
        n = cm.shape[0]
        labels = list(class_names) if class_names else [str(i) for i in range(n)]
        fig, ax = plt.subplots(figsize=(max(6, n * 0.7),) * 2)
        im = ax.imshow(cm, cmap="Blues")
        fig.colorbar(im, ax=ax)
        thresh = cm.max() / 2 if cm.max() else 0.5
        for i in range(n):
            for j in range(n):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        color="white" if cm[i, j] > thresh else "black", fontsize=8)
        ax.set_xticks(range(n), labels, rotation=45, ha="right")
        ax.set_yticks(range(n), labels)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        return self._save(fig, name)

    # -- dataset info (mngrdata.py:74-137) -------------------------------

    def class_distribution(self, info: Dict, name: str = "class_distribution.png") -> str:
        """Bar chart of examples per class from Dataset.info()."""
        dist = info["class_distribution"]
        labels, counts = list(dist), list(dist.values())
        fig, ax = plt.subplots(figsize=(max(6, len(labels) * 0.8), 4))
        ax.bar(range(len(labels)), counts)
        ax.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
        ax.set_ylabel("examples")
        ax.set_title(f"{info.get('num_examples', sum(counts))} examples, "
                     f"{len(labels)} classes")
        return self._save(fig, name)

    # -- tuning scatters (mngrplot.py:207-295) ---------------------------

    def hyperparameters(self, tuning_results: Dict, hparam_names: Sequence[str],
                        name: str = "hyperparameters.png") -> str:
        samples: List[Dict] = tuning_results["samples"]
        scores = np.asarray(tuning_results["scores"], np.float64) * 100
        present = [h for h in hparam_names if samples and h in samples[0]]
        per_page = 8
        cols = 4
        rows = max(1, math.ceil(min(len(present), per_page) / cols))
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
        for k, hname in enumerate(present[:per_page]):
            ax = axes[k // cols][k % cols]
            vals = [s[hname] for s in samples]
            try:
                xs = np.asarray(vals, np.float64)
            except (TypeError, ValueError):
                cats = sorted({str(v) for v in vals})
                xs = np.asarray([cats.index(str(v)) for v in vals], np.float64)
                ax.set_xticks(range(len(cats)), cats)
            ax.scatter(xs, scores)
            ax.set_title(hname, fontsize=9)
            ax.set_ylabel("score %")
        for k in range(len(present[:per_page]), rows * cols):
            axes[k // cols][k % cols].axis("off")
        return self._save(fig, name)

    # -- model comparison (mngrplot.py:298-315) --------------------------

    def models(self, model_scores: Dict[str, Sequence[float]],
               name: str = "models.png") -> str:
        names = list(model_scores)
        data = [np.asarray(model_scores[n]) * 100 for n in names]
        fig, axes = plt.subplots(1, 2, figsize=(max(8, len(names) * 1.3), 5))
        axes[0].boxplot(data, tick_labels=names)
        axes[0].set_title("Score distribution (box)")
        axes[1].violinplot(data, showmeans=True)
        axes[1].set_xticks(range(1, len(names) + 1), names)
        axes[1].set_title("Score distribution (violin)")
        for ax in axes:
            ax.tick_params(axis="x", rotation=45)
            ax.set_ylabel("accuracy %")
        return self._save(fig, name)

    # -- benchmark analysis (mngrplot.py:317-440) -------------------------

    def metrics_analysis(self, table: Dict[str, Sequence], name_prefix: str = "metrics") -> List[str]:
        """table: {'Configurations': [...names], '<Metric>': [...values], ...}.
        Produces a Pearson-correlation heatmap and accuracy-vs-metric scatters."""
        names = table["Configurations"]
        metrics = {k: np.asarray([np.nan if v is None else v for v in vs],
                                 np.float64)
                   for k, vs in table.items() if k != "Configurations"}
        keys = list(metrics)
        mat = np.vstack([metrics[k] for k in keys])
        # pairwise-complete Pearson correlations (None/NaN entries from
        # partially-measured configs are excluded per pair, not poisoning
        # whole rows)
        m = len(keys)
        corr = np.full((m, m), np.nan)
        for i in range(m):
            for j in range(m):
                ok = np.isfinite(mat[i]) & np.isfinite(mat[j])
                if ok.sum() >= 2 and mat[i][ok].std() > 0 and mat[j][ok].std() > 0:
                    corr[i, j] = np.corrcoef(mat[i][ok], mat[j][ok])[0, 1]

        paths = []
        fig, ax = plt.subplots(figsize=(1.1 * len(keys) + 2,) * 2)
        im = ax.imshow(corr, vmin=-1, vmax=1, cmap="coolwarm")
        fig.colorbar(im, ax=ax)
        for i in range(len(keys)):
            for j in range(len(keys)):
                ax.text(j, i, f"{corr[i, j]:.2f}", ha="center", va="center", fontsize=8)
        ax.set_xticks(range(len(keys)), keys, rotation=45, ha="right")
        ax.set_yticks(range(len(keys)), keys)
        ax.set_title("Pearson correlation")
        paths.append(self._save(fig, f"{name_prefix}_correlations.png"))

        if "Accuracy" in metrics:
            others = [k for k in keys if k != "Accuracy"]
            cols = 2
            rows = math.ceil(len(others) / cols)
            fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 4 * rows),
                                     squeeze=False)
            for k, metric in enumerate(others):
                ax = axes[k // cols][k % cols]
                ok = np.isfinite(metrics[metric]) & np.isfinite(metrics["Accuracy"])
                ax.scatter(metrics[metric][ok], metrics["Accuracy"][ok])
                for x, y, label in zip(metrics[metric], metrics["Accuracy"], names):
                    if np.isfinite(x) and np.isfinite(y):
                        ax.annotate(label, (x, y), fontsize=7)
                ax.set_xlabel(metric)
                ax.set_ylabel("Accuracy")
            for k in range(len(others), rows * cols):
                axes[k // cols][k % cols].axis("off")
            paths.append(self._save(fig, f"{name_prefix}_scatter.png"))
        return paths
