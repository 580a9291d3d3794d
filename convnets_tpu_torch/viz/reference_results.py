"""The reference repo's published benchmark table (counterpart of
convnets_tpu/viz/reference_results.py, copied: the port imports nothing of
the JAX package).

These are the numbers the reference repo publishes (data/results.xlsx,
column labels per mngrplot.py:322-324), measured by the reference on its
own hardware: neither this port's nor the H100's (provenance and caveats:
BASELINE.md). The table is a ready-made input for
PlotMngr.metrics_analysis, the stand-in for the reference's
results.xlsx-reading path, and merge_measurements adds freshly measured
rows to it.

Units: Complexity = parameters; Speed = s/image; Throughput = images/s;
Training Time = minutes; Memory Usage = MB; Accuracy = test top-1 %.
"""

from __future__ import annotations

from typing import Dict, List

REFERENCE_RESULTS: Dict[str, List] = {
    "Configurations": [
        "VGGNet-11", "InceptionNet-v1", "ResNet-26", "SqueezeNet-v1.1",
        "DenseNet-121", "MobileNet-v1", "ShuffleNet-v1-g4", "SEResNet-26",
        "SKResNet-26",
    ],
    "Complexity": [28146762, 5991082, 13966666, 730580, 6964106,
                   3217226, 890234, 15359306, 8283978],
    "Speed": [0.054, 0.051, 0.053, 0.030, 0.116, 0.031, 0.051, 0.061, 0.071],
    "Throughput": [18.369, 19.620, 18.835, 33.421, 8.643, 32.154, 19.726,
                   16.536, 14.111],
    "Training Time": [48.02, 53.10, 54.24, 45.21, 114.74, 43.96, 73.81,
                      55.96, 49.13],
    "Memory Usage": [1109.39, 521.40, 891.30, 261.99, 2570.59, 622.29,
                     480.82, 1063.49, 1009.87],
    "Accuracy": [72.87, 72.95, 74.81, 71.38, 74.08, 74.39, 66.16, 74.08,
                 74.96],
}


def reference_table() -> Dict[str, List]:
    """A fresh copy of the reference benchmark table."""
    return {k: list(v) for k, v in REFERENCE_RESULTS.items()}


def merge_measurements(table: Dict[str, List], name: str,
                       row: Dict[str, float]) -> Dict[str, List]:
    """Append (or replace) one configuration's measured metrics.
    Missing columns get None (plots skip them)."""
    table = {k: list(v) for k, v in table.items()}
    if name in table["Configurations"]:
        i = table["Configurations"].index(name)
        for k in table:
            if k != "Configurations":
                table[k][i] = row.get(k, table[k][i])
        return table
    table["Configurations"].append(name)
    for k in table:
        if k != "Configurations":
            table[k].append(row.get(k))
    return table
