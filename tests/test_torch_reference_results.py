"""The port's copy of the reference repo's published results table
(convnets_tpu_torch/viz/reference_results.py) against the JAX package's:
the same table, the same copies and merges, and the port's PlotMngr
rendering its metrics analysis over it (tests/test_data_viz.py's check).
"""

import os
import subprocess
import sys

import pytest

from convnets_tpu.viz import reference_results as jax_rr
from convnets_tpu_torch import viz
from convnets_tpu_torch.viz import reference_results as rr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_ROW = {"Complexity": 25_557_032, "Throughput": 2553.6, "Speed": 1 / 2553.6,
           "Training Time": 0.0, "Memory Usage": 0.0, "Accuracy": 0.0}


def test_table_equals_the_jax_one():
    assert rr.REFERENCE_RESULTS == jax_rr.REFERENCE_RESULTS
    assert viz.REFERENCE_RESULTS is rr.REFERENCE_RESULTS
    assert viz.reference_table is rr.reference_table
    assert viz.merge_measurements is rr.merge_measurements
    n = len(rr.REFERENCE_RESULTS["Configurations"])
    assert n == 9 and all(len(v) == n for v in rr.REFERENCE_RESULTS.values())


def test_reference_table_is_a_copy():
    table = rr.reference_table()
    assert table == jax_rr.reference_table() == rr.REFERENCE_RESULTS
    table["Accuracy"][0] = -1.0
    table["Configurations"].append("x")
    assert rr.REFERENCE_RESULTS == jax_rr.REFERENCE_RESULTS
    assert rr.reference_table() == jax_rr.reference_table()


@pytest.mark.parametrize("name,row", [
    ("ResNet-26", {"Throughput": 2500.0}),  # an existing row: one column replaced
    ("ResNet-50-H100", NEW_ROW),  # a new row, every column
    ("Partial", {"Accuracy": 70.0}),  # a new row, missing columns None
])
def test_merge_measurements_equals_jax(name, row):
    before = rr.reference_table()
    got = rr.merge_measurements(before, name, row)
    assert got == jax_rr.merge_measurements(jax_rr.reference_table(), name, row)
    assert before == rr.REFERENCE_RESULTS  # the input table is not changed
    i = got["Configurations"].index(name)
    for k, v in got.items():
        if k != "Configurations":
            assert v[i] == row.get(k, before[k][i] if name in before["Configurations"] else None)


def test_metrics_analysis_renders_the_table(tmp_path):
    from convnets_tpu_torch.viz.plots import PlotMngr

    table = rr.merge_measurements(rr.reference_table(), "ResNet-26", {"Throughput": 2500.0})
    table = rr.merge_measurements(table, "ResNet-50-H100", NEW_ROW)
    assert table["Throughput"][table["Configurations"].index("ResNet-26")] == 2500.0
    paths = PlotMngr(str(tmp_path)).metrics_analysis(
        {k: [v if v is not None else 0.0 for v in vs] for k, vs in table.items()})
    assert paths and all(os.path.getsize(p) > 0 for p in paths)


def test_viz_package_leaves_matplotlib_unimported():
    code = ("import sys; import convnets_tpu_torch.viz as v; v.reference_table(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'jax', 'convnets_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
