"""Plots (viz/plots.py: PlotMngr) and the reference repo's published
results table (viz/reference_results.py). plots is not imported here:
importing it imports matplotlib, which the drivers treat as optional."""

from convnets_tpu_torch.viz.reference_results import (  # noqa: F401
    REFERENCE_RESULTS,
    merge_measurements,
    reference_table,
)
