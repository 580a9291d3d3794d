"""Plots (viz/plots.py: PlotMngr) and the reference repo's published
results table (viz/reference_results.py). plots is not imported with the
package: importing it imports matplotlib, which the drivers treat as
optional. `viz.PlotMngr` imports it at first access (a module
`__getattr__`)."""

from convnets_tpu_torch.viz.reference_results import (  # noqa: F401
    REFERENCE_RESULTS,
    merge_measurements,
    reference_table,
)

__all__ = ["PlotMngr", "REFERENCE_RESULTS", "merge_measurements", "reference_table"]


def __getattr__(name):
    if name == "PlotMngr":
        from convnets_tpu_torch.viz.plots import PlotMngr

        return PlotMngr
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
