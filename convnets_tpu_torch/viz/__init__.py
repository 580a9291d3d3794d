"""Plots (viz/plots.py: PlotMngr). Not imported here: importing plots
imports matplotlib, which the drivers treat as optional."""
