"""Solver traces (the history view of ``repro.obs``)."""
