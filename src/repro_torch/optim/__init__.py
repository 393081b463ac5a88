"""Optimizer of the port: AdamW on tensor trees (port of ``repro.optim``)."""
