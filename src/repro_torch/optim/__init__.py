"""Optimizer (port of ``repro/optim``)."""
