"""Checkpoint store (port of ``repro/checkpoint``)."""
