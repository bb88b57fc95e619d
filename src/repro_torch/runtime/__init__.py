"""Fault-tolerant training runtime (port of ``repro/runtime``)."""
