"""Sharding rules (logical tensor axes -> mesh axes); port of
``repro/parallel``."""
