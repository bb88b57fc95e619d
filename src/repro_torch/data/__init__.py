"""Data helpers of the port (own copies; the port imports nothing of repro)."""
