"""In-situ analysis (port of ``repro/analysis``)."""
