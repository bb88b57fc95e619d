"""Train and serve entry points and their step functions (port of ``repro/launch``)."""
