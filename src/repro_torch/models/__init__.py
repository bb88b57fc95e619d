"""The LM stack (port of ``repro/models``): xlstm-350m's blocks so far."""
