"""Data helpers: the synthetic hand-frame generator."""
