"""Optimizer, EMA, checkpoints and the eval step (the supervised train step is not
ported yet)."""
