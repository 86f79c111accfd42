"""Train and eval steps; only the eval step is ported so far."""
