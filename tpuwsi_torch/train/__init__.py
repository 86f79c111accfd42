"""Training: optimizers and schedule, losses, step metrics, the train state,
EMA, checkpoints, and the supervised and survival steps."""
