"""Training runtime: Zerrow-backed checkpoints and fleet monitoring."""
