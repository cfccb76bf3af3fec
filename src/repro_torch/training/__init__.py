"""Training drivers, run metrics, checkpoints and consensus snapshots."""
