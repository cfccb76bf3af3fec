"""Training drivers and run metrics."""
