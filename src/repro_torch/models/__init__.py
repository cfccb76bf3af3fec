"""Models of the port (the paper's EHR MLP)."""
