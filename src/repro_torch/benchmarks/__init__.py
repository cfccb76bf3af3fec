"""Drivers of the paper's experiments on the PyTorch port."""
