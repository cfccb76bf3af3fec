"""Datasets (numpy copies of ``repro.data``)."""
