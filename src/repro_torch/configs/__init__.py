"""Run configurations (counterpart of ``repro.configs``)."""
