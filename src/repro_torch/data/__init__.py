"""Synthetic training data (counterpart of ``repro.data``)."""
