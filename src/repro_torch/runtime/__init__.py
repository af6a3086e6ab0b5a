"""Fault-tolerance control plane (counterpart of ``repro.runtime``)."""
