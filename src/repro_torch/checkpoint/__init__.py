"""Atomic, CRC-verified checkpoints (counterpart of ``repro.checkpoint``)."""
