"""Entry points of the port (counterparts of ``repro.launch``)."""
