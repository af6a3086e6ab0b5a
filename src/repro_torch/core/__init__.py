"""Plain-tensor modules of the port (counterparts of ``repro.core``)."""
