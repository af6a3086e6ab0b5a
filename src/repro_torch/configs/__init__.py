"""Model configurations of the port (counterparts of ``repro.configs``)."""
