"""Language-model substrate of the port (counterparts of ``repro.models``):
every family of the registry, its attention, mixers and caches."""
