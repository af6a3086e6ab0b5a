"""Language-model substrate of the port (counterparts of ``repro.models``):
the dense decoder family, its GQA attention and KV caches."""
