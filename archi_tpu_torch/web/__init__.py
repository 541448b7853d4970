"""HTTP layer: the stdlib framework and the data-manager app (copies of
``archi_tpu.web`` modules)."""
