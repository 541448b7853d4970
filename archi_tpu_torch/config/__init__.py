"""Configuration: defaults, YAML merge and validation, and the runtime
config service (copies of ``archi_tpu.config`` modules)."""
