"""Framework-free helpers (copies of ``archi_tpu.utils`` modules) and device
resolution."""
