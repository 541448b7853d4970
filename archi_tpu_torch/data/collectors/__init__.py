"""Source collectors: local files and uploads, links, git, tickets (copies
of ``archi_tpu.data.collectors`` modules)."""
