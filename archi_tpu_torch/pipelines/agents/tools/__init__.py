"""Agent tools (copies of ``archi_tpu.pipelines.agents.tools`` modules)."""
