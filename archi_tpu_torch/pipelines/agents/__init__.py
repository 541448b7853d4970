"""Agent support: the tool base and the catalog tools."""
