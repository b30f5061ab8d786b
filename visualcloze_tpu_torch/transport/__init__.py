"""Flow samplers of the port."""
