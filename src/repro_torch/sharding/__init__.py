"""Sharding rules on lane grids (port of ``repro/sharding/``)."""
