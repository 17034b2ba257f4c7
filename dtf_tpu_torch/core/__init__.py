"""Core substrate of the port (device resolution, projections)."""
