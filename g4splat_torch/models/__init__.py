"""Scene state."""
