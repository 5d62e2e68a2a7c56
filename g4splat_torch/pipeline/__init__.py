"""Pipeline stages."""
