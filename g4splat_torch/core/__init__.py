"""Core math: transforms, spherical harmonics, cameras, geometry."""
