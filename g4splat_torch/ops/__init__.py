"""Rendering ops and kernels."""
