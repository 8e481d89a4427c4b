"""Measurement scripts of the port; each needs one CUDA card."""
