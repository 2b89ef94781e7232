"""Kernels and attention ops of the port."""
