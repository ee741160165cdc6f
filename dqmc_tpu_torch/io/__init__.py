"""Binned HDF5 output (the JAX package's layout)."""
