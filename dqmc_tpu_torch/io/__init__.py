"""Binned HDF5 output (the JAX package's layout), the spool log of bins
and walker checkpoints."""
