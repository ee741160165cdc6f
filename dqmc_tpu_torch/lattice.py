"""Lattice geometry: site indexing, bonds, k-grid and the ``results/info``
file.

``dqmc_tpu.lattice`` is host-side numpy and imports no JAX, so the port
uses it unchanged; this module is the one place the port names it.
"""

from dqmc_tpu.lattice import (Lattice, bonds_with_tp, make_lattice,
                              square_lattice)

__all__ = ["Lattice", "bonds_with_tp", "make_lattice", "square_lattice"]
