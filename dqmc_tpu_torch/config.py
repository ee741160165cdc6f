"""The ``parameters.in`` schema.

``dqmc_tpu.config`` imports no JAX, so the port reads parameter files
through it unchanged; this module is the one place the port names it.
"""

from dqmc_tpu.config import Parameters

__all__ = ["Parameters"]
