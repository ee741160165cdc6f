"""Walkers across devices and processes, and parallel tempering:
walker chunks and replica-stacked models (``walkers.py``), the process
group and its collectives (``distributed.py``), and the replica-exchange
driver (``tempering.py``)."""
