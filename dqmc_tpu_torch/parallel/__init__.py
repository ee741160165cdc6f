"""Parallel tempering on one device: replica-stacked models
(``walkers.py``) and the replica-exchange driver (``tempering.py``)."""
