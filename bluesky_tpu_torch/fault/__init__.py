"""Fault tolerance of the port: the state-integrity guard (``guard``)
the Simulation consults at chunk edges.  The fault-injection harness of
the JAX package (``fault/injectors.py``, ``fault/harness.py``, the FAULT
command) is not ported (ROADMAP A10)."""
from .guard import IntegrityGuard                      # noqa: F401
