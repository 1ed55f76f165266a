"""Simulation loop / node layer."""
from .sim import Simulation, INIT, HOLD, OP, END  # noqa: F401
