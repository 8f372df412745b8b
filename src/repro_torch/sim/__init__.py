"""Discrete-event core (queue + clock) of the fleet engine and the serving
runtime."""
from repro_torch.sim.core import Event, EventQueue, SimClock  # noqa: F401
