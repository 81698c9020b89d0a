"""Discrete-event simulation (virtual clock) of the port."""

from repro_torch.sim.des import SharedResource, Simulator

__all__ = ["Simulator", "SharedResource"]
