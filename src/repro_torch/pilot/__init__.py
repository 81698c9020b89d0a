from repro_torch.pilot.api import (ComputeUnit, ComputeUnitDescription, Pilot,
                                   PilotComputeService, PilotDescription, State,
                                   TaskProfile)

__all__ = ["Pilot", "PilotDescription", "ComputeUnit", "ComputeUnitDescription",
           "PilotComputeService", "State", "TaskProfile"]
