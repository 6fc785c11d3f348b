from ldpc_error_floor_tpu_torch.sim.fer import FERPoint, FERSimulator, SimCounters
from ldpc_error_floor_tpu_torch.sim.harvest import UncorHarvester

__all__ = ["FERPoint", "FERSimulator", "SimCounters", "UncorHarvester"]
