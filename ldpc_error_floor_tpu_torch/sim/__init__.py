from ldpc_error_floor_tpu_torch.sim.analysis import FailureReport, classify_failures
from ldpc_error_floor_tpu_torch.sim.fer import FERPoint, FERSimulator, SimCounters
from ldpc_error_floor_tpu_torch.sim.harvest import UncorHarvester

__all__ = ["FailureReport", "FERPoint", "FERSimulator", "SimCounters",
           "UncorHarvester", "classify_failures"]
