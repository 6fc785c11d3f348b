from ldpc_error_floor_tpu_torch.sim.fer import FERPoint, FERSimulator, SimCounters

__all__ = ["FERPoint", "FERSimulator", "SimCounters"]
