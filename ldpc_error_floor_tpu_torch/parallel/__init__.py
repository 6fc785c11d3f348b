from ldpc_error_floor_tpu_torch.parallel.launch import mesh_world, spawn_ranks
from ldpc_error_floor_tpu_torch.parallel.mesh import (DataMesh, all_max, all_sum,
                                                      barrier, batch_constraint,
                                                      data_mesh, gather_lanes,
                                                      initialize_distributed,
                                                      rank_generator, replicate)

__all__ = ["DataMesh", "all_max", "all_sum", "barrier", "batch_constraint",
           "data_mesh", "gather_lanes", "initialize_distributed",
           "mesh_world", "rank_generator", "replicate", "spawn_ranks"]
