from ldpc_error_floor_tpu_torch.pipelines.config import (ExperimentConfig,
                                                         base_config_wman,
                                                         post_config_wman)
from ldpc_error_floor_tpu_torch.pipelines.collect import (run_collection,
                                                          split_uncor_dataset)

__all__ = ["ExperimentConfig", "base_config_wman", "post_config_wman",
           "run_collection", "split_uncor_dataset"]
