from ldpc_error_floor_tpu_torch.pipelines.config import (ExperimentConfig,
                                                         base_config_wman,
                                                         post_config_wman)
from ldpc_error_floor_tpu_torch.pipelines.evaluate import Evaluator
from ldpc_error_floor_tpu_torch.pipelines.train import TrainResult, run_training
from ldpc_error_floor_tpu_torch.pipelines.collect import (run_collection,
                                                          split_uncor_dataset)

__all__ = ["ExperimentConfig", "base_config_wman", "post_config_wman",
           "Evaluator", "TrainResult", "run_training", "run_collection",
           "split_uncor_dataset"]
