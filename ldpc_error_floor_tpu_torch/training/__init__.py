from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss
from ldpc_error_floor_tpu_torch.training.schedule import n_blocks, training_blocks
from ldpc_error_floor_tpu_torch.training.train import (TrainStep,
                                                       make_epoch_step,
                                                       make_optimizer,
                                                       make_train_step,
                                                       set_learning_rate)

__all__ = ["multi_iteration_loss", "n_blocks", "training_blocks", "TrainStep",
           "make_epoch_step", "make_optimizer", "make_train_step",
           "set_learning_rate"]
