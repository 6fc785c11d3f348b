"""The benchmark of the PyTorch and CUDA port (`ldpc_error_floor_tpu_torch`)."""
