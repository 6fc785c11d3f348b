from ldpc_error_floor_tpu_torch.channel.awgn import AWGNChannel, mix_sigma_lanes

__all__ = ["AWGNChannel", "mix_sigma_lanes"]
