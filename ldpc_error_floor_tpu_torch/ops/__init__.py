from ldpc_error_floor_tpu_torch.ops.ste import qms_clip_limit, qms_grid, quantize_llr
from ldpc_error_floor_tpu_torch.ops.fused_decoder import FusedNMSKernel, decode_stats_plain

__all__ = ["qms_clip_limit", "qms_grid", "quantize_llr", "FusedNMSKernel",
           "decode_stats_plain"]
