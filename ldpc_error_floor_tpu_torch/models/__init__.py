from ldpc_error_floor_tpu_torch.models.nms import (
    DecoderConfig,
    DecodeResult,
    DeployResult,
    NMSDecoder,
    SP,
    MS,
    QMS,
    MS_RAW,
)
from ldpc_error_floor_tpu_torch.models.boosted import (
    BoostedDecoder,
    compose_boosted_params,
)
from ldpc_error_floor_tpu_torch.models.weights import (
    Params,
    WeightSpec,
    clip_weights,
    init_weights,
    stack_weights,
    load_params,
    params_from_blocks,
    params_from_numpy,
    params_to_blocks,
    params_to_numpy,
    partial_update_from_blocks,
    trainable_mask,
)

__all__ = [
    "DecoderConfig", "DecodeResult", "DeployResult", "NMSDecoder", "SP", "MS", "QMS", "MS_RAW",
    "Params", "WeightSpec", "clip_weights", "init_weights", "stack_weights", "load_params",
    "params_from_blocks", "params_from_numpy", "params_to_blocks", "params_to_numpy",
    "partial_update_from_blocks", "trainable_mask", "BoostedDecoder",
    "compose_boosted_params",
]
