from ldpc_error_floor_tpu_torch.codes.protograph import Code, load_proto_matrix, save_proto_json
from ldpc_error_floor_tpu_torch.codes.graph import TannerGraph
from ldpc_error_floor_tpu_torch.codes.encoder import Encoder, gf2_rref
from ldpc_error_floor_tpu_torch.codes.library import available_codes, get_code

__all__ = [
    "Code",
    "TannerGraph",
    "Encoder",
    "gf2_rref",
    "load_proto_matrix",
    "save_proto_json",
    "available_codes",
    "get_code",
]
