from ldpc_error_floor_tpu_torch.io.uncor_files import (
    append_uncor_file,
    read_uncor_file,
)
from ldpc_error_floor_tpu_torch.io.weight_files import (
    available_weight_sets,
    bundled_weight_path,
    read_weight_file,
    read_weight_json,
    write_weight_file,
    write_weight_json,
)

__all__ = [
    "append_uncor_file",
    "read_uncor_file",
    "available_weight_sets",
    "bundled_weight_path",
    "read_weight_file",
    "read_weight_json",
    "write_weight_file",
    "write_weight_json",
]
