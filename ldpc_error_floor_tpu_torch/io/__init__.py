from ldpc_error_floor_tpu_torch.io.weight_files import (
    available_weight_sets,
    bundled_weight_path,
    read_weight_file,
    read_weight_json,
    write_weight_file,
    write_weight_json,
)

__all__ = [
    "available_weight_sets",
    "bundled_weight_path",
    "read_weight_file",
    "read_weight_json",
    "write_weight_file",
    "write_weight_json",
]
