"""Performance log writer (port of `ldpc_error_floor_tpu/io/perflog.py`;
for the same numbers the file is byte-identical to the JAX package's): a
config header, then per-epoch training loss, valid/test BER/FER tables in
'%.2e', and phase running times."""

from __future__ import annotations

import dataclasses


def fte(values, precision: int = 2):
    """Format-to-exponential, the reference's `FTE`."""
    return [f"{v:.{precision}e}" for v in values]


class PerfLog:
    def __init__(self, path: str, echo: bool = True):
        self.path = path
        self.echo = echo

    def _emit(self, text: str) -> None:
        with open(self.path, "a") as f:
            f.write(text + "\n")
        if self.echo:
            print(text)

    def header(self, cfg) -> None:
        with open(self.path, "w"):
            pass
        d = dataclasses.asdict(cfg)
        lines = [
            f"Decoding_type = {d['decoding_type']} q_bit = {d['q_bit']}",
            f"CN_weight_sharing = {d['sharing'][0]} UCN_weight_sharing = "
            f"{d['sharing'][1]} VN_weight_sharing = {d['sharing'][2]}",
            f"Init_CN_weight = {d['init_weight']} Max_weight = {d['max_weight']} "
            f"Min_weight = {d['min_weight']} Init_VN_weight = {d['init_vn_weight']} "
            f"init_from_file = {d['init_from_file']}",
            f"sampling_type = {d['sampling_type']} systematic = {d['systematic']}",
            f"iters_max = {d['iters_max']} fixed_iter = {d['fixed_iter']} "
            f"fixed_init = {d['fixed_init']} iter_step = {d['iter_step']}",
            f"loss_type = {d['loss_type']} learn_rate_start = {d['learn_rate_start']}",
            f"batch_size = {d['batch_size']} epochs = {d['epochs']} "
            f"training_num = {d['training_num']} valid_num = {d['valid_num']} "
            f"test_num = {d['test_num']}",
            f"SNR_Matrix = {d['snrs']}",
            "",
        ]
        self._emit("\n".join(lines))

    def train_result(self, epoch: int, epochs: int, start: int, end: int,
                     loss: float) -> None:
        self._emit(f"* Training_iter_start: {start} training_iter_end: {end} "
                   f"epoch: [{epoch}/{epochs}]")
        self._emit(f"Training loss: {fte([loss])}")

    def eval_result(self, tag: str, results, opt_value: float) -> None:
        """results: [4, n_snr] — BER_last / FER_last / FER / loss rows."""
        self._emit(f"{tag}_Result")
        for name, row in zip(("BER_last", "FER_last", "FER", "loss"), results):
            self._emit(f"{name}: {fte(row)}")
        self._emit(f"opt_value: {fte([opt_value])}\n")

    def timing(self, t_train: float, t_valid: float, t_test: float) -> None:
        self._emit(f"Running time (Train/Valid/Test): "
                   f"{t_train:.2f}/{t_valid:.2f}/{t_test:.2f}\n")
