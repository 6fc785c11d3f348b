"""Experiment configuration (a copy of
`ldpc_error_floor_tpu/pipelines/config.py`, so the port reads and writes the
same JSON config files without importing the JAX package).

`validate()` reproduces the reference's `check_params`
(`Main_Functions.py:498-523`) as raised exceptions, plus the cross-field
coercions the reference applies (sampling_type 1 collapses the SNR list to
[0.0]).  Fields that only the JAX package's training reads (`scan_unroll`)
are kept so a config file means the same to both packages."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# sampling types (main_Base.py:26)
SAMPLING_AWGN = 0        # fresh BPSK+AWGN noise
SAMPLING_READ_UNCOR = 1  # read harvested uncorrected words
SAMPLING_COLLECT = 2     # collect uncorrected words (no training)


@dataclass
class ExperimentConfig:
    # --- code ---
    code: str = "wman_N0576_R34_z24"
    z: Optional[int] = None                 # None = library default
    punct: Optional[Tuple[int, int]] = None
    short: Optional[Tuple[int, int]] = None

    # --- decoder ---
    sharing: Tuple[int, int, int] = (3, 0, 3)   # (CN, UCN, VN)
    decoding_type: int = 2                      # 0 SP, 1 MS, 2 QMS
    q_bit: int = 5
    neural_mode: str = "scale"                  # 'scale' (reference NMS) or 'offset' (OMS)
    systematic: int = 0
    clip_llr: float = 20.0

    # --- schedule (Delta1/Delta2, main_Base.py:35-38) ---
    iters_max: int = 20
    fixed_iter: int = 0
    fixed_init: int = 0     # Delta2
    iter_step: int = 20     # Delta1

    # --- training ---
    sampling_type: int = SAMPLING_AWGN
    train_on_zero_word: int = 1        # 0: encode random codewords per batch
    #   and train BCE on the true bits (the reference's switch at
    #   main_Base.py:70, whose generator branch is vestigial there)
    loss_type: int = 2                 # 0 BCE, 1 soft-BER, 2 soft-FER
    opt_metric: int = 1                # best-model metric: 0 BER_last, 1 FER_last,
    #                                    2 FER, 3 loss (opt_result_print)
    etha_start: float = 0.0
    etha_discount: float = 0.0
    etha_discount_step: int = 0
    learn_rate_start: float = 1e-3
    learn_rate_discount: float = 0.0
    learn_rate_step: int = 0
    batch_size: int = 20
    training_num: int = 10000
    epochs: int = 200
    valid_flag: int = 1
    valid_num: int = 10000
    test_flag: int = 0
    test_num: int = 400
    eval_loss: int = 1   # 0: skip the loss metric during eval -> stats-only
    #   evaluation (loss row logs as 0); forced to 1 when opt_metric
    #   selects the loss

    # --- weight init ---
    init_from_file: int = 0
    init_weight: float = 1.0
    init_vn_weight: float = 1.0
    max_weight: float = 2.0
    min_weight: float = 0.0

    # --- checkpoint/resume (no reference equivalent; SURVEY.md section 5) ---
    checkpoint_every: int = 0   # epochs between full-state snapshots (0 = off)
    resume: int = 0             # restore the latest snapshot if present

    # --- performance (no reference equivalent) ---
    scan_unroll: int = 0   # the JAX package's training-scan unroll (0 = auto)

    # --- misc ---
    seed: int = 2
    snrs: List[float] = field(default_factory=lambda: [2.0, 2.5, 3.0, 3.5, 4.0])
    out_dir: str = "./Weights"
    input_dir: str = "./Inputs"
    out_prefix: Optional[str] = None   # default C0_{code}

    def __post_init__(self):
        if self.out_prefix is None:
            self.out_prefix = f"C0_{self.code}"

    # ----- validation (check_params parity) -----------------------------------
    def validate(self) -> "ExperimentConfig":
        snrs = list(self.snrs)
        if self.sampling_type == SAMPLING_READ_UNCOR and len(snrs) > 1:
            snrs = [0.0]
        if self.sampling_type == SAMPLING_COLLECT and len(snrs) > 1:
            raise ValueError("uncorrected-word collection requires a single SNR")
        if sum(self.sharing) == 0:
            raise ValueError("at least one weight kind must have sharing > 0")
        if any(s in (4, 5) for s in self.sharing) and \
                (self.iters_max - self.fixed_iter) % self.iter_step > 0:
            raise ValueError("temporal sharing requires (iters_max - fixed_iter) "
                             "divisible by iter_step")
        if self.sharing[2] in (1, 4):
            raise ValueError("VN weights cannot be per-edge")
        if self.sharing[1] != 0 and self.sharing[0] != self.sharing[1]:
            raise ValueError("UCN sharing must equal CN sharing when enabled")
        if self.decoding_type not in (0, 1, 2, 3):
            raise ValueError(f"bad decoding_type {self.decoding_type}")
        if self.neural_mode not in ("scale", "offset"):
            raise ValueError(f"bad neural_mode {self.neural_mode!r}")
        if not self.train_on_zero_word:
            if self.sampling_type != SAMPLING_AWGN:
                raise ValueError("train_on_zero_word=0 requires fresh-AWGN "
                                 "sampling (sampling_type 0)")
            if self.loss_type != 0:
                raise ValueError("train_on_zero_word=0 requires BCE loss "
                                 "(loss_type 0): the soft-BER/soft-FER "
                                 "surrogates assume the all-zero codeword")
        return dataclasses.replace(self, snrs=snrs)

    # ----- (de)serialization ---------------------------------------------------
    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            obj = json.load(f)
        for k in ("punct", "short"):
            if obj.get(k) is not None:
                obj[k] = tuple(obj[k])
        obj["sharing"] = tuple(obj["sharing"])
        return cls(**obj)


def base_config_wman() -> ExperimentConfig:
    """The reference `main_Base.py` configuration (base decoder, WiMAX)."""
    return ExperimentConfig()


def post_config_wman() -> ExperimentConfig:
    """The reference `main_Post.py` configuration (post decoder on harvested
    uncorrected words, UCN weights on)."""
    return ExperimentConfig(
        sharing=(3, 3, 3), sampling_type=SAMPLING_READ_UNCOR,
        iters_max=30, fixed_iter=20, iter_step=10,
        valid_num=5000, test_flag=1, test_num=5000,
        snrs=[2.0, 2.1, 2.2, 2.3, 2.4, 2.5])
