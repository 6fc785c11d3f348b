"""Block-wise training schedule (port of
`ldpc_error_floor_tpu/training/schedule.py`).

`fixed_iter` is the first trainable iteration (everything below is frozen,
loaded from the previous stage's best weights); blocks of width
Delta1 = `iter_step` are trained in sequence, each optionally re-training
the trailing Delta2 = `fixed_init` iterations of the previous block; the
decoder depth grows to each block's `end`.
"""

from __future__ import annotations

from typing import Iterator, Tuple


def training_blocks(iters_max: int, fixed_iter: int,
                    iter_step: int) -> Iterator[Tuple[int, int]]:
    """Yield (train_start, train_end) per block."""
    start, end = fixed_iter, fixed_iter + iter_step
    while end <= iters_max:
        yield start, end
        start += iter_step
        end += iter_step


def n_blocks(iters_max: int, fixed_iter: int, iter_step: int) -> int:
    return len(list(training_blocks(iters_max, fixed_iter, iter_step)))
