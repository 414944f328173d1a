"""The duplicate budget, by the rule of the port's bench
(`d3gs_tpu_torch/bench.py` `budget` / `_check_budget`): the binning keeps
at most `dup_capacity` rounded up to a multiple of 512 (tile, Gaussian)
duplicates and drops the deepest beyond it without a word, so a frame whose
duplicates reach that number may have been cut, and the run fails."""
from __future__ import annotations


def budget(dup_capacity: int) -> int:
    return ((dup_capacity + 511) // 512) * 512
