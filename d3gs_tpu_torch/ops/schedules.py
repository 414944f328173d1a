"""Learning-rate and noise schedules (counterpart of
`d3gs_tpu/ops/schedules.py`, the reference's utils/general_utils.py:42-111).
The step is a host int or float and the result a Python float: the host
loop owns the iteration count, so no schedule runs on the card."""
from __future__ import annotations

import math


def _delay(step: float, lr_delay_steps: int, lr_delay_mult: float) -> float:
    if lr_delay_steps <= 0:
        return 1.0
    ramp = min(max(step / lr_delay_steps, 0.0), 1.0)
    return lr_delay_mult + (1 - lr_delay_mult) * math.sin(0.5 * math.pi * ramp)


def expon_lr(step, *, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-linear decay from lr_init to lr_final over max_steps."""
    step = float(step)
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    return _delay(step, lr_delay_steps, lr_delay_mult) * log_lerp


def linear_noise(step, *, lr_init: float, lr_final: float,
                 lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
                 max_steps: int = 1_000_000) -> float:
    """Linear interpolation variant (the AST time-noise annealing,
    reference train_baseline.py:112-115)."""
    step = float(step)
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    lerp = lr_init * (1 - t) + lr_final * t
    return _delay(step, lr_delay_steps, lr_delay_mult) * lerp
