"""Learning-rate schedules (SGDR cosine warm restarts, sine warmup) and the
entropy-regulariser decay, as ``schedule(step) -> float`` functions of the
integer optimiser step over fractional epochs (``epoch = step /
steps_per_epoch``).  The port of hello_tpu's train/schedule.py in plain
Python: the step is a host integer here, so no traced arithmetic is needed.
"""

from __future__ import annotations

import math


def cosine_warm_restarts(base_lr: float, t0: int, t_mult: int = 1,
                         eta_min: float = 0.0, steps_per_epoch: int = 1):
    """SGDR: eta_min + (base - eta_min) * (1 + cos(pi * Tcur / Ti)) / 2."""
    t0 = float(t0)

    def schedule(step):
        epoch = step / steps_per_epoch
        if epoch < t0:
            t_cur, t_i = epoch, t0
        elif t_mult > 1:
            # restart index n = floor(log_tmult(epoch / t0 * (tmult - 1) + 1));
            # the epsilon keeps exact restart boundaries from rounding down
            n = math.floor(math.log(epoch / t0 * (t_mult - 1) + 1.0)
                           / math.log(t_mult) + 1e-6)
            pow_n = float(t_mult) ** n
            t_cur = epoch - t0 * (pow_n - 1.0) / (t_mult - 1)
            t_i = t0 * pow_n
        else:
            t_cur, t_i = math.fmod(epoch, t0), t0
        return eta_min + (base_lr - eta_min) * (
            1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0

    return schedule


def sine_warmup_restarts(base_lr: float, t0: int, t_mult: int = 1,
                         eta_min: float = 0.0, steps_per_epoch: int = 1):
    """Warmup variant: the phase-shifted cosine, rising from eta_min to
    base_lr."""
    cos = cosine_warm_restarts(base_lr, t0, t_mult, eta_min, steps_per_epoch)

    def schedule(step):
        return eta_min + (base_lr - eta_min) - (cos(step) - eta_min)

    return schedule


def entropy_decay(initial: float, decay: float):
    """Per-step decayed entropy-regulariser coefficient."""

    def coefficient(step):
        return initial * (decay ** step)

    return coefficient
