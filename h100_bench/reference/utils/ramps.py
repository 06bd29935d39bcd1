"""Consistency-weight ramp schedules (port of chap_tpu/utils/ramps.py;
used at train_ours_2D.py:34-36 with epoch = iter_num // 150). Plain Python
floats: the step count lives on the host."""
from __future__ import annotations

import math


def sigmoid_rampup(current, rampup_length):
    """Exponential sigmoid ramp from Laine & Aila (exp(-5(1-t)^2))."""
    if rampup_length == 0:
        return 1.0
    phase = 1.0 - min(max(current / rampup_length, 0.0), 1.0)
    return math.exp(-5.0 * phase * phase)


