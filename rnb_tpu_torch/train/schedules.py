"""Training schedules, the reference runner's formulas.

  * learning rate: linear warm-up to ``warm_up_end``, then cosine decay to
    an ``alpha`` floor: ``lf = (cos(pi*progress)+1)/2*(1-alpha)+alpha``.
    Stateless in the update count.
  * cos-anneal ratio: ``min(1, step/anneal_end)``; 1.0 when anneal_end == 0.
"""

from __future__ import annotations

import math


def make_lr_schedule(learning_rate: float, warm_up_end: float,
                     end_iter: int, alpha: float):
    """fn(count) -> lr for a Python int update count."""
    def schedule(count: int) -> float:
        count = float(count)
        if count < warm_up_end:
            return learning_rate * (count / warm_up_end)
        progress = (count - warm_up_end) / max(end_iter - warm_up_end, 1e-8)
        return learning_rate * ((math.cos(math.pi * progress) + 1.0) * 0.5
                                * (1 - alpha) + alpha)
    return schedule


def cos_anneal_ratio(step: int, anneal_end: float) -> float:
    if anneal_end == 0.0:
        return 1.0
    return min(1.0, float(step) / anneal_end)
