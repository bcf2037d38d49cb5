"""Small utilities: timing, bucketing, dtype helpers.

Reference analogs: adelie/src/include/adelie_core/util/stopwatch.hpp (Stopwatch)
and the capacity heuristics that replace dynamic std::vector growth
(static-shape XLA requires fixed-capacity buffers).
"""

import time

import numpy as np

from . import types


class Stopwatch:
    """Wall-clock timer (reference: util/stopwatch.hpp)."""

    def __init__(self):
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


def bucket(n: int, minimum: int = 64) -> int:
    """Round ``n`` up to a capacity bucket (min bucket, then powers of two).

    Bounds the number of distinct compiled shapes for screen-set buffers:
    dynamic screen/active sets (reference solver_base.hpp:274-403) become
    fixed-capacity masked buffers whose capacity only ever takes
    O(log(p)) distinct values.
    """
    n = max(int(n), 1)
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Round up to a power of two (used for max-group-size buckets)."""
    n = max(int(n), 1)
    cap = max(minimum, 1)
    while cap < n:
        cap *= 2
    return cap


def solver_eps(dtype) -> float:
    """Smallest safe denominator guard for a dtype."""
    return float(np.finfo(np.dtype(dtype)).tiny) * 1e8


def large_lmda(dtype) -> float:
    """A finite 'lambda ~ infinity' used for the lmda_max dry fit.

    The reference uses 1e-3 * numeric_limits<double>::max() / max_penalty
    (solver_base.hpp:500-515).  The surrogate must be f32-range-safe
    (values above ~3.4e38 overflow) in every dtype; 1e30 exceeds any realistic lambda_max by >20 orders of
    magnitude, which is all the dry fit needs (SURVEY.md section 7
    'Numerics').
    """
    return 1e30
