"""Independent streams drawn from one ``--seed``.

Each use of the seed (weights, histories, arrivals, the sample that is
checked) takes its own stream, so that one does not shift another: the
weights of a seed are the same whatever traffic runs on them.
"""
from __future__ import annotations

import numpy as np

WEIGHTS, HISTORIES, ARRIVALS, SAMPLE, WARM = range(5)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for the stream ``tags`` of ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *tags])
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return (hi << 32 | lo) & (2 ** 63 - 1)


def numpy_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))
