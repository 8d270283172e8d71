"""Sub-seeds: every random stream of a run (weights, voices, traffic,
sampling noise, the check's sample) comes from the run's --seed and a
name, so that the same seed gives the same inputs and adding a stream
moves no other."""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed from `seed` (any whole number) and `keys`."""
    words = [int(seed) % (1 << 64) & 0xFFFFFFFF, (int(seed) % (1 << 64)) >> 32]
    words += [zlib.crc32(str(k).encode()) for k in keys]
    lo, hi = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(lo) | int(hi) << 32) >> 1


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))
