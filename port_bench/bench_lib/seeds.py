"""Independent streams from one ``--seed``: weights, frames, keys, sample."""

from __future__ import annotations

import zlib

import numpy as np


def stream(seed: int, name: str) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % 2**64, zlib.crc32(name.encode())])


def torch_seed(seed: int, name: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` of the stream ``name``."""
    return int(stream(seed, name).generate_state(1, np.uint64)[0]) >> 1


def rng(seed: int, name: str) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(stream(seed, name)))
