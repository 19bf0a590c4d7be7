"""Bucket rounding: the device facade pads every batch up to a
power-of-two multiple of a minimum, so a handful of shapes serve every
batch size (the same model as ``eges_tpu.crypto.bucketing``)."""

from __future__ import annotations


def bucket_round(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two-times-``minimum`` bucket holding ``n`` rows
    (``n <= 0`` maps to the minimum bucket): 1..16 -> 16, 17 -> 32,
    129 -> 256 at the default floor."""
    b = minimum
    while b < n:
        b *= 2
    return b
