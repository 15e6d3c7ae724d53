"""uint32 arithmetic that wraps, held in int64 under a 32-bit mask.

The reference package draws its pseudo-random choices (landmark shuffles,
RANSAC hypotheses) from uint32 hashes whose products wrap around; the port
reproduces them bit for bit on int64 tensors with values in [0, 2^32).
"""

from __future__ import annotations

MASK = 0xFFFFFFFF


def mul(x, c: int):
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64: the constant is
    split into 16-bit halves so that no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK
