"""The one piece of the JAX package's `cabac/syntax.py` the slice needs on
the device side: the last-position prefix group, which `ops/estbits.py`
prices.  The slice's CABAC serializer is the native one (`native/`)."""

from __future__ import annotations


def last_prefix_group(pos: int) -> int:
    """groupIdx: last position -> prefix value (spec Table 9-48 area)."""
    if pos < 4:
        return pos
    k = pos.bit_length() - 1
    return 2 * k + ((pos >> (k - 1)) & 1)
