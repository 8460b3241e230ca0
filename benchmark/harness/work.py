"""The work a layer has to do, counted from the shapes, for roofline
shares: whatever implements the layer, this is the least it must move.

Emission (packed ingest): every lane of every [batch, length] batch reads
its share of the packed input once, 2 bits of code and 1 validity bit a
base (0.375 B), and writes its key once: 8 B at k <= 31 (one 64-bit
word), 16 B at 33 <= k <= 63 (128 bits).  PERF.md's table of kernels
uses the same bytes for K1 (``window.cu``).
"""

from __future__ import annotations

from typing import Optional

PACKED_IN_BYTES = 0.375


def emission_bytes_per_lane(k: int) -> Optional[float]:
    if 1 <= k <= 31:
        return PACKED_IN_BYTES + 8
    if 33 <= k <= 63:
        return PACKED_IN_BYTES + 16
    return None


def emission_bytes(batches: float, batch: int, length: int,
                   k: int) -> Optional[float]:
    per_lane = emission_bytes_per_lane(k)
    return None if per_lane is None else batches * batch * length * per_lane
