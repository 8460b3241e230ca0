"""The published peak of the link between two cards, one direction, for
the share of an exchange's time that its bytes need.

NVIDIA's data sheet: the H100 SXM5 (torch names it "H100 80GB HBM3")
has NVLink 4 at 900 GB/s bidirectional, 450 GB/s a direction, which is
all that one card can take in from its peers.  A card that is not in the
table has no peak, and the share is not reported.
"""

from __future__ import annotations

from typing import Optional

#: one direction of a card's NVLink, GB/s, by a substring of
#: torch.cuda.get_device_name
LINK_GBPS = {"H100 80GB HBM3": 450.0}


def card_name(run) -> Optional[str]:
    """The name of the run's first card (None off the card)."""
    if not run.ctx.cuda_devices():
        return None
    import torch

    return torch.cuda.get_device_name(run.ctx.cuda_devices()[0])


def link_bytes_per_s(kind: Optional[str]) -> Optional[float]:
    for key, gbps in LINK_GBPS.items():
        if kind and key in kind:
            return gbps * 1e9
    return None
