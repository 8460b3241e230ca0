"""The card's published peaks and its power limit.

The HBM table is the program's ``kmers_tpu_torch/profiling.py``
``HBM_GBPS``, copied: NVIDIA's data sheet figures by a substring of
``torch.cuda.get_device_name``.  A card that is not in the table has no
peak, and a roofline share of it is not reported.
"""

from __future__ import annotations

import subprocess
from typing import Optional

#: NVIDIA's published peak HBM bandwidth (GB/s): H100 SXM5 80 GB HBM3,
#: PCIe 80 GB HBM2e, NVL 94 GB HBM3
HBM_GBPS = {"H100 80GB HBM3": 3350.0, "H100 PCIe": 2000.0,
            "H100 NVL": 3900.0}


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    for key, gbps in HBM_GBPS.items():
        if key in kind:
            return gbps * 1e9
    return None


def power_limits() -> list:
    """nvidia-smi's power limit of each card, in W (empty where it does not
    run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    limits = []
    for line in out.stdout.splitlines():
        try:
            limits.append(float(line.strip()))
        except ValueError:
            pass
    return limits
