"""Hand-written CUDA kernels of the port, one wrapper each.

Each wrapper checks its tensors, and then on a CUDA tensor launches its
kernel (or raises), and on a CPU tensor runs its plain PyTorch version
from the same module.  Each launch of a kernel adds one to its count, so
a run can show that the main path went through every kernel:

    kernels.reset_launch_counts(); <run>; kernels.launch_counts()
"""

from __future__ import annotations

import torch

KERNELS = ("pack_canonical_keys_packed", "pack_canonical_keys",
           "merge_sorted", "merge_sorted_idx", "compress_flagged",
           "pack_canonical_hash",
           "merge_sorted_wide", "pack_canonical_keys_wide",
           "pack_canonical_hash_wide", "minimizer_kernel",
           "segment_count_keys", "segment_count_keys_wide", "radix_sort_u64",
           "search_counts",
           # the stage variants, each counted under its own name
           "pack_canonical_keys_packed[pack]", "pack_canonical_keys[pack]",
           "minimizer_kernel[hash]")

_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def count_launch(name: str) -> None:
    _launches[name] += 1


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (the plain version); raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def check_stage(stage: str, stages: tuple, name: str) -> None:
    if stage not in stages:
        raise ValueError(f"{name}: stage must be one of {stages}, got "
                         f"{stage!r}")


def variant(name: str, stage: str, default: str) -> str:
    """The launch-count name of a kernel's stage: the kernel's own at its
    default stage, else "name[stage]"."""
    return name if stage == default else f"{name}[{stage}]"


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
