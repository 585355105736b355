"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device. The entry points take "cuda" (their
    default: the CUDA kernels) or "cpu" (the kernels' PyTorch twins). Raises
    RuntimeError for "cuda" on a machine without a CUDA device (there is no
    fallback to the CPU) and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
