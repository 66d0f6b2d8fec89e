"""The port's one device choice (counterpart of panmap_tpu/utils/devinit.py).

The main path runs on a CUDA device and fails loudly without one: there is
no silent CPU path.  CPU tensors reach the device-bound functions only when a
caller passes them on purpose (the parity tests), and every kernel wrapper
then runs its plain PyTorch version.  No watchdog, warm-up thread or compile
cache: those existed only for a remote TPU link.
"""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device the main path runs on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "panmap_tpu_torch needs a CUDA device (torch.cuda.is_available() "
            "is False); the JAX package panmap_tpu runs on CPU or TPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {index} requested, "
                           f"{torch.cuda.device_count()} present")
    return torch.device("cuda", index)


def as_device(device) -> torch.device:
    """Normalize a device argument; None means the main path's CUDA device
    (in a process group the rank's card, parallel/dist.py)."""
    if device is None:
        from ..parallel.dist import rank_card_index

        return cuda_device(rank_card_index())
    device = torch.device(device)
    if device.type == "cuda":
        return cuda_device(device.index or 0)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
