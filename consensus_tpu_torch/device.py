"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names a device.

    The port never falls back to the CPU on its own: with no card and no
    explicit CPU request this raises, so a run that meant to use the card
    cannot quietly measure or verify on the host instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "consensus_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain torch path on the host"
        )
    return dev


__all__ = ["DeviceLike", "resolve_device"]
