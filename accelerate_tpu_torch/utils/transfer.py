"""Batch placement — the port's counterpart of the JAX package's
``Accelerator._place_batch`` (``accelerator.py:693``) and the host-to-device
side of ``utils/transfer.py``.

A training step's batch arrives as numpy arrays (or CPU tensors). Each leaf
goes to the step's device through :func:`.device.host_to_device`: pinned
memory and a non-blocking copy, so the host never waits for the work already
queued on the card. Leaves already on the device pass through untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import host_to_device


def place_batch(batch, device):
    """Every numpy or CPU-tensor leaf of ``batch`` (a dict, nested or not)
    on ``device``; other leaves unchanged."""
    device = torch.device(device)
    if isinstance(batch, dict):
        return {k: place_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return host_to_device(batch, device)
    if isinstance(batch, torch.Tensor) and batch.device != device:
        if device.type == "cuda" and batch.device.type == "cpu":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    return batch
