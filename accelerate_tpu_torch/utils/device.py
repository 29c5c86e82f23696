"""Default-device resolution for the port's entry points.

Every entry point (``Llama``, ``generate``, ``ContinuousBatcher``,
``init_kv_pool``) runs on the card unless the caller asks for the CPU. Without
a GPU they raise instead of dropping to the CPU quietly: a run that was meant
to exercise the CUDA kernels must never finish on the plain versions by
accident. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a host without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "accelerate_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def host_to_device(array, device, dtype=None) -> torch.Tensor:
    """Copy a small host array (numpy or list) to ``device`` without waiting
    for the work already queued there: on a CUDA device the copy goes
    through pinned memory with ``non_blocking=True`` (a plain copy from
    pageable memory synchronizes the stream, which would stall the host loop
    on every dispatch). The source is copied first, so the caller may mutate
    it right away."""
    t = torch.tensor(np.asarray(array), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
