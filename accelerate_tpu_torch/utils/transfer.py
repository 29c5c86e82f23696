"""Batch placement — the port's counterpart of the JAX package's
``Accelerator._place_batch`` (``accelerator.py:693``) and the host-to-device
side of ``utils/transfer.py``.

A training step's batch arrives as numpy arrays (or CPU tensors). Each leaf
goes to the step's device through :func:`.device.host_to_device`: pinned
memory and a non-blocking copy, so the host never waits for the work already
queued on the card. Leaves already on the device pass through untouched.
Under a dp x sp mesh, :func:`shard_batch` cuts each rank's shard out of the
global batch first.
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


def shard_batch(batch, device, *, dp_index: int, dp_size: int, sp_index: int, sp_size: int,
                shift_labels):
    """This rank's shard of a GLOBAL batch (``input_ids`` (B, S), optional
    ``labels`` and ``attention_mask`` of the same shape) under a dp x sp
    mesh: rows ``[i·B/dp, (i+1)·B/dp)`` of its dp slice and tokens
    ``[r·S/sp, (r+1)·S/sp)`` of its sp shard, on ``device``. Adds
    ``positions``, the tokens' GLOBAL positions (rope), and turns ``labels``
    into ``targets``: shifted by ``shift_labels(labels, attention_mask)`` on
    the global sequence and then sharded, so a shard's last token targets
    the next shard's first (the JAX package's ``_shift_labels`` on the
    global array)."""
    unknown = set(batch) - {"input_ids", "labels", "attention_mask"}
    if unknown:
        raise ValueError(f"a sharded batch takes input_ids, labels and attention_mask; "
                         f"got also {sorted(unknown)}")
    host = {k: v.cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()}
    B, S = host["input_ids"].shape
    if B % dp_size or S % sp_size:
        raise ValueError(f"a ({B}, {S}) batch does not split into dp={dp_size} x sp={sp_size} "
                         "equal shards")
    rows = slice(dp_index * B // dp_size, (dp_index + 1) * B // dp_size)
    cols = slice(sp_index * S // sp_size, (sp_index + 1) * S // sp_size)
    mask = host.get("attention_mask")
    out = {"input_ids": host["input_ids"],
           "positions": torch.arange(S, dtype=torch.int32)[None].expand(B, S)}
    if "labels" in host:
        out["targets"] = shift_labels(host["labels"], mask)
    if mask is not None:
        out["attention_mask"] = mask
    return place_batch({k: v[rows, cols].contiguous() for k, v in out.items()}, device)
