"""Loss primitives — the counterpart of ``accelerate_tpu/ops/losses.py:15-40``.

Cross-entropy is computed from logits in fp32 whatever the compute dtype
(bf16 logits lose too much precision in the logsumexp), with an ignore index
for padded positions and the mean taken over valid positions only. The fused
(vocab-chunked) loss is a later slice and raises in ``models/llama.py``.
"""

from __future__ import annotations

import torch


def cross_entropy_loss(logits, labels, ignore_index: int = -100, z_loss: float = 0.0,
                       label_smoothing: float = 0.0):
    """Mean token cross-entropy over non-ignored positions.

    logits: (..., V) float; labels: (...) int. Ignored positions contribute
    zero and are excluded from the mean's denominator."""
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    nll = logz - label_logits
    if label_smoothing > 0.0:
        smooth = -torch.log_softmax(logits, dim=-1).mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    denom = valid.sum().clamp(min=1)
    return nll.sum() / denom
