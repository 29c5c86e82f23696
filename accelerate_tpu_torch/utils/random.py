"""Seeding — the counterpart of ``accelerate_tpu/utils/random.py:set_seed``.

The JAX package returns a ``jax.random`` key; the port returns an explicit
``torch.Generator``, which callers pass to whatever draws random numbers
(``Llama.init``, data shuffles). The process-wide python, numpy and torch
generators are seeded too, for code that uses them implicitly.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .device import resolve_device


def set_seed(seed: int, device=None) -> torch.Generator:
    """Seed python, numpy and torch (every device) with ``seed`` and return
    a ``torch.Generator`` on ``device`` (the card unless ``device="cpu"``)
    seeded with it."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return generator
