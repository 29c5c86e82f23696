"""Seeding — the counterpart of ``accelerate_tpu/utils/random.py:set_seed``.

The JAX package returns a ``jax.random`` key; the port returns an explicit
``torch.Generator``, which callers pass to whatever draws random numbers
(``Llama.init``, data shuffles). The process-wide python, numpy and torch
generators are seeded too, for code that uses them implicitly.
:func:`synchronize_rng_states` hands rank 0's random streams to every rank at
the start of an epoch, so that the ranks of a job shuffle alike.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .dataclasses import RNGType
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


def synchronize_rng_state(rng_type: str, generator=None) -> None:
    """Give every rank rank 0's state of one random stream (JAX
    ``utils/random.py:43-79``): ``"torch"`` (torch's CPU generator),
    ``"cuda"`` (the current card's), ``"numpy"``, ``"python"``, or
    ``"generator"``: ``generator`` itself when it is a ``torch.Generator`` or
    a numpy ``Generator`` (anything else, such as a
    ``SeedableRandomSampler``, reseeds itself and is left alone)."""
    from .operations import broadcast_object_list

    rng_type = RNGType(rng_type)
    if rng_type is RNGType.TORCH:
        state = broadcast_object_list([torch.get_rng_state()])[0]
        torch.set_rng_state(state)
    elif rng_type is RNGType.CUDA:
        if torch.cuda.is_available():
            state = broadcast_object_list([torch.cuda.get_rng_state()])[0]
            torch.cuda.set_rng_state(state)
    elif rng_type is RNGType.NUMPY:
        np.random.set_state(broadcast_object_list([np.random.get_state()])[0])
    elif rng_type is RNGType.PYTHON:
        random.setstate(broadcast_object_list([random.getstate()])[0])
    elif isinstance(generator, torch.Generator):
        generator.set_state(broadcast_object_list([generator.get_state()])[0])
    elif isinstance(generator, np.random.Generator):
        generator.bit_generator.state = broadcast_object_list(
            [generator.bit_generator.state])[0]


def synchronize_rng_states(rng_types, generator=None) -> None:
    """:func:`synchronize_rng_state` for each of ``rng_types``, in order;
    ``DataLoaderShard`` calls it at the start of every epoch."""
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator=generator)
