"""Out-of-memory helpers — the counterpart of ``accelerate_tpu/utils/memory.py``.

``find_executable_batch_size`` retries a function with its batch size halved
each time it runs out of memory: on the card that is ``torch.OutOfMemoryError``
(CUDA's out-of-memory error); the JAX package's string matches (its XLA
``RESOURCE_EXHAUSTED`` and allocation messages) and ``MemoryError`` count as
well, for parity. ``clear_device_cache`` returns the caching allocator's free
blocks to the card (``torch.cuda.empty_cache``), ``release_memory`` drops
references and then clears it.
"""

from __future__ import annotations

import functools
import gc
import inspect

import torch

_OOM_MESSAGES = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "Attempting to allocate",
                 "Failed to allocate")


def clear_device_cache(garbage_collection: bool = False) -> None:
    """Optionally collect garbage, then give the caching allocator's free
    blocks back to the card (nothing without one)."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references and clear the cache; returns Nones in their
    places (``a, b = release_memory(a, b)``)."""
    objects = [None] * len(objects)
    clear_device_cache(garbage_collection=True)
    return objects


def is_oom_exception(exception: BaseException) -> bool:
    """Whether ``exception`` is an out-of-memory error worth a retry with a
    smaller batch."""
    if isinstance(exception, (torch.OutOfMemoryError, MemoryError)):
        return True
    return isinstance(exception, Exception) and any(s in str(exception) for s in _OOM_MESSAGES)


def find_executable_batch_size(function=None, starting_batch_size: int = 128):
    """Decorator: calls ``function(batch_size, ...)`` from
    ``starting_batch_size``, halving it after each out-of-memory error, and
    raises once it reaches zero. ``function`` must take ``batch_size`` first
    and the caller must not pass it."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        batch_size = starting_batch_size
        clear_device_cache(garbage_collection=True)
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < (1 + len(args)) or params[0] != "batch_size":
            arg_str = ", ".join(f"{arg}={value}" for arg, value in zip(params[1:], args[1:]))
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument "
                f"when called.\nRemove this as the decorator already does so: "
                f"`{function.__name__}({arg_str})`")
        while True:
            if batch_size == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size, *args, **kwargs)
            except Exception as e:
                if not is_oom_exception(e):
                    raise
                clear_device_cache(garbage_collection=True)
                batch_size //= 2

    return wrapper
