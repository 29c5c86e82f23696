"""Environment parsing and patching — the counterpart of
``accelerate_tpu/utils/environment.py:19-184``.

``str_to_bool``, ``parse_flag_from_env``, ``parse_choice_from_env``,
``get_int_from_env``, ``patch_environment``, ``clear_environment`` and
``purge_accelerate_environment``, as in the JAX package. Its other three
helpers are XLA's and have no counterpart: ``pin_cpu_platform`` pins JAX's
platform and virtual host devices (the port's CPU runs are
``device="cpu"``, and no environment variable switches a backend),
``maybe_enable_compilation_cache`` points XLA's persistent compilation
cache (eager PyTorch compiles nothing; the kernels build once per checkout,
``ops/kernels/_build.py``), and ``safe_donate_argnums`` gates XLA's buffer
donation (the port updates its buffers in place).
"""

from __future__ import annotations

import functools
import os
from contextlib import contextmanager

from .constants import ENV_PREFIX


def str_to_bool(value: str) -> int:
    """A string (an environment variable) as 1 or 0: y/yes/t/true/on/1 and
    n/no/f/false/off/0."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key, str(default))
    try:
        return bool(str_to_bool(value))
    except ValueError:
        raise ValueError(f"If set, {key} must be yes/no/1/0/true/false, got {value!r}.") from None


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def get_int_from_env(env_keys, default: int) -> int:
    """The first non-negative int among ``env_keys``, else ``default``."""
    for key in env_keys:
        val = int(os.environ.get(key, -1))
        if val >= 0:
            return val
    return default


@contextmanager
def patch_environment(**kwargs):
    """Set environment variables (names upper-cased) for the block and
    restore the previous values after it."""
    existing = {}
    for key, value in kwargs.items():
        key = key.upper()
        if key in os.environ:
            existing[key] = os.environ[key]
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key in kwargs:
            key = key.upper()
            if key in existing:
                os.environ[key] = existing[key]
            else:
                os.environ.pop(key, None)


@contextmanager
def clear_environment():
    """An empty ``os.environ`` for the block, restored after it."""
    saved = dict(os.environ)
    os.environ.clear()
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def purge_accelerate_environment(fn):
    """Run ``fn`` with every ``ACCELERATE_*`` variable removed, and restore
    them afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        saved = {k: v for k, v in os.environ.items() if k.startswith(ENV_PREFIX)}
        for k in saved:
            del os.environ[k]
        try:
            return fn(*args, **kwargs)
        finally:
            for k in list(os.environ):
                if k.startswith(ENV_PREFIX):
                    del os.environ[k]
            os.environ.update(saved)

    return wrapper
