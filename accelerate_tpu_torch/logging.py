"""Multi-process-aware logging — the counterpart of ``accelerate_tpu/logging.py``.

:func:`get_logger` wraps a standard ``logging.Logger`` in a
:class:`MultiProcessAdapter`: a record is emitted on the main process only
unless the call passes ``main_process_only=False``; ``in_order=True`` has
every rank walk the same sequence of barriers and emit on its own turn, in
rank order; ``log_every_n`` rate-limits a call site; ``warning_once``
deduplicates. The rank comes from ``state.ProcessView`` (the process group,
or the launcher's environment), so logging never touches a device.
"""

from __future__ import annotations

import functools
import logging
import os
import sys

from . import state

# Per-call-site counts behind ``log_every_n``, shared by every adapter.
_EVERY_N_COUNTS: dict = {}


def _process():
    return state.ProcessView()


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logs only on the main process unless ``main_process_only=False``;
    with ``in_order=True`` each process logs in rank order behind a
    barrier."""

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        return not main_process_only or _process().is_main_process

    def log(self, level, msg, *args, **kwargs):
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        if in_order:
            # Every process walks the same barriers; the filters (rank and
            # this host's logger level) only decide who emits inside them.
            proc = _process()
            for i in range(proc.num_processes):
                if (i == proc.process_index and self.isEnabledFor(level)
                        and self._should_log(main_process_only)):
                    msg, kwargs = self.process(msg, kwargs)
                    self.logger.log(level, msg, *args, **kwargs)
                proc.wait_for_everyone()
        elif self.isEnabledFor(level) and self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    def log_every_n(self, n: int, level, msg, *args, **kwargs):
        """``log`` for the first call of a call site (the caller's file and
        line, across adapters) and every ``n``-th after it; an emitted record
        after suppressed ones says how many calls it stands for."""
        if n <= 0:
            raise ValueError(f"log_every_n needs n >= 1, got {n}")
        frame = sys._getframe(1)
        key = (frame.f_code.co_filename, frame.f_lineno)
        count = _EVERY_N_COUNTS.get(key, 0)
        _EVERY_N_COUNTS[key] = count + 1
        if count % n == 0:
            if count and n > 1:
                msg = f"{msg} [1/{n} of {count + 1} occurrences logged]"
            self.log(level, msg, *args, **kwargs)

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A :class:`MultiProcessAdapter` over ``logging.getLogger(name)``; the
    level is ``log_level``, else ``ACCELERATE_LOG_LEVEL`` when set (the JAX
    package's variable), and then also the root logger's."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
