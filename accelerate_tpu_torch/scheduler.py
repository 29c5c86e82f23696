"""Learning-rate schedule bookkeeping — the counterpart of
``accelerate_tpu/scheduler.py``.

``AcceleratedScheduler`` wraps a schedule (a callable of the step count, as
``optim.linear_schedule`` returns) and the prepared optimizers. ``step()``
counts only on accumulation boundaries (``sync_gradients``) and not after a
skipped optimizer step, advances one step per global step (each rank's
loader yields its shard of a global batch, so one optimizer step is one
global step on every rank), reads the schedule's value on the host (one read
a step, as the JAX package's ``float(schedule(step))``; the schedule runs on
the CPU for a Python int, so nothing waits on the card) and writes it into
each optimizer's ``inject_hyperparams`` state. A chain whose schedule is
baked into the transform (``adamw(schedule)``) keeps its own count, and the
wrapper then only tracks ``get_last_lr``.
"""

from __future__ import annotations

from .state import GradientState


class AcceleratedScheduler:
    def __init__(self, schedule, optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False, gradient_state: GradientState | None = None):
        if not callable(schedule):
            raise TypeError(f"expected a schedule callable (int -> float), got {type(schedule)}")
        self.schedule = schedule
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.step_with_optimizer = step_with_optimizer
        # Kept for the API: every step is already a global step (module docstring).
        self.split_batches = split_batches
        self.step_count = 0
        self._last_lr = float(schedule(0))
        self.gradient_state = gradient_state if gradient_state is not None else GradientState()

    def step(self, *args, **kwargs):
        if not self.step_with_optimizer:
            self._advance(1)
            return
        if not self.gradient_state.sync_gradients:
            return  # accumulating
        if any(opt.step_was_skipped for opt in self.optimizers):
            return
        self._advance(1)

    def _advance(self, increment: int):
        self.step_count += increment
        self._last_lr = float(self.schedule(self.step_count))
        for opt in self.optimizers:
            opt.set_learning_rate(self._last_lr)

    def get_last_lr(self):
        return [self._last_lr]

    def state_dict(self):
        return {"step_count": self.step_count, "last_lr": self._last_lr}

    def load_state_dict(self, state_dict):
        self.step_count = state_dict["step_count"]
        self._last_lr = state_dict["last_lr"]
        for opt in self.optimizers:
            opt.set_learning_rate(self._last_lr)
