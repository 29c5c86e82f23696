"""The port's own copy of the optax pieces the JAX package trains with.

``sgd`` (with or without classic momentum), ``adam``, ``adamw`` and
``apply_updates``, with optax's defaults, chain structure and op order, so
the same gradients give the same updates:

- ``scale_by_adam``: ``(1-b)·g + b·m`` moments, bias correction
  ``1 - b**count`` taken in f32 on the device, ``m̂/(sqrt(v̂+eps_root)+eps)``;
- ``add_decayed_weights``: ``u + wd·p`` (adamw's default wd is 1e-4);
- ``scale``: ``step_size·u``, with ``step_size = -learning_rate``;
- ``apply_updates``: ``(p + u)`` cast back to the parameter's dtype.

``torch.optim.AdamW`` is not used: it decays the weights before the moment
step and folds the learning rate in elsewhere, so its numbers differ.

Each constructor returns a :class:`GradientTransformation` whose
``transforms`` the fused update reads (``ops/fused_update.plan_fused_update``),
so no closure introspection is needed. Like every entry point of the port it
keeps its state on the card unless the caller passes ``device="cpu"``, and
raises without a GPU. Hyperparameters are Python floats;
applied to f32 tensors they round to f32 exactly as XLA rounds the JAX
package's weak-typed Python floats.

Learning-rate schedules, as optax computes them (f32, optax's op order):
``constant_schedule``, ``polynomial_schedule``, ``linear_schedule`` and
``cosine_decay_schedule``. A schedule takes a step count (a Python int, or an
int tensor on any device) and returns an f32 0-d tensor on the count's device
(the constant schedule returns its value). A callable ``learning_rate`` makes
the chain end in ``scale_by_schedule`` with its own count, as optax's
``scale_by_learning_rate`` does. :func:`inject_hyperparams` keeps every
numeric hyperparameter as an f32 0-d tensor in the transform's state
(``InjectHyperparamsState.hyperparams``) and rebuilds the inner chain from
the current values at each update, as optax does; a learning rate written
into that state (``AcceleratedOptimizer.set_learning_rate``) takes effect at
the next update. Nesterov and the other optax transforms are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
import inspect
import math
from typing import Callable, NamedTuple

import torch

from .utils.device import resolve_device
from .utils.tree import tree_map

_MAX_INT32 = 2**31 - 1


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far


class InjectHyperparamsState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    hyperparams: dict  # name -> f32 0-d tensor on the transform's device
    inner_state: tuple


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: dict
    nu: dict


class TraceState(NamedTuple):
    trace: dict


class EmptyState(NamedTuple):
    pass


def safe_int32_increment(count):
    """``count + 1``, saturating at the int32 maximum (optax's increment)."""
    return torch.where(count < _MAX_INT32, count + 1, torch.full_like(count, _MAX_INT32))


def _zeros(params, device):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=device), params)


@dataclass(frozen=True)
class Identity:
    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        return updates, state


@dataclass(frozen=True)
class ScaleByAdam:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params, device):
        count = torch.zeros((), dtype=torch.int32, device=device)
        return ScaleByAdamState(count=count, mu=_zeros(params, device), nu=_zeros(params, device))

    def bias_corrections(self, count):
        """``(1 - b1**count, 1 - b2**count)`` as f32 device scalars."""
        c = count.to(torch.float32)
        b1 = torch.as_tensor(self.b1, dtype=torch.float32, device=count.device)
        b2 = torch.as_tensor(self.b2, dtype=torch.float32, device=count.device)
        return 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)

    def update(self, updates, state, params=None):
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates, state.nu)
        count = safe_int32_increment(state.count)
        bc1, bc2 = self.bias_corrections(count)
        mu_hat = tree_map(lambda t: t / bc1, mu)
        nu_hat = tree_map(lambda t: t / bc2, nu)
        out = tree_map(lambda m, v: m / (torch.sqrt(v + self.eps_root) + self.eps), mu_hat, nu_hat)
        return out, ScaleByAdamState(count=count, mu=mu, nu=nu)


@dataclass(frozen=True)
class Trace:
    decay: float

    def init(self, params, device):
        return TraceState(trace=_zeros(params, device))

    def update(self, updates, state, params=None):
        trace = tree_map(lambda g, t: g + self.decay * t, updates, state.trace)
        return trace, TraceState(trace=trace)


@dataclass(frozen=True)
class AddDecayedWeights:
    weight_decay: float

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return tree_map(lambda g, p: g + self.weight_decay * p, updates, params), state


@dataclass(frozen=True)
class Scale:
    step_size: float  # or an f32 0-d tensor (a learning rate under inject_hyperparams)

    def init(self, params, device):
        return EmptyState()

    def update(self, updates, state, params=None):
        return tree_map(lambda g: self.step_size * g, updates), state


@dataclass(frozen=True)
class ScaleBySchedule:
    """``step_size_fn(count) · u``, the count advancing once an update
    (optax's ``scale_by_schedule``)."""

    step_size_fn: Callable

    def init(self, params, device):
        return ScaleByScheduleState(count=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, updates, state, params=None):
        step_size = self.step_size_fn(state.count)

        def one(g):
            return torch.as_tensor(step_size, dtype=g.dtype, device=g.device) * g

        return tree_map(one, updates), ScaleByScheduleState(
            count=safe_int32_increment(state.count))


class GradientTransformation:
    """A chain of transforms, as ``optax.chain`` builds one: ``init`` gives
    one state per transform (a tuple) on ``device``, ``update`` runs them in
    order."""

    def __init__(self, *transforms, device=None):
        self.transforms = tuple(transforms)
        self.device = resolve_device(device)

    def init(self, params):
        return tuple(t.init(params, self.device) for t in self.transforms)

    def update(self, updates, state, params=None):
        new_state = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)


def chain(*transforms, device=None) -> GradientTransformation:
    return GradientTransformation(*transforms, device=device)


def _scale_by_learning_rate(learning_rate):
    """optax's ``scale_by_learning_rate``: ``-learning_rate`` as a constant
    step, or a schedule of it."""
    if callable(learning_rate):
        return ScaleBySchedule(lambda count: -1 * learning_rate(count))
    if isinstance(learning_rate, torch.Tensor):
        return Scale(-1 * learning_rate)
    return Scale(-1 * float(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), _scale_by_learning_rate(learning_rate),
                 device=device)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4,
          device=None) -> GradientTransformation:
    return chain(ScaleByAdam(b1, b2, eps, eps_root), AddDecayedWeights(weight_decay),
                 _scale_by_learning_rate(learning_rate), device=device)


def sgd(learning_rate, momentum=None, device=None) -> GradientTransformation:
    first = Trace(momentum) if momentum is not None else Identity()
    return chain(first, _scale_by_learning_rate(learning_rate), device=device)


def apply_updates(params, updates):
    """``(p + u)`` cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ----------------------------------------------------------------- schedules
def _count_tensor(count):
    return count if isinstance(count, torch.Tensor) else torch.tensor(int(count))


def constant_schedule(value):
    """``value`` at every step."""
    return lambda count: value


def polynomial_schedule(init_value, end_value, power, transition_steps: int,
                        transition_begin: int = 0):
    """optax's ``polynomial_schedule``: ``(init - end)·(1 - t/T)**power +
    end`` with ``t`` clipped to ``[0, T]`` after ``transition_begin``;
    ``init_value`` throughout when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = torch.clamp(_count_tensor(count) - transition_begin, 0, transition_steps)
        steps = torch.tensor(float(transition_steps), dtype=torch.float32, device=count.device)
        frac = 1 - count.to(torch.float32) / steps
        return (init_value - end_value) * (frac ** power) + end_value

    return schedule


def linear_schedule(init_value, end_value, transition_steps: int, transition_begin: int = 0):
    """optax's ``linear_schedule``: :func:`polynomial_schedule` of power 1."""
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0):
    """optax's ``cosine_decay_schedule``: ``init·((1 - alpha)·(0.5·(1 +
    cos(pi·t/T)))**exponent + alpha)`` with ``t`` capped at ``T``."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        count = _count_tensor(count).to(torch.float32)
        steps = torch.tensor(float(decay_steps), dtype=torch.float32, device=count.device)
        count = torch.minimum(count, steps)
        pi = torch.tensor(math.pi, dtype=torch.float32, device=count.device)
        # cos in f64, rounded once: closer to XLA's f32 cos than torch's.
        cosine_decay = 0.5 * (1 + torch.cos((pi * count / steps).double()).float())
        decayed = (1 - alpha) * cosine_decay ** exponent + alpha
        return init_value * decayed

    return schedule


# ----------------------------------------------------------- inject_hyperparams
class InjectHyperparams(GradientTransformation):
    """optax's ``inject_hyperparams(factory)(**hyperparams)``: every numeric
    argument of ``factory`` (defaults included, booleans excluded) is kept
    as an f32 0-d tensor in the state, a callable one is a schedule of the
    update count, and each update builds ``factory(**current values)`` and
    runs it on the inner state. The fused update does not cover it
    (``plan_fused_update`` returns None): the inner chain runs."""

    def __init__(self, factory, static_args=(), arguments=None, device=None):
        super().__init__(device=device)
        self.factory = factory
        self.numeric, self.scheduled, self.other = {}, {}, {}
        for name, value in arguments.items():
            if name == "device":
                continue
            if name in static_args or isinstance(value, bool):
                self.other[name] = value
            elif callable(value):
                self.scheduled[name] = value
            elif isinstance(value, (int, float, torch.Tensor)):
                self.numeric[name] = value
            else:
                self.other[name] = value

    def _hyperparam(self, value):
        return torch.as_tensor(value, dtype=torch.float32, device=self.device) if (
            isinstance(value, float) or (isinstance(value, torch.Tensor)
                                         and value.is_floating_point())) else value

    def _inner(self, hyperparams):
        return self.factory(**self.other, **hyperparams, device=self.device)

    def init(self, params):
        count = torch.zeros((), dtype=torch.int32, device=self.device)
        hyperparams = {k: self._hyperparam(v) for k, v in self.numeric.items()}
        hyperparams.update({k: self._hyperparam(f(count)) for k, f in self.scheduled.items()})
        return InjectHyperparamsState(count=count, hyperparams=hyperparams,
                                      inner_state=self._inner(hyperparams).init(params))

    def update(self, updates, state, params=None):
        hyperparams = dict(state.hyperparams)
        hyperparams.update({k: self._hyperparam(f(state.count))
                            for k, f in self.scheduled.items()})
        updates, inner_state = self._inner(hyperparams).update(updates, state.inner_state,
                                                               params)
        return updates, InjectHyperparamsState(count=safe_int32_increment(state.count),
                                               hyperparams=hyperparams, inner_state=inner_state)


def inject_hyperparams(factory, static_args=()):
    """``inject_hyperparams(adamw)(learning_rate=2e-5, device=...)``: see
    :class:`InjectHyperparams`."""
    static_args = {static_args} if isinstance(static_args, str) else set(static_args)
    signature = inspect.signature(factory)

    def wrapped(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = dict(bound.arguments)
        return InjectHyperparams(factory, static_args, arguments, device=arguments.get("device"))

    return wrapped
